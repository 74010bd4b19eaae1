// K2: streamed temporal regression, out = (raw @ A - c)^T.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_v_projection (body
// _vproj_kernel, tile choice _vp_pick_tiles). raw is one (t, d) frame chunk
// in its native dtype (float32 or uint16) with C-order pixels, A the (d, r')
// folded projector, c the (r',) constant; out is (r', t) float32.
//
// What bounds it on the card: 2 * t * d * r' fp32 flops (1.6e11 at
// t = 1024, d = 512^2, r' = 300) over t * d raw values plus d * r' projector
// values; the products stay IEEE fp32 (the JAX package pins
// Precision.HIGHEST and Hopper's tensor cores have no fp32 mode), so the
// CUDA cores bound it. The second bound is accuracy: a sum over d = 262144
// products accumulated sequentially in fp32 drifts by ~eps * sqrt(d), so
// no CTA sums more than a 4096-pixel split (~eps * 64 relative).
//
// Design: a register-tiled SGEMM. Each CTA owns a 128 (t) x 128 (r')
// output tile; each of its 256 threads an 8 x 8 register tile. The k axis
// (pixels) streams through shared memory in 16-deep slabs, double-buffered:
// the next slab's global loads are in flight while the current one is
// multiplied, one barrier per slab. uint16 converts to f32 as it loads, so
// no f32 copy of the chunk exists. The output grid is tiled over r' as
// well, so any rank fits (the TPU version fell back to XLA when r'
// outgrew VMEM; this has no fallback). The d axis is split across CTAs
// (split-K) to fill the SMs and to bound each CTA's sum; two CTAs fit on
// an SM (<= 128 registers a thread). A second kernel adds the splits in a
// fixed order, subtracts c and stores the transpose. No atomics: results
// are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // t rows per CTA
constexpr int BN = 128;  // r' columns per CTA
constexpr int BK = 16;   // k slab
constexpr int THREADS = 256;

// four consecutive raw values along a row; vec_ok means all four are in
// range and 4-element aligned
__device__ __forceinline__ void load4(const float* p, bool vec_ok, int valid, float out[4]) {
  if (vec_ok) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = q < valid ? p[q] : 0.0f;
  }
}

__device__ __forceinline__ void load4(const uint16_t* p, bool vec_ok, int valid, float out[4]) {
  if (vec_ok) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = static_cast<float>(v.x & 0xffffu);
    out[1] = static_cast<float>(v.x >> 16);
    out[2] = static_cast<float>(v.y & 0xffffu);
    out[3] = static_cast<float>(v.y >> 16);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = q < valid ? static_cast<float>(p[q]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
vproj_partial_kernel(const T* __restrict__ raw, int t_len, int d,
                     const float* __restrict__ a, int r, int k_chunk,
                     float* __restrict__ ws) {
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid / 16;  // rows    ty*4 + {0..3} and 64 + ty*4 + {0..3}
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long k_begin = static_cast<long long>(blockIdx.z) * k_chunk;
  const long long k_end = k_begin + k_chunk < d ? k_begin + k_chunk : d;
  const int n_slabs = k_begin < k_end ? static_cast<int>((k_end - k_begin + BK - 1) / BK) : 0;

  // global-load mapping: raw slab = 128 rows x 16 k (8 per thread, along
  // k); projector slab = 16 k x 128 columns (8 per thread, along r')
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 8;
  const bool row_ok = m0 + a_row < t_len;
  // vector loads need 4-element-aligned rows and base pointers
  const bool d_vec = (d % 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(raw) % (4 * sizeof(T))) == 0;
  const bool r_vec = (r % 4) == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0;

  float pa[8], pb[8];
  auto load_slab = [&](long long k0) {
    const long long kr = k0 + b_k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = k0 + a_k + 4 * h;
      const long long left = k_end - col;
      const int a_valid = row_ok ? static_cast<int>(left < 4 ? (left > 0 ? left : 0) : 4) : 0;
      const T* pr = raw + static_cast<long long>(m0 + a_row) * d + col;
      load4(a_valid > 0 ? pr : raw, d_vec && a_valid == 4, a_valid, pa + 4 * h);
      const int nn = n0 + b_n + 4 * h;
      const int b_valid = kr < k_end ? (r - nn < 4 ? (r - nn > 0 ? r - nn : 0) : 4) : 0;
      const float* pp = a + (kr < k_end ? kr : 0) * r + nn;
      load4(b_valid > 0 ? pp : a, r_vec && b_valid == 4, b_valid, pb + 4 * h);
    }
  };
  auto store_slab = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q) as[buf][a_k + q][a_row] = pa[q];
    *reinterpret_cast<float4*>(&bs[buf][b_k][b_n]) = make_float4(pb[0], pb[1], pb[2], pb[3]);
    *reinterpret_cast<float4*>(&bs[buf][b_k][b_n + 4]) = make_float4(pb[4], pb[5], pb[6], pb[7]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (n_slabs > 0) {
    load_slab(k_begin);
    store_slab(0);
  }
  __syncthreads();
  for (int it = 0; it < n_slabs; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_slabs) load_slab(k_begin + static_cast<long long>(it + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // buf ^ 1 was last read before the previous barrier
    if (it + 1 < n_slabs) store_slab(buf ^ 1);
    __syncthreads();
  }

  float* dst = ws + static_cast<long long>(blockIdx.z) * t_len * r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < r) dst[static_cast<long long>(row) * r + col] = acc[i][j];
    }
  }
}

// out[j, i] = sum_s ws[s, i, j] - c[j], through a 32 x 32 shared tile so
// both the read (along r') and the write (along t) coalesce.
__global__ void vproj_reduce_kernel(const float* __restrict__ ws, int splits,
                                    int t_len, int r, const float* __restrict__ c,
                                    float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.y * 32;  // t
  const int j0 = blockIdx.x * 32;  // r'
  const long long plane = static_cast<long long>(t_len) * r;
  for (int q = threadIdx.y; q < 32; q += blockDim.y) {
    const int i = i0 + q;
    const int j = j0 + threadIdx.x;
    float sum = 0.0f;
    if (i < t_len && j < r) {
      const long long off = static_cast<long long>(i) * r + j;
      for (int s = 0; s < splits; ++s) sum += ws[s * plane + off];
    }
    tile[q][threadIdx.x] = sum;
  }
  __syncthreads();
  for (int q = threadIdx.y; q < 32; q += blockDim.y) {
    const int j = j0 + q;
    const int i = i0 + threadIdx.x;
    if (i < t_len && j < r) {
      out[static_cast<long long>(j) * t_len + i] = tile[threadIdx.x][q] - c[j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = uint16. ws holds splits * t * r floats; k_chunk is
// a multiple of 16 with splits * k_chunk >= d.
extern "C" int lmd_v_projection(const void* raw, int dtype, int t_len, int d,
                                const void* a, int r, const void* c,
                                int splits, int k_chunk, void* ws, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((r + BN - 1) / BN, (t_len + BM - 1) / BM, splits);
  float* w = static_cast<float*>(ws);
  const float* af = static_cast<const float*>(a);
  if (dtype == 0) {
    vproj_partial_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(raw), t_len, d, af, r, k_chunk, w);
  } else if (dtype == 1) {
    vproj_partial_kernel<uint16_t><<<grid, THREADS, 0, st>>>(
        static_cast<const uint16_t*>(raw), t_len, d, af, r, k_chunk, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid((r + 31) / 32, (t_len + 31) / 32);
  vproj_reduce_kernel<<<rgrid, dim3(32, 8), 0, st>>>(
      w, splits, t_len, r, static_cast<const float*>(c), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
