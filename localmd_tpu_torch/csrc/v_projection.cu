// K2: streamed temporal regression, out = (raw @ A - c)^T, on the tensor
// cores in 3xTF32.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_v_projection (body
// _vproj_kernel, tile choice _vp_pick_tiles). raw is one (t, d) frame chunk
// in its native dtype (float32, uint16, int16, uint8, int8, float16 or
// bfloat16; tf32_common.cuh's Elem) with C-order pixels, A the (d, r')
// folded projector, c the (r',) constant; out is (r', t) float32.
//
// Bounds on an H100 SXM: 2 t d r' flops (3.6e11 for the main path's
// (2048, 262144) x (262144, 336) call) take 5.4 ms on the CUDA cores at
// 67 TFLOP/s fp32, 2.2 ms as the three TF32 products of 3xTF32 at
// 495 TFLOP/s; the bytes (raw once, A once, out once: 2.5 GB) take 0.75 ms.
// The design targets the 3xTF32 bound. The JAX package pins
// Precision.HIGHEST and the port holds K2 to 1e-5 of fp32, which one TF32
// pass misses by 20x on offset data; 3xTF32 (tf32_common.cuh) meets it.
//
// Design. A CTA owns a 128 (t) x BN (r') output tile, BN = 16 NT with NT in
// 1..11 chosen by the wrapper so that r' splits into near-equal tiles of
// at most 176 columns; its two warpgroups each multiply 64 rows with
// wgmma.mma_async m64nBNk8 (wgmma_tf32.cuh): A from registers, B (hi or
// lo) from shared memory through a descriptor. The pixel axis streams in
// 32-deep slabs through a 3-stage cp.async ring, one barrier a slab. raw
// reaches shared memory in its native dtype and is converted and split in
// registers on its way into the A fragments: no f32 copy of the chunk
// exists. The moving of slabs into shared memory bounds this kernel as
// much as its products do (on the card, without its MMAs it still takes
// 60% of its time), and the projector is the larger stream: each t tile
// reads all of it. So the wrapper stores the projector once per call as
// one float32 array, transposed to K-major (r'_pad, d_pad) with each 8
// pixels in the order the A fragments take them (lmd_projector_t below),
// and each slab is split into hi and lo in shared memory (double-buffered)
// after the previous slab's products; a pre-split projector would double
// that stream. Wide r' tiles cut the re-reads of raw. Each k8 step issues
// lo*hi, hi*lo, hi*hi. The tensor cores truncate each product's fp32
// result, so a long chain drifts toward zero (2-3e-5 relative over 4096
// pixels, on the card): each slab's 12-wgmma chain starts from zero and is
// added into the running sum with ordinary fp32 adds, which round to
// nearest. That doubles the accumulator registers, which is what caps BN
// at 176 (222 registers a thread). The pixel axis is split across CTAs
// (split-K, at most 4096 pixels summed per CTA); a second kernel adds the
// splits in a fixed order, subtracts c and stores the transpose. No
// atomics: results are deterministic. Rows whose pixels are not 16-byte
// aligned (d not a multiple of 16 bytes' worth of values, or an offset
// base) load through registers instead of cp.async.
//
// Sources. The templates are in v_projection.cuh and each movie dtype's
// eleven tile widths in v_projection_<dtype>.cu, one nvcc process each; this
// file holds the reduction and projector kernels and the entry points.

#include "v_projection.cuh"

namespace {

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

// a (d, r) row-major, transposed to bt (r_pad, d_pad) K-major, zero where
// k >= d or n >= r, each 8 pixels stored in the order 0, 2, 4, 6, 1, 3, 5, 7:
// the order in which the A fragments take a k8 step's samples (logical
// k = t is pixel 2t, k = t + 4 pixel 2t + 1).
__global__ void projector_t_kernel(const float* __restrict__ a, int d, int r,
                                   float* __restrict__ bt, int d_pad, int r_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;
  const int n0 = blockIdx.y * 32;
  for (int q = threadIdx.y; q < 32; q += blockDim.y) {
    const int k = k0 + q;
    const int n = n0 + threadIdx.x;
    tile[q][threadIdx.x] = (k < d && n < r) ? a[static_cast<long long>(k) * r + n] : 0.0f;
  }
  __syncthreads();
  const int x = threadIdx.x;
  const int src = (x & ~7) | ((x & 3) << 1) | ((x >> 2) & 1);  // pixel at position x
  for (int q = threadIdx.y; q < 32; q += blockDim.y) {
    const int n = n0 + q;
    const int k = k0 + x;
    if (n < r_pad && k < d_pad) bt[static_cast<long long>(n) * d_pad + k] = tile[src][q];
  }
}

}  // namespace

// The (d, r) projector transposed to K2's (r_pad, d_pad) K-major layout.
extern "C" int lmd_projector_t(const void* a, int d, int r, void* bt, int d_pad, int r_pad,
                               void* stream) {
  const dim3 grid((d_pad + 31) / 32, (r_pad + 31) / 32);
  projector_t_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), d, r, static_cast<float*>(bt), d_pad, r_pad);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = uint16, 2 = int16, 3 = uint8, 4 = int8,
// 5 = float16, 6 = bfloat16. bt is (n_tiles * 16 nt, d_pad) from
// lmd_projector_t, d_pad a multiple of 32 covering splits * k_chunk;
// k_chunk is a multiple of 32; ws holds splits * t * r floats.
extern "C" int lmd_v_projection(const void* raw, int dtype, int t_len, int d, const void* bt,
                                int d_pad, int r, int nt, int n_tiles, const void* c,
                                int splits, int k_chunk, void* ws, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* b = static_cast<const float*>(bt);
  cudaError_t err;
#define LMD_VP_DTYPE(CODE, NAME)                                                          \
  case CODE:                                                                              \
    err = lmd_vp::dispatch_##NAME(nt, raw, t_len, d, b, d_pad, r, n_tiles, splits, k_chunk, \
                                  w, st);                                                 \
    break;
  switch (dtype) {
    LMD_VP_DTYPE(0, float32) LMD_VP_DTYPE(1, uint16) LMD_VP_DTYPE(2, int16)
    LMD_VP_DTYPE(3, uint8) LMD_VP_DTYPE(4, int8) LMD_VP_DTYPE(5, float16)
    LMD_VP_DTYPE(6, bfloat16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMD_VP_DTYPE
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid((r + 31) / 32, (t_len + 31) / 32);
  vproj_reduce_kernel<<<rgrid, dim3(32, 8), 0, st>>>(
      w, splits, t_len, r, static_cast<const float*>(c), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
