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

#include "tf32_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int BM = 128;     // t rows per CTA
constexpr int BK = 32;      // pixels per slab
constexpr int STAGES = 3;
constexpr int THREADS = 256;

// A (128, 32) raw tile in shared memory, in the dtype's own bits
// (tf32_common.cuh's Elem), by its width: Raw float, uint16_t or uint8_t.
template <typename Raw>
struct RawLayout;

// float32 rows: 32 floats = 8 chunks of 4, swizzled like the B tiles
template <>
struct RawLayout<float> {
  static constexpr int kChunks = 8;
  __device__ static int chunk_offset(int m, int c) {  // in elements
    return m * BK + lmd::swz_chunk(m, c) * 4;
  }
  // the pair (samples 2t, 2t + 1 of k8 step s) of row m, as stored
  __device__ static float2 pair_bits(const float* tile, int m, int s, int t) {
    return *reinterpret_cast<const float2*>(tile + lmd::swz_pair(m, s, t));
  }
};

// 2-byte rows: 32 values = 4 chunks of 8 (one k8 step each), group s of
// row m at chunk s ^ ((m >> 1) & 3); a pair is one 32-bit load
template <>
struct RawLayout<uint16_t> {
  static constexpr int kChunks = 4;
  __device__ static int chunk_offset(int m, int c) { return m * BK + ((c ^ (m >> 1)) & 3) * 8; }
  __device__ static uint32_t pair_bits(const uint16_t* tile, int m, int s, int t) {
    return *reinterpret_cast<const uint32_t*>(tile + m * BK + ((s ^ (m >> 1)) & 3) * 8 + 2 * t);
  }
};

// 1-byte rows: 32 values = 2 chunks of 16 (two k8 steps each), chunk c of
// row m at c ^ ((m >> 2) & 1): rows g and g + 4 of a warp's load, 32 bytes
// apart per row otherwise, then read distinct banks; a pair is one 16-bit
// load
template <>
struct RawLayout<uint8_t> {
  static constexpr int kChunks = 2;
  __device__ static int chunk_offset(int m, int c) { return m * BK + ((c ^ (m >> 2)) & 1) * 16; }
  __device__ static uint32_t pair_bits(const uint8_t* tile, int m, int s, int t) {
    return *reinterpret_cast<const uint16_t*>(
        tile + m * BK + (((s >> 1) ^ (m >> 2)) & 1) * 16 + (s & 1) * 8 + 2 * t);
  }
};

template <typename T>
struct RawTile {
  using E = lmd::Elem<T>;
  using Raw = typename E::Raw;
  using L = RawLayout<Raw>;
  static constexpr int kChunkElems = 16 / static_cast<int>(sizeof(Raw));
  static constexpr int kChunks = L::kChunks;
  static constexpr int kBytes = BM * BK * static_cast<int>(sizeof(Raw));
  static_assert(kChunks * kChunkElems == BK, "a row is whole 16-byte chunks");
  __device__ static int chunk_offset(int m, int c) { return L::chunk_offset(m, c); }
  // the pair (samples 2t, 2t + 1 of k8 step s) of row m, as exact floats
  __device__ static void pair(const Raw* tile, int m, int s, int t, float& x0, float& x1) {
    const auto v = L::pair_bits(tile, m, s, t);
    if constexpr (sizeof(Raw) == 4) {
      x0 = v.x;
      x1 = v.y;
    } else {
      constexpr int kBits = 8 * static_cast<int>(sizeof(Raw));
      x0 = E::to_f32(v & ((1u << kBits) - 1u));
      x1 = E::to_f32(v >> kBits);
    }
  }
};

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
vproj_wgmma_kernel(const typename RawTile<T>::Raw* __restrict__ raw, int t_len, int d,
                   bool vec_ok, const float* __restrict__ bt, int d_pad, int r, int k_chunk,
                   float* __restrict__ ws) {
  using Raw = typename RawTile<T>::Raw;
  constexpr int ND = BN / 2;          // accumulator registers a thread
  constexpr int A_BYTES = RawTile<T>::kBytes;
  constexpr int B_FLOATS = BN * BK;   // one slab of the projector
  constexpr int STAGE_BYTES = A_BYTES + B_FLOATS * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  // after the ring: hi and lo of two slabs, [slab parity][hi, lo]
  float* split_buf = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wg = warp >> 2;  // warpgroup: rows wg*64 .. +63 of the CTA tile
  const int wl = warp & 3;   // its warp: rows wg*64 + wl*16 + {g, g + 8}
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long k_begin = static_cast<long long>(blockIdx.z) * k_chunk;
  const long long k_end = k_begin + k_chunk < d ? k_begin + k_chunk : d;
  const int n_slabs = k_begin < k_end ? static_cast<int>((k_end - k_begin + BK - 1) / BK) : 0;

  auto stage_a = [&](int st) { return reinterpret_cast<Raw*>(smem + st * STAGE_BYTES); };
  auto stage_b = [&](int st) {
    return reinterpret_cast<float*>(smem + st * STAGE_BYTES + A_BYTES);
  };
  auto hi_buf = [&](int slab) { return split_buf + (slab & 1) * 2 * B_FLOATS; };
  auto lo_buf = [&](int slab) { return hi_buf(slab) + B_FLOATS; };

  // one slab: raw rows m0.. (native dtype) and BN rows of the projector;
  // the projector as core matrices: chunk c (4 k) of row n at
  // ((n / 8) * 8 + c) * 128 B + (n % 8) * 16 B
  auto load_slab = [&](int st, int slab) {
    const long long k0 = k_begin + static_cast<long long>(slab) * BK;
    Raw* as = stage_a(st);
    constexpr int CE = RawTile<T>::kChunkElems;
    constexpr int A_CHUNKS = BM * RawTile<T>::kChunks;
    for (int i = tid; i < A_CHUNKS; i += THREADS) {
      const int m = i / RawTile<T>::kChunks;
      const int c = i % RawTile<T>::kChunks;
      const long long k = k0 + c * CE;
      Raw* dst = as + RawTile<T>::chunk_offset(m, c);
      const bool row_in = m0 + m < t_len;
      const Raw* src = raw + static_cast<long long>(m0 + m) * d + k;
      if (vec_ok) {
        const bool in = row_in && k < k_end;
        lmd::cp_async16(dst, in ? src : raw, in);
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          dst[e] = (row_in && k + e < k_end) ? src[e] : Raw(0);
        }
      }
    }
    float* bs = stage_b(st);
    for (int i = tid; i < BN * 8; i += THREADS) {
      const int n = i >> 3;
      const int c = i & 7;
      lmd::cp_async16(bs + ((n >> 3) * 8 + c) * 32 + (n & 7) * 4,
                      bt + static_cast<long long>(n0 + n) * d_pad + k0 + c * 4, true);
    }
  };
  // the projector slab in stage st into hi and lo (same layout), for wgmma
  auto split_slab = [&](int st, int slab) {
    const float4* src = reinterpret_cast<const float4*>(stage_b(st));
    float4* hi = reinterpret_cast<float4*>(hi_buf(slab));
    float4* lo = reinterpret_cast<float4*>(lo_buf(slab));
    for (int i = tid; i < B_FLOATS / 4; i += THREADS) {
      const float4 v = src[i];
      uint32_t h[4], l[4];
      lmd::split_tf32(v.x, h[0], l[0]);
      lmd::split_tf32(v.y, h[1], l[1]);
      lmd::split_tf32(v.z, h[2], l[2]);
      lmd::split_tf32(v.w, h[3], l[3]);
      hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                          __uint_as_float(h[3]));
      lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                          __uint_as_float(l[3]));
    }
  };

  // part: this slab's sums, a wgmma chain of 12 started from zero; acc: the
  // split's sum, fp32 adds rounded to nearest (the tensor cores truncate
  // each product's fp32 result, so one chain over 4096 pixels would drift
  // by 2-3e-5)
  float acc[ND], part[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = part[i] = 0.0f;

  // the A fragments of slab i's four k8 steps: rows g and g + 8 of this
  // warp's 16, samples 2t and 2t + 1 of the step (logical k = t and t + 4;
  // the wrapper stores the projector's k in the same order)
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
  auto prepare = [&](int i) {
    const Raw* as = stage_a(i % STAGES);
    const int m = wg * 64 + wl * 16 + g;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      float x0, x1, y0, y1;
      RawTile<T>::pair(as, m, s, tq, x0, x1);
      RawTile<T>::pair(as, m + 8, s, tq, y0, y1);
      lmd::split_tf32(x0, ahi[s][0], alo[s][0]);
      lmd::split_tf32(y0, ahi[s][1], alo[s][1]);
      lmd::split_tf32(x1, ahi[s][2], alo[s][2]);
      lmd::split_tf32(y1, ahi[s][3], alo[s][3]);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_slabs) load_slab(st, st);
    lmd::cp_async_commit();
  }
  lmd::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (n_slabs > 0) {
    split_slab(0, 0);
    prepare(0);
  }

  for (int it = 0; it < n_slabs; ++it) {
    // slab it + 1 has landed; slab it's hi/lo and A fragments are made;
    // iteration it - 1 is done with its stage and with the hi/lo buffers
    // of parity it + 1
    lmd::cp_async_wait<STAGES - 3>();
    lmd::fence_proxy_async_shared();
    __syncthreads();
    if (it + STAGES - 1 < n_slabs) load_slab((it + STAGES - 1) % STAGES, it + STAGES - 1);
    lmd::cp_async_commit();

#pragma unroll
    for (int i = 0; i < ND; ++i) lmd::fence_operand(part[i]);
    lmd::wgmma_fence();
    const float* bh = hi_buf(it);
    const float* bl = lo_buf(it);
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      // k8 step s: core matrices 2s and 2s + 1 along K
      const uint64_t dh = lmd::smem_desc(bh + 2 * s * 32, 128, 1024);
      const uint64_t dl = lmd::smem_desc(bl + 2 * s * 32, 128, 1024);
      lmd::Wgmma<BN>::run(part, alo[s], dh, s > 0 ? 1 : 0);
      lmd::Wgmma<BN>::run(part, ahi[s], dl, 1);
      lmd::Wgmma<BN>::run(part, ahi[s], dh, 1);
    }
    lmd::wgmma_commit();
    lmd::wgmma_wait_all();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lmd::fence_operand(ahi[s][q]);
        lmd::fence_operand(alo[s][q]);
      }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      lmd::fence_operand(part[i]);
      acc[i] += part[i];
    }
    // the next slab's projector into hi/lo and its A fragments
    if (it + 1 < n_slabs) {
      split_slab((it + 1) % STAGES, it + 1);
      prepare(it + 1);
    }
  }
  lmd::cp_async_wait<0>();

  // accumulator layout: register 4j + q holds row g (q < 2) or g + 8, column
  // 8j + 2t + (q & 1)
  float* dst = ws + static_cast<long long>(blockIdx.z) * t_len * r;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + wg * 64 + wl * 16 + g + half * 8;
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * tq;
      float* p = dst + static_cast<long long>(row) * r + col;
      if (col < r) p[0] = acc[4 * j + 2 * half];
      if (col + 1 < r) p[1] = acc[4 * j + 2 * half + 1];
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

template <typename T, int NT>
cudaError_t launch_partial(const typename RawTile<T>::Raw* raw, int t_len, int d, bool vec_ok,
                           const float* bt, int d_pad, int r, int n_tiles, int splits,
                           int k_chunk, float* ws, cudaStream_t st) {
  constexpr int BN = 16 * NT;
  constexpr int SMEM = STAGES * (RawTile<T>::kBytes + BN * BK * 4) + 4 * BN * BK * 4;
  auto kern = vproj_wgmma_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (t_len + BM - 1) / BM, splits);
  kern<<<grid, THREADS, SMEM, st>>>(raw, t_len, d, vec_ok, bt, d_pad, r, k_chunk, ws);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nt, const void* raw_v, int t_len, int d, const float* bt, int d_pad,
                     int r, int n_tiles, int splits, int k_chunk, float* ws, cudaStream_t st) {
  const auto* raw = static_cast<const typename RawTile<T>::Raw*>(raw_v);
  // 16-byte cp.async needs whole 16-byte chunks of every row
  const bool vec_ok = (d % RawTile<T>::kChunkElems) == 0 &&
                      (reinterpret_cast<uintptr_t>(raw_v) % 16) == 0;
#define LMD_VP_CASE(N)                                                                   \
  case N:                                                                                \
    return launch_partial<T, N>(raw, t_len, d, vec_ok, bt, d_pad, r, n_tiles, splits,    \
                                k_chunk, ws, st);
  switch (nt) {
    LMD_VP_CASE(1) LMD_VP_CASE(2) LMD_VP_CASE(3) LMD_VP_CASE(4)
    LMD_VP_CASE(5) LMD_VP_CASE(6) LMD_VP_CASE(7) LMD_VP_CASE(8)
    LMD_VP_CASE(9) LMD_VP_CASE(10) LMD_VP_CASE(11)
    default:
      return cudaErrorInvalidValue;
  }
#undef LMD_VP_CASE
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
#define LMD_VP_DTYPE(CODE, T)                                                               \
  case CODE:                                                                                \
    err = dispatch<T>(nt, raw, t_len, d, b, d_pad, r, n_tiles, splits, k_chunk, w, st);    \
    break;
  switch (dtype) {
    LMD_VP_DTYPE(0, float) LMD_VP_DTYPE(1, uint16_t) LMD_VP_DTYPE(2, int16_t)
    LMD_VP_DTYPE(3, uint8_t) LMD_VP_DTYPE(4, int8_t) LMD_VP_DTYPE(5, __half)
    LMD_VP_DTYPE(6, __nv_bfloat16)
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
