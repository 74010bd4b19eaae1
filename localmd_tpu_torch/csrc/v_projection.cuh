// K2's templates (v_projection.cu has the design): the raw tile layouts, the
// 3xTF32 wgmma kernel over one (128, 16 NT) output tile, and the dispatch
// over NT = 1..11 for one movie dtype. Each dtype instantiates them in a
// translation unit of its own (v_projection_<dtype>.cu), so the eleven
// tile widths of the seven dtypes compile in seven nvcc processes at once;
// v_projection.cu holds the entry points, which call the dtypes' dispatch
// functions declared at the end of this header.

#pragma once

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

// The arguments of a dtype's dispatch function (dispatch<T> above).
#define LMD_VP_DISPATCH_PARAMS                                                       \
  int nt, const void* raw, int t_len, int d, const float* bt, int d_pad, int r,     \
      int n_tiles, int splits, int k_chunk, float* ws, cudaStream_t st

namespace lmd_vp {

// The partial products of one chunk (grid n_tiles x ceil(t / 128) x splits)
// for raw of the named dtype, at tile width 16 nt; v_projection_<dtype>.cu.
cudaError_t dispatch_float32(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_uint16(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_int16(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_uint8(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_int8(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_float16(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_bfloat16(LMD_VP_DISPATCH_PARAMS);

}  // namespace lmd_vp

// The body of dispatch_<NAME> for raw of type T, in NAME's translation unit.
#define LMD_VP_DEFINE_DISPATCH(NAME, T)                                              \
  cudaError_t lmd_vp::dispatch_##NAME(LMD_VP_DISPATCH_PARAMS) {                      \
    return dispatch<T>(nt, raw, t_len, d, bt, d_pad, r, n_tiles, splits, k_chunk, ws, \
                       st);                                                           \
  }
