// K1: per-pixel mean and Welch noise sigma of one raw frame chunk, the
// band DFT on the tensor cores in 3xTF32.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_movie_stats (body
// _stats_kernel). Same arithmetic as ops/noise.py welch_noise_estimate /
// welch_noise_estimate_ref_compat: per pixel, mean = sum_t x / divisor; for
// each Welch segment (length nperseg, step nperseg - 128) the windowed
// partial DFT at bins [65, 129) with the segment mean removed through the
// column sums, |X|^2 accumulated over segments, the Nyquist bin halved
// (2k >= nperseg), sigma = sqrt(mean over the 64 bins).
//
// Bounds on an H100 SXM, for a (1024, 262144) f32 chunk at nperseg 256
// (7 segments): the DFT is 2 * 128 * 256 flops per pixel and segment,
// 1.2e11 in all: 1.8 ms on the CUDA cores at 67 TFLOP/s fp32, 0.73 ms as
// the three TF32 products of 3xTF32 at 495 TFLOP/s; the chunk read once is
// 1.07 GB, 0.32 ms. The design targets the 3xTF32 bound. One TF32 pass
// misses the 1e-4 sigma bar by up to 150x on data with an offset (a uint16
// baseline of 1000 with small noise); 3xTF32 (tf32_common.cuh) meets it.
//
// Design. Per segment the DFT is a product: x_seg^T (pixels x nperseg) @
// [cos | sin] (nperseg x 128). The wrapper builds the windowed matrix with
// ops/noise.py's f32 arithmetic, splits it into tf32 hi and lo, stores it
// K-major (128, nperseg rounded up to 32, zero rows past nperseg; cos
// columns of the 64 bins, then their sin columns; each 8 samples in the
// order the A fragments take them) and caches it per device. A CTA owns
// 128 pixels; each of its two warpgroups multiplies 64 of them by all 128
// columns with wgmma.mma_async m64n128k8 (wgmma_tf32.cuh): A, the chunk's
// samples, from registers, where they are converted from the native dtype
// and split; B, the matrix's hi or lo, from shared memory. Segments run one
// after another inside the CTA; each streams 32-sample slabs of the chunk
// (masked past the segment) and of hi/lo through a 4-stage cp.async ring,
// one barrier a slab. The matrix is read from L2 once per CTA and segment
// (256 KB at nperseg 256, since hi and lo do not fit in shared memory
// together), which is the larger stream: a segment's second half is read
// again, from L2, as the next segment's first half rather than held
// (holding it would halve the pixels per CTA and double the matrix's
// reads). The mean is folded into the same pass: each thread adds its
// samples once, the first time a slab covers them, in double (float32,
// float16, bfloat16) or exactly in int64 (the integer dtypes, at any chunk
// length), in a fixed order; samples past the last segment, and the whole
// chunk in mean-only mode, stream through mean-only slabs. So the chunk crosses HBM once. The tensor cores truncate each
// product's fp32 result, so a chain drifts with the size of its partial
// sums; the DFT runs on x minus the segment's first sample per pixel, which
// keeps a baseline (uint16 at 1000) out of them (the offset's share of each
// bin leaves exactly through the column sums). Epilogue per segment: the
// segment sum of x - offset (fp32) detrends through cos1/sin1 (a bin's cos
// and sin land in one thread), |X|^2 adds into registers; at the end the
// band mean reduces over the quad in a fixed order. No sincos runs here.
// Pixels not 16-byte aligned (P not a multiple of 16 bytes' worth of
// values, or an offset base) load through registers instead of cp.async.
//
// Dtypes: float32, uint16, int16, uint8, int8, float16 and bfloat16, each
// read in its own width (tf32_common.cuh's Elem) and converted to float
// exactly in registers; int16 samples may be negative (the DFT runs on
// differences of exact floats).

#include "tf32_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int TILE_P = 128;   // pixels per CTA
constexpr int BK = 32;        // samples per slab
constexpr int N_COLS = 128;   // 64 bins x (cos, sin)
constexpr int N_BINS = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int BAND_START = 65;

// A slab of the chunk in shared memory: 32 samples x 128 pixels in the
// dtype's own bits, each row padded by one 16-byte chunk (132 floats, 136
// 2-byte or 144 1-byte values): the four fragment loads of a k8 step
// (samples 2t, 2t + 1, pixels g, g + 8) then fall on distinct banks, the
// rows of one load 8 words apart.
template <typename T>
struct Tile {
  using E = lmd::Elem<T>;
  using Raw = typename E::Raw;
  using Acc = typename E::Acc;
  static constexpr int kChunkElems = 16 / static_cast<int>(sizeof(Raw));
  static constexpr int kStride = TILE_P + kChunkElems;
  static constexpr int kBytes = BK * kStride * static_cast<int>(sizeof(Raw));
  __device__ static float load(const Raw* tile, int k, int p) {
    return E::to_f32(tile[k * kStride + p]);
  }
  __device__ static Acc to_acc(float v) { return E::to_acc(v); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
movie_stats_wgmma_kernel(const typename Tile<T>::Raw* __restrict__ x, int t_len, int n_pix,
                         bool vec_ok,
                         const float* __restrict__ w_hi,  // (128, nper_pad) K-major
                         const float* __restrict__ w_lo,
                         const float* __restrict__ cos1,  // (64,) column sums
                         const float* __restrict__ sin1,
                         int nperseg, int nper_pad, int n_segs, float mean_divisor,
                         float scale, float* __restrict__ mean_out,
                         float* __restrict__ sigma_out) {
  using Raw = typename Tile<T>::Raw;
  using Acc = typename Tile<T>::Acc;
  constexpr int X_BYTES = Tile<T>::kBytes;
  constexpr int W_FLOATS = N_COLS * BK;
  constexpr int STAGE_BYTES = X_BYTES + 2 * W_FLOATS * 4;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wg = warp >> 2;  // warpgroup: pixels wg*64 .. +63 of the tile
  const int wl = warp & 3;   // its warp: pixels wg*64 + wl*16 .. +15
  const long long p0 = static_cast<long long>(blockIdx.x) * TILE_P;
  const int step = nperseg - 128;
  const int sps = nper_pad / BK;  // slabs per segment
  const int seg_iters = n_segs * sps;
  const int tail_start = n_segs > 0 ? (n_segs - 1) * step + nperseg : 0;
  const int n_iters = seg_iters + (t_len - tail_start + BK - 1) / BK;

  auto stage_x = [&](int st) { return reinterpret_cast<Raw*>(smem + st * STAGE_BYTES); };
  auto stage_wh = [&](int st) {
    return reinterpret_cast<float*>(smem + st * STAGE_BYTES + X_BYTES);
  };
  auto stage_wl = [&](int st) { return stage_wh(st) + W_FLOATS; };

  // iteration i: its first chunk row, its valid rows, and its matrix slab
  // (-1 for a mean-only slab past the last segment)
  auto slab_of = [&](int i, int& row0, int& rows, int& wslab) {
    if (i < seg_iters) {
      const int s = i / sps;
      wslab = i % sps;
      row0 = s * step + wslab * BK;
      rows = min(BK, nperseg - wslab * BK);
    } else {
      wslab = -1;
      row0 = tail_start + (i - seg_iters) * BK;
      rows = min(BK, t_len - row0);
    }
  };

  auto load_slab = [&](int st, int i) {
    int row0, rows, wslab;
    slab_of(i, row0, rows, wslab);
    Raw* xs = stage_x(st);
    constexpr int CE = Tile<T>::kChunkElems;
    constexpr int CPR = TILE_P / CE;  // chunks per row
    for (int q = tid; q < BK * CPR; q += THREADS) {
      const int k = q / CPR;
      const int c = q % CPR;
      const long long p = p0 + c * CE;
      Raw* dst = xs + k * Tile<T>::kStride + c * CE;
      const Raw* src = x + static_cast<long long>(row0 + k) * n_pix + p;
      if (vec_ok) {
        const bool in = k < rows && p < n_pix;
        lmd::cp_async16(dst, in ? src : x, in);
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) dst[e] = (k < rows && p + e < n_pix) ? src[e] : Raw(0);
      }
    }
    if (wslab >= 0) {
      float* wh = stage_wh(st);
      float* wl = stage_wl(st);
      // as core matrices: chunk c (4 k) of row n at ((n / 8) * 8 + c) * 128 B + (n % 8) * 16 B
      for (int q = tid; q < N_COLS * 8; q += THREADS) {
        const int n = q >> 3;
        const int c = q & 7;
        const long long off = static_cast<long long>(n) * nper_pad + wslab * BK + c * 4;
        const int so = ((n >> 3) * 8 + c) * 32 + (n & 7) * 4;
        lmd::cp_async16(wh + so, w_hi + off, true);
        lmd::cp_async16(wl + so, w_lo + off, true);
      }
    }
  };

  // per thread: pixel rows p and p + 8 (h = 0, 1) of its warp's 16
  const int p_loc = wg * 64 + wl * 16 + g;
  float acc[64];          // this segment's DFT: 64 pixels x 128 columns over the warpgroup
  float pw[2][8][2];      // |X|^2 over segments: row half, bin tile, column
  float seg_sum[2] = {};  // this segment's sum of x - off, per pixel row
  float off[2] = {};      // the segment's first sample, per pixel row
  Acc msum[2] = {};       // the mean's sum of the thread's samples, per pixel row
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) pw[h][j][0] = pw[h][j][1] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // The A fragments of slab i's four k8 steps (pixel rows p, p + 8; samples
  // 2t and 2t + 1 of the step, logical k = t and t + 4; the wrapper stores
  // the matrix's k in the same order), its sum of x - off per pixel row,
  // and its share of the mean.
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
  float slab_sum[2];
  auto prepare = [&](int i) {
    const Raw* xs = stage_x(i % STAGES);
    int row0, rows, wslab;
    slab_of(i, row0, rows, wslab);
    // rows [cnt_lo, rows) of this slab are seen for the first time
    int cnt_lo = 0;
    if (i < seg_iters && i >= sps) {
      const int prev_end = (i / sps - 1) * step + nperseg;
      cnt_lo = max(0, min(rows, prev_end - row0));
    }
    if (wslab == 0) {
      off[0] = Tile<T>::load(xs, 0, p_loc);
      off[1] = Tile<T>::load(xs, 0, p_loc + 8);
    }
    slab_sum[0] = slab_sum[1] = 0.0f;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const int k0 = s * 8 + 2 * tq;
      const float v[4] = {Tile<T>::load(xs, k0, p_loc), Tile<T>::load(xs, k0, p_loc + 8),
                          Tile<T>::load(xs, k0 + 1, p_loc), Tile<T>::load(xs, k0 + 1, p_loc + 8)};
      if (k0 >= cnt_lo && k0 < rows) {
        msum[0] += Tile<T>::to_acc(v[0]);
        msum[1] += Tile<T>::to_acc(v[1]);
      }
      if (k0 + 1 >= cnt_lo && k0 + 1 < rows) {
        msum[0] += Tile<T>::to_acc(v[2]);
        msum[1] += Tile<T>::to_acc(v[3]);
      }
      // x minus the segment's first sample: an offset common to the
      // segment leaves the DFT bins through the column sums, and the
      // smaller partial sums lose less to the tensor cores' truncation
      const bool in0 = k0 < rows;
      const bool in1 = k0 + 1 < rows;
      const float u[4] = {v[0] - off[0], v[1] - off[1], v[2] - off[0], v[3] - off[1]};
      slab_sum[0] += (in0 ? u[0] : 0.0f) + (in1 ? u[2] : 0.0f);
      slab_sum[1] += (in0 ? u[1] : 0.0f) + (in1 ? u[3] : 0.0f);
#pragma unroll
      for (int q = 0; q < 4; ++q) lmd::split_tf32(u[q], ahi[s][q], alo[s][q]);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_iters) load_slab(st, st);
    lmd::cp_async_commit();
  }
  lmd::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (n_iters > 0) prepare(0);

  for (int it = 0; it < n_iters; ++it) {
    // slab it + 1 has landed; iteration it - 1 is done with its stage
    lmd::cp_async_wait<STAGES - 3>();
    lmd::fence_proxy_async_shared();
    __syncthreads();
    if (it + STAGES - 1 < n_iters) load_slab((it + STAGES - 1) % STAGES, it + STAGES - 1);
    lmd::cp_async_commit();

    int row0, rows, wslab;
    slab_of(it, row0, rows, wslab);
    if (wslab >= 0) {  // not a mean-only slab
#pragma unroll
      for (int i = 0; i < 64; ++i) lmd::fence_operand(acc[i]);
      lmd::wgmma_fence();
      const float* wh = stage_wh(it % STAGES);
      const float* wlo = stage_wl(it % STAGES);
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        // k8 step s: core matrices 2s and 2s + 1 along K; a segment's first
        // product starts the accumulators from zero
        const uint64_t dh = lmd::smem_desc(wh + 2 * s * 32, 128, 1024);
        const uint64_t dl = lmd::smem_desc(wlo + 2 * s * 32, 128, 1024);
        lmd::Wgmma<N_COLS>::run(acc, alo[s], dh, (wslab > 0 || s > 0) ? 1 : 0);
        lmd::Wgmma<N_COLS>::run(acc, ahi[s], dl, 1);
        lmd::Wgmma<N_COLS>::run(acc, ahi[s], dh, 1);
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
      for (int i = 0; i < 64; ++i) lmd::fence_operand(acc[i]);
      seg_sum[0] += slab_sum[0];
      seg_sum[1] += slab_sum[1];
    }

    if (wslab == sps - 1) {
      // end of a segment: detrend through the column sums (the mean of
      // x - off: the offset's share of each bin goes with it), add |X|^2.
      // Register 4j + q holds row p (q < 2) or p + 8, column 8j + 2t + (q & 1):
      // bin 8j + 2t + e's cos at j < 8, its sin at j + 8.
      const float inv_n = 1.0f / static_cast<float>(nperseg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tot = seg_sum[h];
        tot += __shfl_xor_sync(0xffffffffu, tot, 1);
        tot += __shfl_xor_sync(0xffffffffu, tot, 2);
        const float m = tot * inv_n;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = j * 8 + 2 * tq + e;
            const float rr = acc[4 * j + 2 * h + e] - __ldg(cos1 + b) * m;
            const float ii = acc[4 * (j + 8) + 2 * h + e] - __ldg(sin1 + b) * m;
            pw[h][j][e] += rr * rr + ii * ii;
          }
        seg_sum[h] = 0.0f;
      }
    }
    if (it + 1 < n_iters) prepare(it + 1);
  }
  lmd::cp_async_wait<0>();

  // mean: the quad's partial sums, in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    Acc tot = msum[h];
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    const long long p = p0 + p_loc + h * 8;
    if (tq == 0 && p < n_pix) {
      mean_out[p] = static_cast<float>(static_cast<double>(tot)) / mean_divisor;
    }
  }

  // sigma: the band mean over the 64 bins, summed over the quad in a fixed order
  const float sc = n_segs > 0 ? scale / static_cast<float>(n_segs) : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float band = pw[h][j][e] * sc;
        if (2 * (BAND_START + j * 8 + 2 * tq + e) >= nperseg) band *= 0.5f;
        part += band;
      }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    const long long p = p0 + p_loc + h * 8;
    if (tq == 0 && p < n_pix) {
      sigma_out[p] = n_segs > 0 ? sqrtf(part / static_cast<float>(N_BINS)) : 0.0f;
    }
  }
}

template <typename T>
cudaError_t launch(const void* xv, int t_len, int n_pix, const float* w_hi, const float* w_lo,
                   const float* cos1, const float* sin1, int nperseg, int nper_pad, int n_segs,
                   float mean_divisor, float scale, float* mean_out, float* sigma_out,
                   cudaStream_t st) {
  const auto* x = static_cast<const typename Tile<T>::Raw*>(xv);
  // 16-byte cp.async needs whole 16-byte chunks of every row
  const bool vec_ok = (n_pix % Tile<T>::kChunkElems) == 0 &&
                      (reinterpret_cast<uintptr_t>(xv) % 16) == 0;
  constexpr int SMEM = STAGES * (Tile<T>::kBytes + 2 * N_COLS * BK * 4);
  auto kern = movie_stats_wgmma_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_pix + TILE_P - 1) / TILE_P);
  kern<<<grid, THREADS, SMEM, st>>>(x, t_len, n_pix, vec_ok, w_hi, w_lo, cos1, sin1, nperseg,
                                    nper_pad, n_segs, mean_divisor, scale, mean_out, sigma_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = uint16, 2 = int16, 3 = uint8, 4 = int8,
// 5 = float16, 6 = bfloat16. w_hi / w_lo: (128, nper_pad) K-major tf32
// parts of the windowed band-DFT matrix in the wrapper's column order;
// n_segs = 0 computes the mean only (sigma 0).
extern "C" int lmd_movie_stats(const void* x, int dtype, int t_len, int n_pix,
                               const void* w_hi, const void* w_lo, const void* cos1,
                               const void* sin1, int nperseg, int nper_pad, int n_segs,
                               float mean_divisor, float scale, void* mean_out,
                               void* sigma_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wh = static_cast<const float*>(w_hi);
  const float* wl = static_cast<const float*>(w_lo);
  const float* c1 = static_cast<const float*>(cos1);
  const float* s1 = static_cast<const float*>(sin1);
  float* mo = static_cast<float*>(mean_out);
  float* so = static_cast<float*>(sigma_out);
#define LMD_MS_CASE(CODE, T)                                                              \
  case CODE:                                                                              \
    return static_cast<int>(launch<T>(x, t_len, n_pix, wh, wl, c1, s1, nperseg, nper_pad, \
                                      n_segs, mean_divisor, scale, mo, so, st));
  switch (dtype) {
    LMD_MS_CASE(0, float) LMD_MS_CASE(1, uint16_t) LMD_MS_CASE(2, int16_t)
    LMD_MS_CASE(3, uint8_t) LMD_MS_CASE(4, int8_t) LMD_MS_CASE(5, __half)
    LMD_MS_CASE(6, __nv_bfloat16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMD_MS_CASE
}
