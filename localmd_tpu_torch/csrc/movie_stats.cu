// K1: per-pixel mean and Welch noise sigma of one raw frame chunk.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_movie_stats (body
// _stats_kernel). Same arithmetic as ops/noise.py welch_noise_estimate /
// welch_noise_estimate_ref_compat: per pixel, mean = sum_t x / divisor; for
// each Welch segment (length nperseg, step nperseg - 128) the windowed
// partial DFT at bins [65, 129) with the segment mean removed through the
// column sums, |X|^2 accumulated over segments, the Nyquist bin halved
// (2k >= nperseg), sigma = sqrt(mean over the 64 bins).
//
// What bounds it on the card: the windowed DFT is 2 * 64 * nperseg FMAs per
// pixel and segment (about 2.3e5 per pixel for a 1024-frame chunk), read
// from a chunk of T * P native-dtype values that crosses HBM once. At
// P = 262144 that is ~6e10 fp32 FMAs against 1 GB (f32) or 0.5 GB (uint16)
// read, so the CUDA cores bound it, not HBM. The products must stay IEEE
// fp32 (the JAX package pins Precision.HIGHEST; sigma is held to 1e-4), and
// Hopper's tensor cores have no fp32 mode, so this is FMA on the CUDA cores.
//
// Design: one CTA per tile of 64 contiguous pixels (loads along P coalesce),
// 256 threads = 16 bin groups x 16 pixel groups, each thread owning a 4-bin x
// 4-pixel register tile of the cos and sin sums. A loop over segments inside
// the CTA replaces the TPU's whole-chunk VMEM tile; each segment streams
// 32-sample slabs of the chunk (converted to f32 on load) and of the cos/sin
// matrices through shared memory, so reference mode (nperseg = T up to 1024,
// 512 KB of matrices) never needs the matrices resident. The matrices come
// from the wrapper, built with the same f32 arithmetic as ops/noise.py:55-61;
// no sincos runs here. The mean is summed in double in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_P = 64;   // pixels per CTA
constexpr int TILE_N = 32;   // samples per shared slab
constexpr int N_BINS = 64;
constexpr int THREADS = 256;
constexpr int BAND_START = 65;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) { return static_cast<float>(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
movie_stats_kernel(const T* __restrict__ x, int t_len, int n_pix,
                   const float* __restrict__ cos_m,  // (nperseg, 64) windowed
                   const float* __restrict__ sin_m,  // (nperseg, 64) windowed
                   const float* __restrict__ cos1,   // (64,) column sums
                   const float* __restrict__ sin1,   // (64,)
                   int nperseg, int n_segs, float mean_divisor, float scale,
                   float* __restrict__ mean_out, float* __restrict__ sigma_out) {
  __shared__ __align__(16) float xs[TILE_N][TILE_P];
  __shared__ __align__(16) float cs[TILE_N][N_BINS];
  __shared__ __align__(16) float ss[TILE_N][N_BINS];
  __shared__ float red[THREADS / TILE_P * 4][TILE_P];  // 16 x 64
  __shared__ double msum[THREADS / TILE_P][TILE_P];    // 4 x 64

  const int tid = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * TILE_P;

  // ---- mean: 4 row phases per pixel column, summed in double ----
  {
    const int c = tid % TILE_P;
    const int part = tid / TILE_P;
    double acc = 0.0;
    if (p0 + c < n_pix) {
      for (int r = part; r < t_len; r += THREADS / TILE_P) {
        acc += static_cast<double>(to_f32(x[static_cast<long long>(r) * n_pix + p0 + c]));
      }
    }
    msum[part][c] = acc;
    __syncthreads();
    if (tid < TILE_P && p0 + tid < n_pix) {
      const double tot = ((msum[0][tid] + msum[1][tid]) + msum[2][tid]) + msum[3][tid];
      mean_out[p0 + tid] = static_cast<float>(tot) / mean_divisor;
    }
  }

  if (n_segs == 0) {  // mean-only mode
    if (tid < TILE_P && p0 + tid < n_pix) sigma_out[p0 + tid] = 0.0f;
    return;
  }

  // ---- Welch band power ----
  const int pg = tid % 16;  // pixels pg*4 .. pg*4+3
  const int kg = tid / 16;  // bins   kg*4 .. kg*4+3
  const int step = nperseg - 128;
  float acc2[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc2[b][i] = 0.0f;

  for (int s = 0; s < n_segs; ++s) {
    const long long base = static_cast<long long>(s) * step;
    float re[4][4], im[4][4], ssum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ssum[i] = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) { re[b][i] = 0.0f; im[b][i] = 0.0f; }
    }
    for (int n0 = 0; n0 < nperseg; n0 += TILE_N) {
      __syncthreads();  // previous slab fully consumed
#pragma unroll
      for (int j = 0; j < TILE_N * TILE_P / THREADS; ++j) {
        const int idx = tid + j * THREADS;
        const int r = idx / TILE_P;
        const int c = idx % TILE_P;
        const int n = n0 + r;
        float v = 0.0f;
        if (n < nperseg && p0 + c < n_pix) {
          v = to_f32(x[(base + n) * n_pix + p0 + c]);
        }
        xs[r][c] = v;
        const bool in = n < nperseg;
        cs[r][c] = in ? cos_m[static_cast<long long>(n) * N_BINS + c] : 0.0f;
        ss[r][c] = in ? sin_m[static_cast<long long>(n) * N_BINS + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < TILE_N; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[r][pg * 4]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[r][kg * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(&ss[r][kg * 4]);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ssum[i] += xa[i];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            re[b][i] = fmaf(ca[b], xa[i], re[b][i]);
            im[b][i] = fmaf(sa[b], xa[i], im[b][i]);
          }
        }
      }
    }
    // detrend through the column sums, then accumulate |X|^2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m = ssum[i] / static_cast<float>(nperseg);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float rr = re[b][i] - cos1[kg * 4 + b] * m;
        const float ii = im[b][i] - sin1[kg * 4 + b] * m;
        acc2[b][i] += rr * rr + ii * ii;
      }
    }
  }

  // ---- band mean over the 64 bins: fixed-order reduction ----
  const float sc = scale / static_cast<float>(n_segs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float part = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float band = acc2[b][i] * sc;
      if (2 * (BAND_START + kg * 4 + b) >= nperseg) band *= 0.5f;
      part += band;
    }
    red[kg][pg * 4 + i] = part;
  }
  __syncthreads();
  if (tid < TILE_P && p0 + tid < n_pix) {
    float tot = 0.0f;
    for (int g = 0; g < 16; ++g) tot += red[g][tid];
    sigma_out[p0 + tid] = sqrtf(tot / static_cast<float>(N_BINS));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = uint16. n_segs = 0 computes the mean only (sigma 0).
extern "C" int lmd_movie_stats(const void* x, int dtype, int t_len, int n_pix,
                               const void* cos_m, const void* sin_m,
                               const void* cos1, const void* sin1,
                               int nperseg, int n_segs, float mean_divisor,
                               float scale, void* mean_out, void* sigma_out,
                               void* stream) {
  const dim3 grid((n_pix + TILE_P - 1) / TILE_P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cm = static_cast<const float*>(cos_m);
  const float* sm = static_cast<const float*>(sin_m);
  const float* c1 = static_cast<const float*>(cos1);
  const float* s1 = static_cast<const float*>(sin1);
  float* mo = static_cast<float*>(mean_out);
  float* so = static_cast<float*>(sigma_out);
  if (dtype == 0) {
    movie_stats_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), t_len, n_pix, cm, sm, c1, s1, nperseg,
        n_segs, mean_divisor, scale, mo, so);
  } else if (dtype == 1) {
    movie_stats_kernel<uint16_t><<<grid, THREADS, 0, st>>>(
        static_cast<const uint16_t*>(x), t_len, n_pix, cm, sm, c1, s1, nperseg,
        n_segs, mean_divisor, scale, mo, so);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
