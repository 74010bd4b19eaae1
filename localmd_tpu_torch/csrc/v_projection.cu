// K2: streamed temporal regression, out = (raw @ A - c)^T, on the tensor
// cores in 3xTF32.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_v_projection (body
// _vproj_kernel, tile choice _vp_pick_tiles). raw is one (t, d) frame chunk
// in its native dtype (float32, uint16, int16, uint8, int8, float16 or
// bfloat16; tf32_common.cuh's Elem) with C-order pixels, A the (d, r')
// folded projector, c the (r',) constant; out is (r', t) float32.
//
// Bounds on an H100 SXM (495 TFLOP/s TF32, 3.35 TB/s). The JAX package
// pins Precision.HIGHEST and the port holds K2 to 1e-5 of fp32, which one
// TF32 pass misses by 20x on offset data; 3xTF32 (tf32_common.cuh) meets
// it with three products, so the floor is 3 * 2 t d r' / 495 TFLOP/s:
// - the widefield chunk, (4000, 345600) x 1650 uint16: 27.6 ms, against
//   2.6 ms for its bytes (raw 2.8 GB, the projector 2.3 GB, V);
// - the main path's (2048, 262144) x 336 float32: 2.19 ms, against 0.7 ms.
// Both are bound by the tensor cores, and inside an SM by what feeds them.
// A CTA's 128 x 176 tile takes 2112 tensor-core cycles a 32-pixel slab
// (3 x 128 x 176 x 32 multiply-adds at 1024 a cycle). Per slab:
// - L2: the raw tile (8 KB uint16, 16 KB float32) and the projector slab
//   (22.5 KB) a CTA; over 132 SMs the loads alone ran at 4.2 TB/s on the
//   card, so a projector pre-split into hi and lo (45 KB a slab) would
//   bound the kernel at the loads (43 ms at the widefield chunk, measured);
// - shared memory: the wgmmas read B (hi twice, lo once) at 64 of the
//   SM's 128 bytes a cycle, 135 KB a slab; the loads land 30.5-38.5 KB,
//   lo is made from hi (22.5 KB read, 22.5 KB written) and the A
//   fragments read. On the card the kernel's time follows this traffic:
//   without lo's 45 KB the widefield chunk took 34.6 ms, with it 43.5
//   (176-wide tiles; 41.9 ms at 168, against the lockstep design's 62.5).
//
// Design (v_projection.cuh). Warp-specialised and persistent: one CTA an
// SM walks work units (a 128-row t tile, an r' tile of BN <= 176 columns,
// a pixel split), the pixel axis in 32-deep slabs through a ring of 3-8
// stages (what fits in 227 KB) with full, ready and empty mbarriers.
// - A loader thread keeps the ring full, STAGES - 1 slabs ahead: the raw
//   tile by the TMA in the dtype's own bits, swizzled so that the
//   consumers' fragment reads hit distinct banks (rows off 16-byte
//   alignment go through registers instead), and the projector slab
//   (float32, stored once per call in the stage's core-matrix order by
//   lmd_projector_t) with one bulk copy.
// - Three splitter warps make each landed slab's lo = x - (x truncated to
//   tf32) beside it. The tensor cores read x itself as hi, truncating it,
//   so hi costs nothing, and lo is exact.
// - Two consumer warpgroups (232 registers; the producers 40) each own 64
//   rows. A slab's 12 wgmmas (lo*hi, hi*lo, hi*hi per k8 step, A from
//   registers, B from shared memory) go as two commit groups; at depth 1
//   the first half's A registers take the next slab's raw samples,
//   converted and split in registers, while the second half runs. No
//   block barrier: the ring's barriers alone pace the warps.
// - Accuracy: the tensor cores truncate each product's fp32 result, so a
//   long chain drifts toward zero (2-3e-5 over 4096 pixels, on the card):
//   each slab's chain starts from zero and is added into the unit's sum
//   with ordinary fp32 adds, which round to nearest. That doubles the
//   accumulator registers, which is what caps the r' tile at 176. A unit
//   sums at most 4096 pixels (split-K); vproj_reduce_kernel adds the splits
//   in a fixed order, subtracts c and stores the transpose. No atomics:
//   results are deterministic.
// Tried on the card and left out: the projector pre-split in device memory
// (L2-bound, above), clusters of 2 and 4 CTAs multicasting it (slower:
// 77 and 117 ms against 62 at the widefield chunk) and the consumer
// warpgroups taking turns to issue (within 1%).
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

// a (d, r) row-major, laid out as K2's stages take it: bt[tile][slab] is
// the (bn, 32) slab of r' tile `tile` and pixels slab * 32 .. + 31 as core
// matrices (chunk c of 4 pixels of row n at ((n / 8) * 8 + c) * 32 +
// (n % 8) * 4 floats), zero where k >= d or n >= r. A block moves a 32 x 32
// tile through shared memory, so both the read (along r') and the write
// (one core matrix of 128 bytes a warp) coalesce.
__global__ void projector_t_kernel(const float* __restrict__ a, int d, int r,
                                   float* __restrict__ bt, int slabs, int bn, int r_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;  // slab blockIdx.x
  const int n0 = blockIdx.y * 32;
  for (int q = threadIdx.y; q < 32; q += blockDim.y) {
    const int k = k0 + q;
    const int n = n0 + threadIdx.x;
    tile[q][threadIdx.x] = (k < d && n < r) ? a[static_cast<long long>(k) * r + n] : 0.0f;
  }
  __syncthreads();
  const int nn = threadIdx.x >> 2;  // row of the core matrix
  const int kk = threadIdx.x & 3;   // pixel of its chunk
  for (int cm = threadIdx.y; cm < 32; cm += blockDim.y) {
    const int grp = cm >> 3;        // 8 rows of the 32
    const int c = cm & 7;           // 4 pixels of the 32
    const int n = n0 + grp * 8 + nn;
    if (n >= r_pad) continue;
    const int nl = n % bn;
    bt[(static_cast<long long>(n / bn) * slabs + blockIdx.x) * bn * 32 +
       ((nl >> 3) * 8 + c) * 32 + (nl & 7) * 4 + kk] = tile[c * 4 + kk][grp * 8 + nn];
  }
}

}  // namespace

// The (d, r) projector in K2's layout, at tile width bn over n_tiles tiles.
extern "C" int lmd_projector_t(const void* a, int d, int r, void* bt, int d_pad, int bn,
                               int n_tiles, void* stream) {
  const dim3 grid(d_pad / 32, (bn * n_tiles + 31) / 32);
  projector_t_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), d, r, static_cast<float*>(bt), d_pad / 32, bn, bn * n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = uint16, 2 = int16, 3 = uint8, 4 = int8,
// 5 = float16, 6 = bfloat16. bt is lmd_projector_t's at tile width bn,
// d_pad a multiple of 32 covering d; k_chunk is a multiple of 32 and
// splits = ceil(d / k_chunk); ctas persistent CTAs, at most one an SM
// and at most the work units; ws holds splits * t * r floats.
extern "C" int lmd_v_projection(const void* raw, int dtype, int t_len, int d, const void* bt,
                                int d_pad, int r, int bn, int n_tiles, const void* c,
                                int splits, int k_chunk, int ctas, void* ws, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* b = static_cast<const float*>(bt);
  cudaError_t err;
#define LMD_VP_DTYPE(CODE, NAME)                                                          \
  case CODE:                                                                              \
    err = lmd_vp::dispatch_##NAME(bn, raw, t_len, d, b, d_pad, r, n_tiles, splits, k_chunk, \
                                  ctas, w, st);                                           \
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
