// K3: blocked reconstruction, out[d1, d2, f] = sum_b U_b @ V_b placed at
// each block's start.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_block_reconstruct
// (body _recon_kernel; recon_window_geometry and panels_f_to_c). panels are
// (N, b1*b2, S) with C-order local rows (i * b2 + j), temporal (N, S, f),
// starts (N, 2) int32; out is the (d1, d2, f) float32 canvas.
//
// What bounds it on the card: bytes. The canvas is written once (4 d1 d2 f
// bytes), the panels and the temporal slices read once each, against
// 2 N b1 b2 S f flops (2e10 at 961 blocks of 32 x 32, S = 20, f = 512):
// 0.196 ms of HBM traffic against 0.122 ms of 3xTF32 tensor-core work at
// the card's peaks. The first port launched one grid per disjoint coset
// and read-modify-wrote the canvas once per coset after a zero fill (4.4
// ms at that shape on an H100 80GB HBM3 at 700 W), its FMAs each paying a
// global and a shared load.
//
// Design: an output-stationary gather in one launch. A CTA owns an 8 x 8
// pixel tile and a 128-frame tile; the host lists, per pixel tile, every
// block that covers any of its pixels, in coset order (so every pixel sums
// its blocks in a fixed order), and the CTA adds U_b[tile pixels] @
// V_b[:, frames] for each into a register tile, then writes each output
// element once -- no atomics, no zero fill, no coset loop; pixels no block
// covers get 0. The product runs on the tensor cores in 3xTF32 (mma.sync
// m16n8k8; each operand split x = hi + lo, csrc/tf32_common.cuh; products
// lo*hi + hi*lo + hi*hi): a block's chain (S rounded up to 8, at most a
// few k8 steps) starts from zero and is added into the fp32 sum with
// ordinary adds, because the tensor cores truncate each product's result.
// Each block's panel rows (zero for tile pixels outside the block) and its
// temporal slice are staged in shared memory by cp.async, double-buffered
// across the tile's blocks. Eight warps, four per 64 frames: a warp takes
// 16 of the tile's pixels (two of its rows) and 64 frames (eight n8
// tiles). 128 frames a CTA stage each panel row once for twice the frames
// of 64: 0.750 / 1.053 ms against 0.764 / 1.220 ms at S = 20 / 40 on an
// H100 80GB HBM3 at 700 W (kernel_variants.py k3); restarting the chain
// per block cost ~10% there at S = 20.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_common.cuh"

namespace {

constexpr int TILE = 8;           // pixel tile: TILE x TILE
constexpr int PIX = TILE * TILE;  // 64 pixels, M of the product
constexpr int FT = 128;           // frames a CTA, N of the product
constexpr int WARPS_N = FT / 64;  // warps side by side along the frames
constexpr int THREADS = 128 * WARPS_N;
constexpr int LDV = FT + 8;       // temporal stage row: bank-free B fragments

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// stage block b: its panel rows for the tile's 64 pixels (zero outside the
// block and past S) and its (S, 64) temporal slice (zero past S and f).
// VU: S % 4 == 0 (16-byte panel chunks), VV: f % 4 == 0 (16-byte slices).
template <bool VU, bool VV>
__device__ __forceinline__ void stage(float* ush, float* vsh, int ldu, int s_pad,
                                      const float* __restrict__ panels,
                                      const float* __restrict__ temporal, int b, int k0,
                                      int j0, int y0, int x0, int b1, int b2, int s_slots,
                                      int f, int f0) {
  const long long pbase = static_cast<long long>(b) * b1 * b2;
  constexpr int UW = VU ? 4 : 1;
  const int ucols = s_pad / UW;
  for (int idx = threadIdx.x; idx < PIX * ucols; idx += THREADS) {
    const int m = idx / ucols;
    const int kk = (idx - m * ucols) * UW;
    const int i = y0 + (m >> 3) - k0;
    const int j = x0 + (m & 7) - j0;
    const bool ok = static_cast<unsigned>(i) < static_cast<unsigned>(b1) &&
                    static_cast<unsigned>(j) < static_cast<unsigned>(b2) && kk < s_slots;
    const float* src = ok ? panels + (pbase + i * b2 + j) * s_slots + kk : panels;
    if (VU) {
      lmd::cp_async16(ush + m * ldu + kk, src, ok);
    } else {
      lmd::cp_async4(ush + m * ldu + kk, src, ok);
    }
  }
  const long long tbase = static_cast<long long>(b) * s_slots;
  constexpr int VW = VV ? 4 : 1;
  constexpr int vcols = FT / VW;
  for (int idx = threadIdx.x; idx < s_pad * vcols; idx += THREADS) {
    const int s = idx / vcols;
    const int nn = (idx - s * vcols) * VW;
    const bool ok = s < s_slots && f0 + nn < f;
    const float* src = ok ? temporal + (tbase + s) * f + f0 + nn : temporal;
    if (VV) {
      lmd::cp_async16(vsh + s * LDV + nn, src, ok);
    } else {
      lmd::cp_async4(vsh + s * LDV + nn, src, ok);
    }
  }
}

template <bool VU, bool VV>
__global__ void __launch_bounds__(THREADS)
recon_gather_kernel(const float* __restrict__ panels,    // (N, b1*b2, S)
                    const float* __restrict__ temporal,  // (N, S, f)
                    const int* __restrict__ starts,      // (N, 2)
                    const int* __restrict__ tile_offsets,  // (tiles + 1,)
                    const int* __restrict__ tile_blocks,   // blocks per tile, coset order
                    int d1, int d2, int b1, int b2, int s_slots, int f,
                    int tiles_x, int f_tiles, int ldu, int s_pad,
                    float* __restrict__ out) {             // (d1, d2, f)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = PIX * ldu + s_pad * LDV;
  const int tile = blockIdx.x / f_tiles;
  const int f0 = (blockIdx.x - tile * f_tiles) * FT;
  const int y0 = (tile / tiles_x) * TILE;
  const int x0 = (tile - (tile / tiles_x) * tiles_x) * TILE;
  const int first = tile_offsets[tile];
  const int nb = tile_offsets[tile + 1] - first;

  const int warp = (threadIdx.x >> 5) & 3;        // the warp's 16 pixels
  const int n_off = 64 * (threadIdx.x >> 7);       // and its 64 frames
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float sum[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] = 0.0f;
  }

  if (nb > 0) {
    const int b = tile_blocks[first];
    stage<VU, VV>(smem, smem + PIX * ldu, ldu, s_pad, panels, temporal, b, starts[2 * b],
                  starts[2 * b + 1], y0, x0, b1, b2, s_slots, f, f0);
  }
  lmd::cp_async_commit();
  for (int i = 0; i < nb; ++i) {
    if (i + 1 < nb) {
      float* nxt = smem + ((i + 1) & 1) * stage_floats;
      const int b = tile_blocks[first + i + 1];
      stage<VU, VV>(nxt, nxt + PIX * ldu, ldu, s_pad, panels, temporal, b, starts[2 * b],
                    starts[2 * b + 1], y0, x0, b1, b2, s_slots, f, f0);
    }
    lmd::cp_async_commit();
    lmd::cp_async_wait<1>();
    __syncthreads();
    const float* ush = smem + (i & 1) * stage_floats;
    const float* vsh = ush + PIX * ldu;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    for (int k0 = 0; k0 < s_pad; k0 += 8) {
      const float* ua = ush + (16 * warp + g) * ldu + k0 + t;
      const float av[4] = {ua[0], ua[8 * ldu], ua[4], ua[8 * ldu + 4]};
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) lmd::split_tf32(av[e], a_hi[e], a_lo[e]);
      const float* vb = vsh + (k0 + t) * LDV + n_off + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        lmd::split_tf32(vb[8 * j], b0_hi, b0_lo);
        lmd::split_tf32(vb[8 * j + 4 * LDV], b1_hi, b1_lo);
        mma_tf32(acc[j], a_lo, b0_hi, b1_hi);
        mma_tf32(acc[j], a_hi, b0_lo, b1_lo);
        mma_tf32(acc[j], a_hi, b0_hi, b1_hi);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[j][e] += acc[j][e];
    }
    __syncthreads();
  }

  // each output element once: rows g and g + 8 of the warp's 16 pixels are
  // tile rows 2 warp and 2 warp + 1, column g
  const bool f_even = (f & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int y = y0 + 2 * warp + half;
    const int x = x0 + g;
    if (y >= d1 || x >= d2) continue;
    float* dst = out + (static_cast<long long>(y) * d2 + x) * f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int fr = f0 + n_off + 8 * j + 2 * t;
      if (fr >= f) continue;
      const float lo = sum[j][2 * half], hi = sum[j][2 * half + 1];
      if (f_even) {
        *reinterpret_cast<float2*>(dst + fr) = make_float2(lo, hi);
      } else {
        dst[fr] = lo;
        if (fr + 1 < f) dst[fr + 1] = hi;
      }
    }
  }
}

template <bool VU, bool VV>
int launch(const float* panels, const float* temporal, const int* starts,
           const int* tile_offsets, const int* tile_blocks, int d1, int d2, int b1, int b2,
           int s_slots, int f, float* out, cudaStream_t st) {
  const int s_pad = (s_slots + 7) / 8 * 8;
  const int ldu = s_pad + ((4 - s_pad) % 32 + 32) % 32;   // ldu = 4 (mod 32)
  const size_t smem = 2 * (static_cast<size_t>(PIX) * ldu + static_cast<size_t>(s_pad) * LDV)
                      * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        recon_gather_kernel<VU, VV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (d2 + TILE - 1) / TILE;
  const int tiles = ((d1 + TILE - 1) / TILE) * tiles_x;
  const int f_tiles = (f + FT - 1) / FT;
  recon_gather_kernel<VU, VV><<<tiles * f_tiles, THREADS, smem, st>>>(
      panels, temporal, starts, tile_offsets, tile_blocks, d1, d2, b1, b2, s_slots, f,
      tiles_x, f_tiles, ldu, s_pad, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_offsets / tile_blocks: per 8 x 8 pixel tile (row-major over the
// ceil(d1 / 8) x ceil(d2 / 8) tiles) the blocks covering it, in coset
// order (ops.kernels.prepare_reconstruct). One launch on `stream`.
extern "C" int lmd_block_reconstruct(const void* panels, const void* temporal,
                                     const void* starts, const void* tile_offsets,
                                     const void* tile_blocks, int d1, int d2, int b1, int b2,
                                     int s_slots, int f, void* out, void* stream) {
  if (d1 <= 0 || d2 <= 0 || b1 <= 0 || b2 <= 0 || s_slots <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const float*>(panels);
  const auto* tv = static_cast<const float*>(temporal);
  const auto* s = static_cast<const int*>(starts);
  const auto* to = static_cast<const int*>(tile_offsets);
  const auto* tb = static_cast<const int*>(tile_blocks);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need 16-byte rows: S (or f) a multiple of 4, an aligned base
  const bool vu = s_slots % 4 == 0 && reinterpret_cast<uintptr_t>(panels) % 16 == 0;
  const bool vv = f % 4 == 0 && reinterpret_cast<uintptr_t>(temporal) % 16 == 0;
  if (vu && vv) return launch<true, true>(p, tv, s, to, tb, d1, d2, b1, b2, s_slots, f, o, st);
  if (vu) return launch<true, false>(p, tv, s, to, tb, d1, d2, b1, b2, s_slots, f, o, st);
  if (vv) return launch<false, true>(p, tv, s, to, tb, d1, d2, b1, b2, s_slots, f, o, st);
  return launch<false, false>(p, tv, s, to, tb, d1, d2, b1, b2, s_slots, f, o, st);
}
