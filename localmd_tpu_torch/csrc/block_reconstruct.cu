// K3: blocked reconstruction, out[d1, d2, f] += sum_b U_b @ V_b placed at
// each block's start.
//
// Replaces: localmd_tpu/ops/pallas_kernels.py, fused_block_reconstruct
// (body _recon_kernel; recon_window_geometry and panels_f_to_c). panels are
// (N, b1*b2, S) with C-order local rows (i * b2 + j), temporal (N, S, f),
// starts (N, 2) int32; out is the (d1, d2, f) float32 canvas.
//
// What bounds it on the card: the overlap-add moves the canvas through HBM
// once per coset (read-modify-write; each pixel lies in up to 4 blocks of
// the half-overlap grid) -- 8 * d1 * d2 * f * (cosets covering it) bytes --
// against 2 * N * b1 * b2 * S * f flops (2e10 at 961 blocks of 32 x 32,
// S = 20, f = 512). Both are small; the fp32 FMAs on the CUDA cores and the
// canvas traffic are of the same order.
//
// Design: one launch per disjoint coset of BlockGrid.cosets() (at most
// (k_c + 1)^2 launches). Blocks within a coset never overlap, so each CTA
// owns its block's rectangle outright: no atomics, and the launch order fixes
// the order of the sums (deterministic). A CTA handles one block and a
// 64-frame tile: the block's (S, 64) temporal slice sits in shared memory,
// each thread owns one frame and walks the block's pixels, reading panel
// rows as warp-wide broadcasts, and adds U_b @ V_b into its own pixels of
// the canvas (writes coalesce along f). None of the TPU's 8-aligned widened
// windows, panel pre-scatter or sequential grid is needed: those existed only
// because Mosaic cannot DMA unaligned rectangles.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 64;        // frames per CTA
constexpr int THREADS = 256;  // 4 pixel lanes x 64 frames

__global__ void __launch_bounds__(THREADS)
recon_coset_kernel(const float* __restrict__ panels,    // (N, p, S)
                   const float* __restrict__ temporal,  // (N, S, f)
                   const int* __restrict__ starts,      // (N, 2)
                   const int* __restrict__ ids,         // this coset's blocks
                   int p, int s_slots, int f, int b2, int d2,
                   float* __restrict__ out) {           // (d1, d2, f)
  extern __shared__ float tsh[];                        // (S, FT)
  const int b = ids[blockIdx.x];
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const float* tb = temporal + static_cast<long long>(b) * s_slots * f;
  for (int idx = tid; idx < s_slots * FT; idx += THREADS) {
    const int s = idx / FT;
    const int ff = f0 + idx % FT;
    tsh[idx] = ff < f ? tb[static_cast<long long>(s) * f + ff] : 0.0f;
  }
  __syncthreads();

  const int fl = tid % FT;
  const int fi = f0 + fl;
  if (fi >= f) return;
  const int k0 = starts[2 * b];
  const int j0 = starts[2 * b + 1];
  const float* pan = panels + static_cast<long long>(b) * p * s_slots;
  for (int q = tid / FT; q < p; q += THREADS / FT) {
    const float* row = pan + static_cast<long long>(q) * s_slots;
    float acc = 0.0f;
    for (int s = 0; s < s_slots; ++s) acc = fmaf(__ldg(row + s), tsh[s * FT + fl], acc);
    const int i = q / b2;
    const int j = q % b2;
    const long long o = (static_cast<long long>(k0 + i) * d2 + (j0 + j)) * f + fi;
    out[o] += acc;
  }
}

}  // namespace

// ids: all cosets' block ids concatenated (device); coset_offsets: host
// array of n_cosets + 1 offsets into ids. Launches one grid per coset on
// `stream`, in order.
extern "C" int lmd_block_reconstruct(const void* panels, const void* temporal,
                                     const void* starts, const void* ids,
                                     const int* coset_offsets, int n_cosets,
                                     int p, int s_slots, int f, int b2, int d2,
                                     void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(s_slots) * FT * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        recon_coset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int f_tiles = (f + FT - 1) / FT;
  for (int c = 0; c < n_cosets; ++c) {
    const int n = coset_offsets[c + 1] - coset_offsets[c];
    if (n <= 0) continue;
    const dim3 grid(n, f_tiles);
    recon_coset_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(panels), static_cast<const float*>(temporal),
        static_cast<const int*>(starts),
        static_cast<const int*>(ids) + coset_offsets[c], p, s_slots, f, b2, d2,
        static_cast<float*>(out));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
