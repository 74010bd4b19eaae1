// Shared pieces of the three 3xTF32 tensor-core kernels (K1 movie_stats.cu,
// K2 v_projection.cu, K3 block_reconstruct.cu): the fp32 -> (hi, lo) tf32
// split, exact uint16 -> float, cp.async with zero fill, and the swizzle of
// K2's float32 raw tile.
// The warpgroup multiply itself is in wgmma_tf32.cuh.
//
// 3xTF32. Hopper's tensor cores have no IEEE-fp32 mode; TF32 keeps 10
// mantissa bits (~3 decimal digits), which fails the port's bars on inputs
// with an offset. Each operand is split as x = hi + lo: hi = x rounded to
// tf32, to nearest with ties away from zero (cvt.rna.tf32.f32's rounding,
// done as one integer add and one mask), lo = x - hi (exact in fp32; the
// tensor core reads its top 10 mantissa bits, truncating the rest, an error
// below 2^-21 of x). A product is taken as lo*hi + hi*lo + hi*hi, the two
// small terms first, into fp32 accumulators; the dropped lo*lo term is
// ~2^-22 relative. A uint16 value splits exactly: its 16 significant bits
// fit in hi's 11 plus lo's 11.
//
// Fragment order. A k8 step sums over k = 0..7; a thread (group g =
// lane / 4, t = lane % 4) supplies A at k = t and t + 4. Both kernels feed
// it the pair of adjacent samples 2t, 2t + 1 of the step instead, and
// store their shared-memory B operand's k in the same order (0, 2, 4, 6,
// 1, 3, 5, 7: a permutation of k applied to both operands, so the sum is
// the same), which lets a thread read its A pair with one 64-bit (float32)
// or 32-bit (uint16) shared load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lmd {

// x = hi + lo; hi rounded to tf32 (10 explicit mantissa bits), to nearest
// with ties away from zero; finite inputs
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// exact uint16 -> float with one OR and one FADD (2^23 + u - 2^23)
__device__ __forceinline__ float u16_to_f32(uint32_t u) {
  return __uint_as_float(0x4b000000u | u) - 8388608.0f;
}

// 16-byte global -> shared copy; copies nothing and zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// 4-byte global -> shared copy (through L1); zero-fills when !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K2's float32 raw tile (rows of 32 samples) is stored without padding,
// its eight 16-byte chunks permuted per row so that the 64-bit fragment
// loads of one k8 step hit 32 distinct banks: chunk c of row m lands at
// chunk swz_chunk(m, c). Rows m and m + 1..3 then hold the same k8 step in
// different 8-word bank groups.
__device__ __forceinline__ int swz_chunk(int m, int c) {
  return ((((c >> 1) ^ m) & 3) << 1) | (c & 1);
}

// the pair (k8 step s, samples 2t, 2t + 1) of row m, as a float offset
__device__ __forceinline__ int swz_pair(int m, int s, int t) {
  return m * 32 + (((s ^ m) & 3) << 3) + 2 * t;
}

}  // namespace lmd
