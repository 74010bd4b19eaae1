// Shared pieces of the three 3xTF32 tensor-core kernels (K1 movie_stats.cu,
// K2 v_projection.cu, K3 block_reconstruct.cu): the fp32 -> (hi, lo) tf32
// split, the movie dtypes K1 and K2 read with their exact conversions to
// float (Elem) and cp.async with zero fill.
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
// ~2^-22 relative. A 16-bit integer splits exactly: its 16 significant
// bits fit in hi's 11 plus lo's 11. An 8-bit integer, a float16 (11
// significant bits) and a bfloat16 (8) fit in hi alone, with lo = 0; the
// kernels still issue the three products, so each dtype's result is the
// float32 kernel's on the same values.
//
// Fragment order. A k8 step sums over k = 0..7; a thread (group g =
// lane / 4, t = lane % 4) supplies A at k = t and t + 4. K1 feeds it the
// pair of adjacent samples 2t, 2t + 1 of the step instead, and stores its
// shared-memory B operand's k in the same order (0, 2, 4, 6, 1, 3, 5, 7: a
// permutation of k applied to both operands, so the sum is the same),
// which lets a thread read its A pair with one 64-bit (float32) or 32-bit
// (uint16) shared load. K2 takes samples t and t + 4 as they are: its
// tile is laid out by the TMA's swizzle, under which that order is free
// of bank conflicts (v_projection.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lmd {

// x = hi + lo; hi rounded to tf32 (10 explicit mantissa bits), to nearest
// with ties away from zero; finite inputs
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x with its low 13 mantissa bits cleared: the tf32 value a tensor core
// reads from x's register or shared-memory word
__device__ __forceinline__ float tf32_truncate(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// exact uint16 (or uint8) -> float with one OR and one FADD (2^23 + u - 2^23)
__device__ __forceinline__ float u16_to_f32(uint32_t u) {
  return __uint_as_float(0x4b000000u | u) - 8388608.0f;
}

// exact int16 (or int8, sign-extended or not) -> float: the sign bit
// flipped gives v + 2^15 in [0, 65535], then (2^23 + v + 2^15) - (2^23 + 2^15)
__device__ __forceinline__ float i16_to_f32(uint32_t bits) {
  return __uint_as_float(0x4b000000u | ((bits ^ 0x8000u) & 0xffffu)) - 8421376.0f;
}
__device__ __forceinline__ float i8_to_f32(uint32_t bits) {
  return __uint_as_float(0x4b000000u | ((bits ^ 0x80u) & 0xffu)) - 8388736.0f;
}

// the integers back from those floats, without a conversion unit: v + 2^23
// (+ 2^15 for signed values, which covers int8 too) stays in [2^23, 2^24),
// where a float's low mantissa bits are the integer
__device__ __forceinline__ long long unsigned_of_f32(float v) {
  return static_cast<long long>(__float_as_uint(v + 8388608.0f) - 0x4b000000u);
}
__device__ __forceinline__ long long signed_of_f32(float v) {
  return static_cast<int>(__float_as_uint(v + 8421376.0f) - 0x4b008000u);
}

// The movie dtypes K1 and K2 read. Raw is what a tile stores (the type's
// bits); to_f32 converts those bits to float exactly; Acc is K1's mean
// accumulator: double for the float types, int64 for the integers (exact
// at any chunk length), and to_acc takes a converted value there.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Raw = float;
  using Acc = double;
  __device__ static float to_f32(float x) { return x; }
  __device__ static Acc to_acc(float v) { return static_cast<double>(v); }
};

template <>
struct Elem<uint16_t> {
  using Raw = uint16_t;
  using Acc = long long;
  __device__ static float to_f32(uint32_t b) { return u16_to_f32(b & 0xffffu); }
  __device__ static Acc to_acc(float v) { return unsigned_of_f32(v); }
};

template <>
struct Elem<int16_t> {
  using Raw = uint16_t;
  using Acc = long long;
  __device__ static float to_f32(uint32_t b) { return i16_to_f32(b); }
  __device__ static Acc to_acc(float v) { return signed_of_f32(v); }
};

template <>
struct Elem<uint8_t> {
  using Raw = uint8_t;
  using Acc = long long;
  __device__ static float to_f32(uint32_t b) { return u16_to_f32(b & 0xffu); }
  __device__ static Acc to_acc(float v) { return unsigned_of_f32(v); }
};

template <>
struct Elem<int8_t> {
  using Raw = uint8_t;
  using Acc = long long;
  __device__ static float to_f32(uint32_t b) { return i8_to_f32(b); }
  __device__ static Acc to_acc(float v) { return signed_of_f32(v); }
};

template <>
struct Elem<__half> {
  using Raw = uint16_t;
  using Acc = double;
  __device__ static float to_f32(uint32_t b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  __device__ static Acc to_acc(float v) { return static_cast<double>(v); }
};

template <>
struct Elem<__nv_bfloat16> {
  using Raw = uint16_t;
  using Acc = double;
  __device__ static float to_f32(uint32_t b) { return __uint_as_float(b << 16); }
  __device__ static Acc to_acc(float v) { return static_cast<double>(v); }
};

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

}  // namespace lmd
