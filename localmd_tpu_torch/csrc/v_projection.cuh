// K2's templates (v_projection.cu has the design): the raw tile as the
// Tensor Memory Accelerator stores it, the warp-specialised 3xTF32 wgmma
// kernel over (128, BN) output tiles, and its launch over the eleven tile
// widths BN of VP_WIDTHS for one movie dtype. Each dtype instantiates them
// in a translation unit of its own (v_projection_<dtype>.cu), so the
// eleven tile widths of the seven
// dtypes compile in seven nvcc processes at once; v_projection.cu holds the
// entry points, which call the dtypes' dispatch functions declared at the
// end of this header.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time

#include "tf32_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int BM = 128;                 // t rows per CTA
constexpr int BK = 32;                  // pixels per slab
constexpr int THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int SMEM_LIMIT = 232448;      // a block's dynamic shared memory on sm_90
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;      // 128 x 40 + 256 x 232 <= 65536
constexpr int SPLITTERS = 3;            // producer warps that make the slabs' lo

// ---------------------------------------------------------------------------
// mbarriers and bulk copies, as PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// this thread's arrival, and `bytes` more that the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a (32, 128) box of the raw chunk at (pixel k, row m) into shared memory,
// swizzled as the map says; rows and pixels past the chunk read as zero
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, int k, int m,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(m)
      : "memory");
}
// `bytes` contiguous bytes into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// the raw tile
// ---------------------------------------------------------------------------

// A (128, 32) raw tile in shared memory, in the dtype's own bits
// (tf32_common.cuh's Elem), as the TMA writes it: row m at m * RB bytes, RB
// = 32 values, with the 16-byte chunks of each 128-byte span of the tile
// permuted by the span's index (CU_TENSOR_MAP_SWIZZLE_{32,64,128}B for RB
// = 32, 64, 128: address bits [4, 4 + log2(RB / 16)) ^= bits [7, 7 + ...)).
// A warp's fragment reads (rows g and g + 8 of its 16, samples tq and tq + 4
// of a k8 step) then hit distinct banks, or share a word.
template <typename T>
struct RawTile {
  using E = lmd::Elem<T>;
  using Raw = typename E::Raw;
  static constexpr int kSize = static_cast<int>(sizeof(Raw));
  static constexpr int kRowBytes = BK * kSize;
  static constexpr int kBytes = BM * kRowBytes;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSize == 4 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (kSize == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr CUtensorMapDataType kType =
      kSize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : (kSize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8);
  // byte offset of sample k of row m
  __device__ static int offset(int m, int k) {
    const int o = m * kRowBytes + k * kSize;
    return o ^ (((o >> 7) & (kRowBytes / 16 - 1)) << 4);
  }
  // sample k of row m, as an exact float
  __device__ static float sample(const unsigned char* tile, int m, int k) {
    const Raw v = *reinterpret_cast<const Raw*>(tile + offset(m, k));
    if constexpr (kSize == 4) {
      return v;
    } else {
      return E::to_f32(static_cast<uint32_t>(v));
    }
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Shared memory of one instantiation: a ring of STAGES slabs, each the raw
// tile, the projector slab as loaded (BN x 32 floats as core matrices: the
// wgmmas' hi, which they read truncated to tf32) and its lo, and the ring's
// full, ready and empty barriers. STAGES is what fits.
template <typename T, int BN>
struct Ring {
  static constexpr int kRawBytes = RawTile<T>::kBytes;
  static constexpr int kSlabFloats = BN * BK;
  static constexpr int kSlabBytes = kSlabFloats * 4;
  static constexpr int kStageBytes = kRawBytes + 2 * kSlabBytes;   // a multiple of 1024
  static constexpr int kStagesFit = (SMEM_LIMIT - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kStagesFit < 8 ? kStagesFit : 8;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 3 * kStages * 8;
  static_assert(kStages >= 3, "three slabs in flight");
  static_assert(kStageBytes % 1024 == 0, "each stage on the 128-byte swizzle's period");
};

// One work unit: a t tile, an r' tile and a pixel split, in that order of
// speed, so the CTAs working at once share the split's projector slabs and
// raw rows in L2.
struct Unit {
  int m0, n_tile, split, k0, n_slabs;
};

__device__ __forceinline__ Unit unit_of(int u, int t_tiles, int n_tiles, int d, int k_chunk) {
  Unit w;
  const int rest = u / t_tiles;
  w.m0 = (u % t_tiles) * BM;
  w.n_tile = rest % n_tiles;
  w.split = rest / n_tiles;
  w.k0 = w.split * k_chunk;
  const int k_end = w.k0 + k_chunk < d ? w.k0 + k_chunk : d;
  w.n_slabs = (k_end - w.k0 + BK - 1) / BK;
  return w;
}

// Partial products of one chunk: ws[split, t, r'] = raw[t, split's pixels]
// @ A[split's pixels, r'], over units = splits * n_tiles * t_tiles work
// units, CTA b taking units b, b + gridDim.x, ... bt holds the float32
// projector per r' tile and slab as core matrices (lmd_projector_t).
// use_tma: the raw rows and base allow the tensor map; otherwise the
// splitters load the tile through registers.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
vproj_wgmma_kernel(const __grid_constant__ CUtensorMap raw_map,
                   const typename RawTile<T>::Raw* __restrict__ raw, int t_len, int d, int use_tma,
                   const float* __restrict__ bt, int slabs_total, int r, int n_tiles,
                   int splits, int k_chunk, float* __restrict__ ws) {
  using R = Ring<T, BN>;
  using Tile = RawTile<T>;
  using Raw = typename Tile::Raw;
  constexpr int ND = BN / 2;  // accumulator registers a thread, per sum
  constexpr int S = R::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * R::kStageBytes);  // the TMA's bytes
  uint64_t* ready = full + S;                                               // lo made
  uint64_t* empty = ready + S;                                              // stage read
  auto stage_ptr = [&](int st) { return smem + st * R::kStageBytes; };
  auto hi_ptr = [&](int st) { return reinterpret_cast<float*>(stage_ptr(st) + R::kRawBytes); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t_tiles = (t_len + BM - 1) / BM;
  const int units = splits * n_tiles * t_tiles;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);            // the loader's arrival (+ the bytes)
      mbar_init(&ready[s], SPLITTERS);   // each splitter warp
      mbar_init(&empty[s], 8);           // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    int st = 0;
    uint32_t phase = 0;
    if (warp == 0) {
      // the loader: the raw tile (TMA) and the projector slab (one bulk
      // copy) of each slab, STAGES - 1 ahead of the consumers
      if (lane != 0) return;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, t_tiles, n_tiles, d, k_chunk);
        const float* proj =
            bt + (static_cast<long long>(w.n_tile) * slabs_total + w.k0 / BK) * R::kSlabFloats;
        for (int i = 0; i < w.n_slabs; ++i) {
          mbar_wait(&empty[st], phase ^ 1u);
          unsigned char* dst = stage_ptr(st);
          mbar_arrive_expect_tx(&full[st], R::kSlabBytes + (use_tma ? R::kRawBytes : 0));
          if (use_tma) tma_load_tile(dst, &raw_map, w.k0 + i * BK, w.m0, &full[st]);
          bulk_load(dst + R::kRawBytes, proj + i * R::kSlabFloats, R::kSlabBytes, &full[st]);
          if (++st == S) {
            st = 0;
            phase ^= 1u;
          }
        }
      }
      return;
    }
    // the splitters: each landed slab's lo = x - (x truncated to tf32),
    // exact, beside x, whose tf32 truncation the tensor cores read as hi
    const int sid = tid - 32;  // 0 .. 32 * SPLITTERS - 1
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, t_tiles, n_tiles, d, k_chunk);
      for (int i = 0; i < w.n_slabs; ++i) {
        mbar_wait(&full[st], phase);
        if (!use_tma) {
          // through registers: rows off the 16-byte chunk or a base off
          // 16-byte alignment; zeros past the chunk, as the TMA gives
          unsigned char* dst = stage_ptr(st);
          const int k = w.k0 + i * BK;
          for (int e = sid; e < BM * BK; e += 32 * SPLITTERS) {
            const int m = e / BK, kk = e % BK;
            const bool in = w.m0 + m < t_len && k + kk < d;
            *reinterpret_cast<Raw*>(dst + Tile::offset(m, kk)) =
                in ? raw[static_cast<long long>(w.m0 + m) * d + k + kk] : Raw(0);
          }
        }
        // four loads in flight a thread: the loop waits on shared memory's
        // latency, which the wgmmas' reads lengthen
        const float4* hi = reinterpret_cast<const float4*>(hi_ptr(st));
        float4* lo = reinterpret_cast<float4*>(hi_ptr(st) + R::kSlabFloats);
        constexpr int N4 = R::kSlabFloats / 4;
        for (int e0 = sid; e0 < N4; e0 += 4 * 32 * SPLITTERS) {
          float4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = e0 + j * 32 * SPLITTERS;
            if (e < N4) v[j] = hi[e];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = e0 + j * 32 * SPLITTERS;
            if (e < N4) {
              lo[e] = make_float4(v[j].x - lmd::tf32_truncate(v[j].x),
                                  v[j].y - lmd::tf32_truncate(v[j].y),
                                  v[j].z - lmd::tf32_truncate(v[j].z),
                                  v[j].w - lmd::tf32_truncate(v[j].w));
            }
          }
        }
        // lo (and a raw tile written here) visible to the wgmmas' proxy
        lmd::fence_proxy_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready[st]);
        if (++st == S) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int cw = warp - 4;                 // 0..7
  const int wg = cw >> 2;                  // consumer warpgroup 0 or 1
  const int row = wg * 64 + (cw & 3) * 16 + g;  // and row + 8

  // part: one slab's sums, a wgmma chain of 12 started from zero; acc: the
  // unit's sum, fp32 adds rounded to nearest (the tensor cores truncate
  // each product's fp32 result, so one chain over 4096 pixels would drift
  // by 2-3e-5)
  float acc[ND], part[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = part[i] = 0.0f;

  // the A fragments of a slab's four k8 steps: rows row and row + 8,
  // samples tq and tq + 4 of the step
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
  auto prepare = [&](int st, int s) {
    const unsigned char* tile = stage_ptr(st);
    const int k = 8 * s + tq;
    lmd::split_tf32(Tile::sample(tile, row, k), ahi[s][0], alo[s][0]);
    lmd::split_tf32(Tile::sample(tile, row + 8, k), ahi[s][1], alo[s][1]);
    lmd::split_tf32(Tile::sample(tile, row, k + 4), ahi[s][2], alo[s][2]);
    lmd::split_tf32(Tile::sample(tile, row + 8, k + 4), ahi[s][3], alo[s][3]);
  };
  auto fence_a = [&](int s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lmd::fence_operand(ahi[s][q]);
      lmd::fence_operand(alo[s][q]);
    }
  };
  // lo*hi, hi*lo, hi*hi of k8 steps s0 and s0 + 1: core matrices 2s and
  // 2s + 1 along K
  auto products = [&](const float* bh, const float* bl, int s0) {
#pragma unroll
    for (int s = s0; s < s0 + 2; ++s) {
      const uint64_t dh = lmd::smem_desc(bh + 2 * s * 32, 128, 1024);
      const uint64_t dl = lmd::smem_desc(bl + 2 * s * 32, 128, 1024);
      lmd::Wgmma<BN>::run(part, alo[s], dh, s > 0 ? 1 : 0);
      lmd::Wgmma<BN>::run(part, ahi[s], dl, 1);
      lmd::Wgmma<BN>::run(part, ahi[s], dh, 1);
    }
  };
  int st = 0;
  uint32_t phase = 0;
  // a raw tile is there once the TMA's bytes are, or, loaded through
  // registers, once the splitters are done with its stage
  auto wait_raw = [&](int st, uint32_t phase) {
    mbar_wait(&full[st], phase);
    if (!use_tma) mbar_wait(&ready[st], phase);
  };
  wait_raw(0, 0);
#pragma unroll
  for (int s = 0; s < BK / 8; ++s) prepare(0, s);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, t_tiles, n_tiles, d, k_chunk);
    for (int i = 0; i < w.n_slabs; ++i) {
      const float* bh = hi_ptr(st);
      const float* bl = bh + R::kSlabFloats;
      const bool more = i + 1 < w.n_slabs || u + static_cast<int>(gridDim.x) < units;
      mbar_wait(&ready[st], phase);  // its lo made: its hi landed before (full)
#pragma unroll
      for (int q = 0; q < ND; ++q) lmd::fence_operand(part[q]);
      lmd::wgmma_fence();
      products(bh, bl, 0);
      lmd::wgmma_commit();
      products(bh, bl, 2);
      lmd::wgmma_commit();
      const int nst = st + 1 == S ? 0 : st + 1;
      const uint32_t nphase = nst == 0 ? phase ^ 1u : phase;
      if (more) wait_raw(nst, nphase);
      // steps 0 and 1 retired: their A registers take the next slab's
      // while steps 2 and 3 run
      lmd::wgmma_wait<1>();
      fence_a(0);
      fence_a(1);
      if (more) {
        prepare(nst, 0);
        prepare(nst, 1);
      }
      lmd::wgmma_wait<0>();
      fence_a(2);
      fence_a(3);
#pragma unroll
      for (int q = 0; q < ND; ++q) lmd::fence_operand(part[q]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with stage st
      if (more) {
        prepare(nst, 2);
        prepare(nst, 3);
      }
#pragma unroll
      for (int q = 0; q < ND; ++q) acc[q] += part[q];
      st = nst;
      phase = nphase;
    }
    // accumulator layout: register 4j + q holds row (q < 2) or row + 8,
    // column 8j + 2tq + (q & 1)
    float* dst = ws + static_cast<long long>(w.split) * t_len * r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = w.m0 + row + half * 8;
      if (m < t_len) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = w.n_tile * BN + j * 8 + 2 * tq;
          float* p = dst + static_cast<long long>(m) * r + col;
          if (col < r) p[0] = acc[4 * j + 2 * half];
          if (col + 1 < r) p[1] = acc[4 * j + 2 * half + 1];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ND; ++q) acc[q] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T, int BN>
cudaError_t launch_partial(const void* raw, int t_len, int d, const float* bt, int d_pad, int r,
                           int n_tiles, int splits, int k_chunk, int ctas, float* ws,
                           cudaStream_t st) {
  using R = Ring<T, BN>;
  using Tile = RawTile<T>;
  auto kern = vproj_wgmma_kernel<T, BN>;
  // the tensor map needs 16-byte rows and a 16-byte aligned base
  CUtensorMap map{};
  const bool use_tma = (static_cast<long long>(d) * Tile::kSize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  if (use_tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t_len)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * Tile::kSize};
    const cuuint32_t box[2] = {BK, BM};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, Tile::kType, 2, const_cast<void*>(raw), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, Tile::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  // persistent: one CTA an SM, each with a unit at least
  const long long units = static_cast<long long>(splits) * n_tiles * ((t_len + BM - 1) / BM);
  if (ctas < 1 || ctas > units) return cudaErrorInvalidValue;
  kern<<<ctas, THREADS, R::kSmem, st>>>(map, static_cast<const typename Tile::Raw*>(raw), t_len,
                                        d, use_tma ? 1 : 0, bt, d_pad / BK, r, n_tiles, splits,
                                        k_chunk, ws);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bn, const void* raw, int t_len, int d, const float* bt, int d_pad, int r,
                     int n_tiles, int splits, int k_chunk, int ctas, float* ws, cudaStream_t st) {
#define LMD_VP_CASE(N)                                                                   \
  case N:                                                                                \
    return launch_partial<T, N>(raw, t_len, d, bt, d_pad, r, n_tiles, splits, k_chunk,   \
                                ctas, ws, st);
  // VP_WIDTHS (ops/kernels.py): steps of 16 to 160, then 168 and 176, so
  // the widest r' tiles pad by under 8 columns
  switch (bn) {
    LMD_VP_CASE(32) LMD_VP_CASE(48) LMD_VP_CASE(64) LMD_VP_CASE(80)
    LMD_VP_CASE(96) LMD_VP_CASE(112) LMD_VP_CASE(128) LMD_VP_CASE(144)
    LMD_VP_CASE(160) LMD_VP_CASE(168) LMD_VP_CASE(176)
    default:
      return cudaErrorInvalidValue;
  }
#undef LMD_VP_CASE
}

}  // namespace

// The arguments of a dtype's dispatch function (dispatch<T> above).
#define LMD_VP_DISPATCH_PARAMS                                                       \
  int bn, const void* raw, int t_len, int d, const float* bt, int d_pad, int r,     \
      int n_tiles, int splits, int k_chunk, int ctas, float* ws, cudaStream_t st

namespace lmd_vp {

// The partial products of one chunk for raw of the named dtype, at tile
// width bn, on ctas persistent CTAs; v_projection_<dtype>.cu.
cudaError_t dispatch_float32(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_uint16(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_int16(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_uint8(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_int8(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_float16(LMD_VP_DISPATCH_PARAMS);
cudaError_t dispatch_bfloat16(LMD_VP_DISPATCH_PARAMS);

}  // namespace lmd_vp

// The body of dispatch_<NAME> for raw of type T, in NAME's translation unit.
#define LMD_VP_DEFINE_DISPATCH(NAME, T)                                                    \
  cudaError_t lmd_vp::dispatch_##NAME(LMD_VP_DISPATCH_PARAMS) {                            \
    return dispatch<T>(bn, raw, t_len, d, bt, d_pad, r, n_tiles, splits, k_chunk, ctas, ws, \
                       st);                                                                 \
  }
