// K4: batched cyclic-Jacobi eigendecomposition of small symmetric matrices,
// eigenvalues descending, vectors as columns.
//
// Replaces: scripts/ablate_jacobi_kernel.py, build(...).run (kernel body
// make_kernel), the Pallas form of localmd_tpu/ops/linalg.py jacobi_eigh,
// which eigh_descending uses off the CPU for every k <= 64. sym is
// (n, k, k) float32; vals (n, k) and vecs (n, k, k) float32.
//
// What bounds it on the card: latency, not bytes or flops. A matrix needs
// sweeps * (kp - 1) dependent steps -- 10 * 29 = 290 at k = 30 (odd k pads
// to even kp) -- and each step needs the previous step's whole matrix. A
// (256, 30, 30) batch moves 1.8 MB and does ~50 MFLOP; what costs is the
// chain of 290 steps. Timing variants of the first design (one CTA per
// matrix, two CTA barriers a step; kernel_variants.py k4-cta on an H100
// 80GB HBM3 at 700 W) split a step's ~1.1 us into 56% for the 2 x 2 and
// V updates (each thread's shared loads hung off loads of the pair
// table), 20% for the rotation and 24% for barriers and the loop; trig
// against the tangent form made no difference.
//
// The rotation (both kernels): the Pallas body's tangent form, the inner
// angle |theta| <= pi/4 that zeroes a_pq, with IEEE division and square
// roots (no fast math): tau = (a_qq - a_pp) / (2 a_pq), t = sgn / (|tau| +
// sqrt(1 + tau^2)) with sgn = sign(a_qq - a_pp) * sign(a_pq) (sign(0) = +1
// for the difference), c = 1 / sqrt(1 + t^2), s = t c; no rotation where
// a_pq == 0. c must land on 1 / sqrt(1 + t^2) to within an ulp: computed
// as 1.0f / sqrtf(1.0f + t * t), the square root of a value just above 1
// rounds down more often than up, c^2 + s^2 drifts ~5e-8 above 1 a
// rotation, and at k = 64 V ends 1.2-1.8e-5 off orthonormal (the plain
// twin, ops/linalg.py _rotation, takes c from t in float64).
// Pairs are those of ops.linalg._jacobi_tables (the circle method), kept
// in registers: each step moves every element but 0 one position down the
// circle, a compare and a select, no load.
//
// k <= 32 (every shape the paths launch): one CTA of four warps per
// matrix and one barrier a step (jacobi_warp_kernel below). A first
// redesign, one warp per matrix with only __syncwarp, ran 0.27-0.28 ms at
// (256, 30, 30) on the same card: a warp can only run a step's rotation
// chain and its 2 x 2 update one after the other. Here they run side by
// side: warp 0 computes step t + 1's rotations from A_t (the three entries
// each needs, rotated ahead), warps 1-2 write A_{t+1} into a second
// buffer, the last warp rotates V in registers. A step costs about the
// longest of the three, not their sum.
//
// 32 < k <= 64 (no path launches it; kept for the k <= 64 contract): one
// CTA per matrix, A and V in shared memory, one thread per pair for the
// rotation, one per 2 x 2 block and per (row, pair) of V, two barriers a
// step. Both kernels sort in the kernel: a stable descending rank per
// eigenvalue, then a scatter of the columns.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int UPDATE_WARPS = 2;   // warps writing A_{t+1}, k <= 32

// t is the plain twin's float32 arithmetic op for op (no contraction); c =
// 1 / sqrt(1 + t^2) is rsqrtf refined by one Newton step against the exact
// 1 + t^2 (its rounding error and that of t^2 carried by FMAs), which
// lands within an ulp of the twin's float64 value, without a branch.
__device__ __forceinline__ void rotation(float app, float aqq, float apq, float& c, float& s) {
  c = 1.0f;
  s = 0.0f;
  if (apq != 0.0f) {
    const float d = __fsub_rn(aqq, app);
    const float tau = __fdiv_rn(d, __fmul_rn(2.0f, apq));
    const float sgn = ((d >= 0.0f) == (apq > 0.0f)) ? 1.0f : -1.0f;
    const float t = __fdiv_rn(sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
    const float u = __fmul_rn(t, t);
    const float w = __fadd_rn(1.0f, u);
    const float ew = __fadd_rn(__fsub_rn(u, __fsub_rn(w, 1.0f)), __fmaf_rn(t, t, -u));
    const float c0 = rsqrtf(w);
    const float y = __fmul_rn(c0, c0);
    float res = __fmaf_rn(-w, y, 1.0f);
    res = __fmaf_rn(-w, __fmaf_rn(c0, c0, -y), res);
    res = __fmaf_rn(-ew, y, res);
    c = __fmaf_rn(0.5f * c0, res, c0);
    s = __fmul_rn(t, c);
  }
}

// the element at a circle position one step later: 0 stays, 1 wraps to m1
__device__ __forceinline__ int next_element(int e, int m1) {
  return e == 0 ? 0 : (e == 1 ? m1 : e - 1);
}

// the position of an element one step later: 0 stays, m1 wraps to 1
__device__ __forceinline__ int next_position(int pos, int m1) {
  return pos == 0 ? 0 : (pos == m1 ? 1 : pos + 1);
}

// stable descending rank of d[j * stride] among d[0], d[stride], ...
__device__ __forceinline__ int descending_rank(const float* d, int stride, int k, int j) {
  const float x = d[j * stride];
  int r = 0;
  for (int i = 0; i < k; ++i) {
    const float y = d[i * stride];
    r += (y > x) || (y == x && i < j);
  }
  return r;
}

// the position an element held one step earlier: 0 stays, 1 came from m1
__device__ __forceinline__ int prev_position(int pos, int m1) {
  return pos == 0 ? 0 : (pos == 1 ? m1 : pos - 1);
}

// the slot that pairs circle position pos with position m1 - pos
__device__ __forceinline__ int slot_of(int pos, int h, int m1) {
  return pos < h ? pos : m1 - pos;
}

// One pair slot's two indices. A live slot (s < kp / 2) holds the circle
// elements at positions s and kp - 1 - s and moves with the circle; a slot
// past kp / 2 holds a fixed pair of the zero padding, rotated by the
// identity, so that no lane and no round is ever idle or predicated.
struct Slot {
  int x, y;
  bool live;
  Slot() = default;
  __device__ __forceinline__ Slot(int s, int h, int kp) {
    live = s < h;
    x = live ? (s == 0 ? 0 : s) : kp + 2 * (s - h);
    y = live ? kp - 1 - s : x + 1;
  }
  __device__ __forceinline__ int p() const { return min(x, y); }
  __device__ __forceinline__ int q() const { return max(x, y); }
  __device__ __forceinline__ void advance(int m1) {
    if (live) {
      x = next_element(x, m1);
      y = next_element(y, m1);
    }
  }
};

// element e's part in its slot's rotation r = (c, s, p, q): the rotated
// row (or column) e is cf * e + sf * partner
struct Arm {
  float cf, sf;
  int partner;
};

__device__ __forceinline__ Arm arm_of(int e, float4 r) {
  const int p = __float_as_int(r.z);
  const bool is_p = e == p;
  return {r.x, is_p ? -r.y : r.y, is_p ? __float_as_int(r.w) : p};
}

// (J^T A J)[e][f] from the four entries of A at rows {e, e's partner} and
// columns {f, f's partner}: rows rotated first, then columns
__device__ __forceinline__ float rotated_entry(const float* a, int ld, int e, Arm ae, int f, Arm af) {
  const float r_f = ae.cf * a[e * ld + f] + ae.sf * a[ae.partner * ld + f];
  const float r_pf = ae.cf * a[e * ld + af.partner] + ae.sf * a[ae.partner * ld + af.partner];
  return af.cf * r_f + af.sf * r_pf;
}

// KPM = kp rounded up to 16 or 32: A's square (rows padded to KPM + 1
// words, two buffers), the KPM / 2 pair slots (two tables of (c, s, p, q))
// and the rows of V a lane holds. One CTA of four warps per matrix, one
// barrier a step; in step t:
//   warp 0 (lane l < kp / 2) looks ahead: from A_t and step t's rotations
//     it computes the three entries of A_{t+1} that slot l's rotation of
//     step t + 1 reads, and that rotation;
//   warps 1 and 2 write A_{t+1} = J_t^T A_t J_t into the other buffer, on
//     2 x 2 blocks (a lane's column pair is fixed, its row pairs every
//     GROUPS-th; every load of a warp's blocks first, then its stores);
//   warp 3 rotates V's columns, one column per lane, by shuffles.
// The rotation chain and the update run side by side instead of in turn.
// warps writing A_{t+1}: UPDATE_WARPS, or fewer where a warp would get no
// row pair (KPM = 16)
template <int KPM>
__host__ __device__ constexpr int update_warps() {
  return (KPM / 2) / (32 / (KPM / 2)) < UPDATE_WARPS ? (KPM / 2) / (32 / (KPM / 2)) : UPDATE_WARPS;
}

template <int KPM>
__global__ void __launch_bounds__(32 * (UPDATE_WARPS + 2))
jacobi_warp_kernel(const float* __restrict__ sym, int k, int kp, int sweeps,
                   float* __restrict__ vals, float* __restrict__ vecs) {
  constexpr int LD = KPM + 1;
  constexpr int SLOTS = KPM / 2;
  constexpr int GROUPS = 32 / SLOTS;         // lanes sharing a column pair
  constexpr int UW = update_warps<KPM>();
  constexpr int HALF = SLOTS / GROUPS / UW;  // row pairs per lane, update warp and step
  constexpr int NT = 32 * (UW + 2);
  const int v_warp = UW + 1;
  __shared__ float a_sh[2][KPM * LD];
  __shared__ float4 rot_sh[2][SLOTS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long m = blockIdx.x;
  const float* src = sym + m * k * k;
  for (int idx = threadIdx.x; idx < KPM * KPM; idx += NT) {
    const int i = idx / KPM;
    const int j = idx - i * KPM;
    a_sh[0][i * LD + j] = (i < k && j < k) ? src[i * k + j] : 0.0f;
  }
  const int h = kp >> 1;
  const int m1 = kp - 1;
  Slot own(lane, h, kp);
  if (warp == 0 && lane >= h && lane < SLOTS) {
    const float4 id = make_float4(1.0f, 0.0f, __int_as_float(own.p()), __int_as_float(own.q()));
    rot_sh[0][lane] = id;
    rot_sh[1][lane] = id;
  }
  __syncthreads();
  // step 0's rotations straight from A_0
  if (warp == 0 && lane < h) {
    const int p = own.p(), q = own.q();
    float c, s;
    rotation(a_sh[0][p * LD + p], a_sh[0][q * LD + q], a_sh[0][p * LD + q], c, s);
    rot_sh[0][lane] = make_float4(c, s, __int_as_float(p), __int_as_float(q));
    own.advance(m1);
  }
  // warp 0: the slots that held slot l's two elements one step earlier
  const int from_x = slot_of(prev_position(lane, m1), h, m1);
  const int from_y = slot_of(prev_position(m1 - lane, m1), h, m1);
  // warps 1, 2: this lane's column pair and row pairs
  Slot col(lane % SLOTS, h, kp);
  Slot row[HALF];
#pragma unroll
  for (int r = 0; r < HALF; ++r) row[r] = Slot(lane / SLOTS + GROUPS * (HALF * (warp - 1) + r), h, kp);
  // warp 3: this lane's V column and its circle position
  float v[KPM];
#pragma unroll
  for (int i = 0; i < KPM; ++i) v[i] = (i == lane) ? 1.0f : 0.0f;
  int pos = lane;
  __syncthreads();

  const int total = sweeps * m1;
  for (int t = 0; t < total; ++t) {
    const float* a = a_sh[t & 1];
    const float4* rot = rot_sh[t & 1];
    if (warp == 0) {
      if (lane < h && t + 1 < total) {
        const Arm ax = arm_of(own.x, rot[from_x]);
        const Arm ay = arm_of(own.y, rot[from_y]);
        const float axx = rotated_entry(a, LD, own.x, ax, own.x, ax);
        const float ayy = rotated_entry(a, LD, own.y, ay, own.y, ay);
        const float axy = rotated_entry(a, LD, own.x, ax, own.y, ay);
        const bool x_is_p = own.x < own.y;
        float c, s;
        rotation(x_is_p ? axx : ayy, x_is_p ? ayy : axx, axy, c, s);
        rot_sh[(t + 1) & 1][lane] =
            make_float4(c, s, __int_as_float(own.p()), __int_as_float(own.q()));
        own.advance(m1);
      }
    } else if (warp < v_warp) {
      float* an = a_sh[(t + 1) & 1];
      const int p2 = col.p(), q2 = col.q();
      const float4 rc = rot[lane % SLOTS];
      float x[HALF][4];
      float4 rr[HALF];
#pragma unroll
      for (int r = 0; r < HALF; ++r) {
        const int p = row[r].p(), q = row[r].q();
        x[r][0] = a[p * LD + p2];
        x[r][1] = a[p * LD + q2];
        x[r][2] = a[q * LD + p2];
        x[r][3] = a[q * LD + q2];
        rr[r] = rot[lane / SLOTS + GROUPS * (HALF * (warp - 1) + r)];
      }
#pragma unroll
      for (int r = 0; r < HALF; ++r) {
        const float c = rr[r].x, s = rr[r].y, c2 = rc.x, s2 = rc.y;
        const int p = row[r].p(), q = row[r].q();
        const float r_pp = c * x[r][0] - s * x[r][2];
        const float r_pq = c * x[r][1] - s * x[r][3];
        const float r_qp = c * x[r][2] + s * x[r][0];
        const float r_qq = c * x[r][3] + s * x[r][1];
        an[p * LD + p2] = c2 * r_pp - s2 * r_pq;
        an[p * LD + q2] = c2 * r_pq + s2 * r_pp;
        an[q * LD + p2] = c2 * r_qp - s2 * r_qq;
        an[q * LD + q2] = c2 * r_qq + s2 * r_qp;
      }
      col.advance(m1);
#pragma unroll
      for (int r = 0; r < HALF; ++r) row[r].advance(m1);
    } else {
      Arm av = {1.0f, 0.0f, lane};
      if (lane < kp) {
        av = arm_of(lane, rot[slot_of(pos, h, m1)]);
        pos = next_position(pos, m1);
      }
#pragma unroll
      for (int i = 0; i < KPM; ++i) {
        const float other = __shfl_sync(0xffffffffu, v[i], av.partner);
        v[i] = av.cf * v[i] + av.sf * other;
      }
    }
    __syncthreads();
  }

  if (warp == v_warp && lane < k) {
    const float* a = a_sh[total & 1];
    const int r = descending_rank(a, LD + 1, k, lane);
    vals[m * k + r] = a[lane * (LD + 1)];
    float* dst = vecs + m * k * k;
#pragma unroll
    for (int i = 0; i < KPM; ++i) {
      if (i < k) dst[i * k + r] = v[i];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
jacobi_cta_kernel(const float* __restrict__ sym, int k, int kp, int sweeps,
                  float* __restrict__ vals, float* __restrict__ vecs) {
  extern __shared__ float smem[];
  const int ld = kp + 1;
  const int h = kp / 2;
  float* a = smem;                       // (kp, ld)
  float* v = a + kp * ld;                // (kp, ld)
  float* cs = v + kp * ld;               // (h,)
  float* sn = cs + h;                    // (h,)
  float* diag = sn + h;                  // (kp,)
  int* pp = reinterpret_cast<int*>(diag + kp);  // (h,)
  int* qq = pp + h;                      // (h,)
  int* rank = qq + h;                    // (kp,)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long m = blockIdx.x;
  const float* src = sym + m * k * k;
  for (int idx = tid; idx < kp * kp; idx += nt) {
    const int i = idx / kp;
    const int j = idx % kp;
    a[i * ld + j] = (i < k && j < k) ? src[i * k + j] : 0.0f;
    v[i * ld + j] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int m1 = kp - 1;
  int ex = tid == 0 ? 0 : tid;
  int ey = m1 - tid;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int t = 0; t < m1; ++t) {
      if (tid < h) {
        const int p = min(ex, ey), q = max(ex, ey);
        float c, s;
        rotation(a[p * ld + p], a[q * ld + q], a[p * ld + q], c, s);
        cs[tid] = c;
        sn[tid] = s;
        pp[tid] = p;
        qq[tid] = q;
        ex = next_element(ex, m1);
        ey = next_element(ey, m1);
      }
      __syncthreads();
      // A' = J^T A J, one 2 x 2 block per thread: row p' = c row_p - s row_q,
      // row q' = c row_q + s row_p, then the same on the columns
      for (int idx = tid; idx < h * h; idx += nt) {
        const int bi = idx / h;
        const int bj = idx % h;
        const int p = pp[bi], q = qq[bi], p2 = pp[bj], q2 = qq[bj];
        const float c = cs[bi], s = sn[bi], c2 = cs[bj], s2 = sn[bj];
        const float x_pp = a[p * ld + p2], x_pq = a[p * ld + q2];
        const float x_qp = a[q * ld + p2], x_qq = a[q * ld + q2];
        const float r_pp = c * x_pp - s * x_qp;
        const float r_pq = c * x_pq - s * x_qq;
        const float r_qp = c * x_qp + s * x_pp;
        const float r_qq = c * x_qq + s * x_pq;
        a[p * ld + p2] = c2 * r_pp - s2 * r_pq;
        a[p * ld + q2] = c2 * r_pq + s2 * r_pp;
        a[q * ld + p2] = c2 * r_qp - s2 * r_qq;
        a[q * ld + q2] = c2 * r_qq + s2 * r_qp;
      }
      // V' = V J, one (row, pair) per thread
      for (int idx = tid; idx < kp * h; idx += nt) {
        const int i = idx / h;
        const int b = idx % h;
        const int p = pp[b], q = qq[b];
        const float c = cs[b], s = sn[b];
        const float vp = v[i * ld + p], vq = v[i * ld + q];
        v[i * ld + p] = c * vp - s * vq;
        v[i * ld + q] = c * vq + s * vp;
      }
      __syncthreads();
    }
  }

  if (tid < k) diag[tid] = a[tid * ld + tid];
  __syncthreads();
  if (tid < k) {
    const int r = descending_rank(diag, 1, k, tid);
    rank[tid] = r;
    vals[m * k + r] = diag[tid];
  }
  __syncthreads();
  float* dst = vecs + m * k * k;
  for (int idx = tid; idx < k * k; idx += nt) {
    const int i = idx / k;
    const int j = idx % k;
    dst[i * k + rank[j]] = v[i * ld + j];
  }
}

}  // namespace

extern "C" int lmd_jacobi_eigh(const void* sym, int n, int k, int sweeps,
                               void* vals, void* vecs, void* stream) {
  if (n <= 0 || k <= 0 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kp = k + (k % 2);
  const float* in = static_cast<const float*>(sym);
  float* ov = static_cast<float*>(vals);
  float* oe = static_cast<float*>(vecs);
  if (kp <= 32) {
    if (kp <= 16) {
      jacobi_warp_kernel<16><<<n, 32 * (update_warps<16>() + 2), 0, st>>>(in, k, kp, sweeps, ov, oe);
    } else {
      jacobi_warp_kernel<32><<<n, 32 * (update_warps<32>() + 2), 0, st>>>(in, k, kp, sweeps, ov, oe);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int h = kp / 2;
  int work = h * h > kp * h ? h * h : kp * h;
  int threads = ((work + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = (2 * static_cast<size_t>(kp) * (kp + 1) + 2 * h + kp) * sizeof(float)
                      + (2 * h + kp) * sizeof(int);
  jacobi_cta_kernel<<<n, threads, smem, st>>>(in, k, kp, sweeps, ov, oe);
  return static_cast<int>(cudaGetLastError());
}
