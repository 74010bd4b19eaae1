// K4: batched cyclic-Jacobi eigendecomposition of small symmetric matrices,
// eigenvalues descending, vectors as columns.
//
// Replaces: scripts/ablate_jacobi_kernel.py, build(...).run (kernel body
// make_kernel), the Pallas form of localmd_tpu/ops/linalg.py jacobi_eigh,
// which eigh_descending uses off the CPU for every k <= 64. sym is
// (n, k, k) float32; vals (n, k) and vecs (n, k, k) float32.
//
// What bounds it on the card: latency, not bytes or flops. A matrix needs
// sweeps * (k - 1) dependent steps -- 10 * 29 = 290 at k = 30 (odd k pads
// to even) -- and each step needs the previous step's whole matrix. A
// (256, 30, 30) batch moves 1.8 MB and does ~50 MFLOP; what costs is the
// chain of 290 steps, each an atan2f + sincosf and a round of shared-memory
// updates between two barriers.
//
// Design: one CTA per matrix; A and V live in shared memory (rows padded by
// one word) for the whole run. Per step, phase 1: one thread per disjoint
// pair (p, q) of the round-robin schedule (the host table of
// ops.linalg._jacobi_tables, so the pairs are the plain twin's) computes the
// inner angle theta = 0.5 atan2(2 a_pq sign(d), |d|), d = a_qq - a_pp,
// |theta| <= pi/4, with the precise atan2f/sincosf (no fast math), and no
// rotation where a_pq == 0. That is the rotation K4's Pallas body takes;
// linalg.py's 0.5 atan2(2 a_pq, d) takes the outer angle when d < 0 and
// stalls on clustered spectra. Phase 2: A' = J^T A J as one thread per 2 x 2
// block (rows {p, q} x columns {p', q'}) of each pair of pairs -- the
// block's four new values depend only on its four old values; rows are
// rotated first, then columns, as the plain twin does -- and V' = V J as one
// thread per (row, pair). Nothing two threads write overlaps, so two
// barriers a step suffice, and the CTA is sized so that phase 2 is one pass
// (up to 1024 threads): a step costs about one rotation's latency. The
// Pallas one-hot-matmul form (a Mosaic workaround whose V drifts ~1e-4 off
// orthonormal) is not carried over. The descending sort is done in the
// kernel: a stable rank per eigenvalue, then a scatter of the columns.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS)
jacobi_eigh_kernel(const float* __restrict__ sym,   // (n, k, k)
                   int k, int kp,                  // k, and k padded to even
                   const int* __restrict__ sched,  // (kp - 1, kp / 2, 2)
                   int sweeps,
                   float* __restrict__ vals,       // (n, k)
                   float* __restrict__ vecs) {     // (n, k, k)
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

  const int n_steps = kp - 1;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int t = 0; t < n_steps; ++t) {
      if (tid < h) {
        const int p = __ldg(sched + (t * h + tid) * 2);
        const int q = __ldg(sched + (t * h + tid) * 2 + 1);
        const float apq = a[p * ld + q];
        float c = 1.0f, s = 0.0f;
        if (apq != 0.0f) {
          // the inner angle, |theta| <= pi/4
          const float d = a[q * ld + q] - a[p * ld + p];
          const float theta = 0.5f * atan2f(d >= 0.0f ? 2.0f * apq : -2.0f * apq, fabsf(d));
          sincosf(theta, &s, &c);
        }
        cs[tid] = c;
        sn[tid] = s;
        pp[tid] = p;
        qq[tid] = q;
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

  // descending order, stable on ties: the rank of eigenvalue i counts the
  // larger ones and the equal ones before it
  if (tid < k) diag[tid] = a[tid * ld + tid];
  __syncthreads();
  if (tid < k) {
    const float x = diag[tid];
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const float y = diag[j];
      r += (y > x) || (y == x && j < tid);
    }
    rank[tid] = r;
    vals[m * k + r] = x;
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

// sched: the (kp - 1, kp / 2, 2) int32 schedule on the device, kp = k + k % 2.
extern "C" int lmd_jacobi_eigh(const void* sym, int n, int k, const void* sched, int sweeps,
                               void* vals, void* vecs, void* stream) {
  if (n <= 0 || k <= 0 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = k + (k % 2);
  const int h = kp / 2;
  int work = h * h > kp * h ? h * h : kp * h;
  if (work < k) work = k;
  int threads = ((work + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = (2 * static_cast<size_t>(kp) * (kp + 1) + 2 * h + kp) * sizeof(float)
                      + (2 * h + kp) * sizeof(int);
  jacobi_eigh_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sym), k, kp, static_cast<const int*>(sched), sweeps,
      static_cast<float*>(vals), static_cast<float*>(vecs));
  return static_cast<int>(cudaGetLastError());
}
