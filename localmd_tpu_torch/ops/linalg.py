"""Linear-algebra primitives for PMD (counterpart of ops/linalg.py).

Batch-first like the JAX package: every routine accepts a leading ``...``
batch. Small SVDs go through a symmetric Gram + ``eigh_descending``, which
routes as the JAX package does (ops/linalg.py:208-221): on the card every
eigh with k <= 64 goes to K4, the batched cyclic-Jacobi kernel
(``ops.kernels.jacobi_eigh``), larger ones to cuSOLVER, and every CPU eigh
to numpy's LAPACK. ``jacobi_eigh_plain`` is K4's
plain twin. Random sketches are drawn through ``utils.random.normal`` so
tests can inject the JAX package's draws.

Under the JAX module's names, this module also gives ``sketch_override``
(the draw seam, ``utils.random``) and ``jacobi_eigh``, which is K4's route
``ops.jacobi_eigh`` (the kernel on a card tensor, its plain twin on a CPU
tensor), looked up on first use because ``ops.kernels`` imports this
module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from localmd_tpu_torch.utils.random import make_generator, normal, sketch_override  # noqa: F401

DEFAULT_OVERSAMPLES = 10
JACOBI_MAX_DIM = 64


def __getattr__(name):
    if name == "jacobi_eigh":
        from localmd_tpu_torch.ops.kernels import jacobi_eigh

        return jacobi_eigh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def cholesky_qr2(y: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of ``y`` (..., d, k) by two rounds of
    CholeskyQR with the JAX package's trace ridge (ops/linalg.py:68-94).

    ``cholesky_ex`` does not raise on a non-PD Gram, as JAX's cholesky
    does not."""

    def _one_pass(a):
        gram = a.transpose(-1, -2) @ a
        k = gram.shape[-1]
        trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(dim=-1)
        ridge = (trace * 1e-6 + 1e-30)[..., None, None] * torch.eye(
            k, dtype=a.dtype, device=a.device
        )
        chol, _ = torch.linalg.cholesky_ex(gram + ridge)
        # q = a @ inv(chol)^T: solve X @ chol^T = a
        return torch.linalg.solve_triangular(
            chol.transpose(-1, -2), a, upper=True, left=False
        )

    return _one_pass(_one_pass(y))


def jacobi_sweeps(k: int) -> int:
    """The JAX package's fixed sweep count (ops/linalg.py:217)."""
    return 10 if k <= 32 else 12


def _jacobi_tables(k: int) -> np.ndarray:
    """Round-robin (circle method) schedule for even ``k``: (k - 1, k/2, 2)
    int32 pairs (p < q), every unordered pair once per sweep, the k/2 pairs
    of a step disjoint (ops/linalg.py:111-144)."""
    arr = list(range(k))
    steps = []
    for _ in range(k - 1):
        steps.append([
            (min(arr[i], arr[k - 1 - i]), max(arr[i], arr[k - 1 - i])) for i in range(k // 2)
        ])
        arr = [arr[0], arr[-1]] + arr[1:-1]
    return np.array(steps, dtype=np.int32).reshape(k - 1, k // 2, 2)


def _rotation(app: torch.Tensor, aqq: torch.Tensor, apq: torch.Tensor):
    """(c, s) of the inner Jacobi rotation (|theta| <= pi/4) that zeroes
    a_pq, in the tangent form of K4's Pallas body
    (scripts/ablate_jacobi_kernel.py:73-79) and of K4: tau = d / (2 a_pq)
    with d = a_qq - a_pp, t = sgn / (|tau| + sqrt(1 + tau^2)), c = 1 /
    sqrt(1 + t^2), s = t c, where sgn = sign(d) sign(a_pq) with sign(0) = 1
    for d; no rotation where a_pq == 0. That is theta = 0.5 atan2(2 a_pq
    sign(d), |d|). The JAX package's ``0.5 atan2(2 a_pq, d)`` takes the
    outer angle whenever d < 0.

    t is float32 arithmetic; c is computed from t in float64 and rounded
    once. In float32, sqrt(1 + t^2) of a value just above 1 rounds down
    more often than up, which leaves c^2 + s^2 about 5e-8 above 1 on
    average; over the 756 rotations a column sees at k = 64 that drift put
    V 1.2-1.8e-5 off orthonormal."""
    d = aqq - app
    nz = apq != 0.0
    tau = d / (2.0 * torch.where(nz, apq, torch.ones_like(apq)))
    sgn = torch.where((d >= 0.0) == (apq > 0.0), 1.0, -1.0)
    t = torch.where(nz, sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau)), 0.0)
    c = (1.0 / torch.sqrt(1.0 + t.double() ** 2)).to(t.dtype)
    return c, t * c


def jacobi_eigh_plain(sym: torch.Tensor, sweeps: Optional[int] = None):
    """Plain twin of K4: batched cyclic-Jacobi eigh of symmetric (..., k, k)
    float32, eigenvalues descending (ops/linalg.py:147-205).

    Each step rotates the k/2 disjoint pairs of the schedule by the inner
    angle of ``_rotation``: rows first, then columns, then the columns of
    V. Odd k is zero-padded; the padded dimension never mixes. Returns
    ((..., k), (..., k, k))."""
    k0 = sym.shape[-1]
    if sweeps is None:
        sweeps = jacobi_sweeps(k0)
    k = k0 + (k0 % 2)
    a = torch.nn.functional.pad(sym, (0, k - k0, 0, k - k0)) if k != k0 else sym.clone()
    v = torch.eye(k, dtype=sym.dtype, device=sym.device).expand(a.shape).clone()
    sched = _jacobi_tables(k)
    partner = np.empty((k - 1, k), np.int64)
    slot = np.empty((k - 1, k), np.int64)
    sign = np.empty((k - 1, k), np.float32)
    for t, pairs in enumerate(sched):
        for i, (p, q) in enumerate(pairs):
            partner[t, p], partner[t, q] = q, p
            slot[t, p] = slot[t, q] = i
            sign[t, p], sign[t, q] = -1.0, 1.0   # row p mixes in -s row q
    dev = sym.device
    sched_t = torch.as_tensor(sched, dtype=torch.long, device=dev)
    partner_t = torch.as_tensor(partner, device=dev)
    slot_t = torch.as_tensor(slot, device=dev)
    sign_t = torch.as_tensor(sign, device=dev)
    for _ in range(sweeps):
        for t in range(k - 1):
            pi, qi = sched_t[t, :, 0], sched_t[t, :, 1]
            apq = a[..., pi, qi]
            c, s = _rotation(a[..., pi, pi], a[..., qi, qi], apq)
            cf = c[..., slot_t[t]]                                   # (..., k)
            sf = s[..., slot_t[t]] * sign_t[t]
            pr = partner_t[t]
            a = cf[..., :, None] * a + sf[..., :, None] * a[..., pr, :]
            a = cf[..., None, :] * a + sf[..., None, :] * a[..., :, pr]
            v = cf[..., None, :] * v + sf[..., None, :] * v[..., :, pr]
    vals = torch.diagonal(a, dim1=-2, dim2=-1)[..., :k0]
    v = v[..., :k0, :k0]
    order = torch.argsort(-vals, dim=-1, stable=True)
    vals = torch.take_along_dim(vals, order, dim=-1)
    v = torch.take_along_dim(v, order[..., None, :], dim=-1)
    return vals, v


def uses_jacobi(device, k: int) -> bool:
    """Whether ``eigh_descending`` sends a (..., k, k) matrix on ``device``
    to K4: on the card with k <= 64, as the JAX package sends small eighs
    off the CPU to its Jacobi (ops/linalg.py:216)."""
    return torch.device(device).type == "cuda" and k <= JACOBI_MAX_DIM


def eigh_descending(sym: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., k, k), eigenvalues descending.

    On the card with k <= 64: K4 (``kernels.jacobi_eigh``); above, cuSOLVER
    (``torch.linalg.eigh``). On the CPU: numpy's LAPACK (``np.linalg.eigh``
    in float32), a LAPACK build like the one the JAX package's CPU path
    calls. torch's MKL ``ssyevd`` fails to converge on some Grams with many
    repeated eigenvalues (the factorized SVD's on a white 64x64x2000 movie
    with 32x32 blocks) where numpy's converges."""
    if uses_jacobi(sym.device, sym.shape[-1]):
        from localmd_tpu_torch.ops import kernels

        lead = sym.shape[:-2]
        k = sym.shape[-1]
        vals, vecs = kernels.jacobi_eigh(sym.reshape(-1, k, k).contiguous())
        return vals.reshape(*lead, k), vecs.reshape(*lead, k, k)
    if sym.device.type == "cpu":
        vals_np, vecs_np = np.linalg.eigh(sym.detach().numpy())
        vals, vecs = torch.from_numpy(vals_np), torch.from_numpy(vecs_np)
    else:
        vals, vecs = torch.linalg.eigh(sym)
    return vals.flip(-1), vecs.flip(-1)


def subspace_eigh(
    sym: torch.Tensor, k_sketch: int, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k_sketch`` eigenpairs of a PSD (m, m) matrix whose rank is at
    most ``k_sketch``, by randomized range capture (ops/linalg.py:224-267):
    Y = sym @ Om, Householder Q of Y, eigh of Q^T sym Q, lift back.

    The sketch is seeded from the shape alone (like the JAX package's
    ``PRNGKey(m * 1000003 + k_sketch)``) unless a generator is given.
    Returns (vals (k_sketch,) descending, vecs (m, k_sketch))."""
    m = sym.shape[-1]
    if generator is None:
        generator = make_generator(m * 1000003 + k_sketch, sym.device)
    om = normal((m, k_sketch), generator, sym.device)
    q, _ = torch.linalg.qr(sym @ om)
    small = q.transpose(-1, -2) @ (sym @ q)
    small = 0.5 * (small + small.transpose(-1, -2))
    vals, vecs = eigh_descending(small)
    return vals, q @ vecs


def svd_gram_left(data: torch.Tensor):
    """SVD of (..., m, n) via the left Gram ``data @ data.T`` (m <= n).
    Returns (U (...,m,m), s (...,m), Vt (...,m,n)); zero singular values
    give zero rows of Vt."""
    gram = data @ data.transpose(-1, -2)
    vals, vecs = eigh_descending(gram)
    s = torch.sqrt(torch.clamp(vals, min=0.0))
    divisor = torch.where(s == 0, torch.ones_like(s), s)
    vt = (vecs.transpose(-1, -2) @ data) / divisor[..., :, None]
    return vecs, s, vt


def svd_gram_right(data: torch.Tensor):
    """SVD of (..., m, n) via the right Gram ``data.T @ data`` (n <= m).
    Returns (U (...,m,n), s (...,n), Vt (...,n,n))."""
    gram = data.transpose(-1, -2) @ data
    vals, vecs = eigh_descending(gram)
    s = torch.sqrt(torch.clamp(vals, min=0.0))
    divisor = torch.where(s == 0, torch.ones_like(s), s)
    u = data @ (vecs / divisor[..., None, :])
    return u, s, vecs.transpose(-1, -2)


def svd_small(data: torch.Tensor):
    """SVD choosing the cheaper Gram side."""
    m, n = data.shape[-2], data.shape[-1]
    return svd_gram_left(data) if m <= n else svd_gram_right(data)


def _rsvd_core(matrix: torch.Tensor, sketch: torch.Tensor, rank: int, power_iters: int = 0):
    """Sketch-project-solve chain shared by the single and batched rSVD."""
    q = cholesky_qr2(matrix @ sketch)                          # (..., d, k)
    for _ in range(power_iters):
        z = matrix.transpose(-1, -2) @ q
        q = cholesky_qr2(matrix @ z)
    b = q.transpose(-1, -2) @ matrix                           # (..., k, t)
    u_b, s, vt = svd_gram_left(b)
    u = q @ u_b
    return u[..., :rank], s[..., :rank], vt[..., :rank, :]


def truncated_random_svd(
    matrix: torch.Tensor,
    rank: int,
    generator: Optional[torch.Generator] = None,
    num_oversamples: int = DEFAULT_OVERSAMPLES,
    power_iters: int = 0,
):
    """Randomized truncated SVD of (..., d, t) (ops/linalg.py:308-344); one
    (t, rank + oversamples) sketch shared by the batch."""
    t = matrix.shape[-1]
    k = rank + num_oversamples
    sketch = normal((t, k), generator, matrix.device)
    return _rsvd_core(matrix, sketch, rank, power_iters)


def batched_truncated_random_svd(
    matrices: torch.Tensor,
    rank: int,
    sketch: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_oversamples: int = DEFAULT_OVERSAMPLES,
    power_iters: int = 0,
):
    """rSVD over a leading batch axis with an independent sketch per item
    (ops/linalg.py:361-389). ``sketch`` (n, t, k) may be drawn by the
    caller (the pipeline draws every block's sketch up front so results do
    not depend on the batch size); otherwise it is drawn here."""
    n, _, t = matrices.shape
    if sketch is None:
        sketch = normal(
            (t, rank + num_oversamples), generator, matrices.device, batch=(n,)
        )
    return _rsvd_core(matrices, sketch, rank, power_iters)


def projected_svd(projection: torch.Tensor, data: torch.Tensor):
    """Given U @ P @ V with U @ P orthonormal, ``R, s, Vt =
    projected_svd(P, V)`` is the SVD (U @ R) s Vt."""
    m, n = data.shape[-2], data.shape[-1]
    left, s, vt = svd_gram_left(data) if m <= n else svd_gram_right(data)
    return projection @ left, s, vt
