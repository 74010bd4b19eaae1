"""Linear-algebra primitives for PMD (counterpart of ops/linalg.py).

Batch-first like the JAX package: every routine accepts a leading ``...``
batch. Small SVDs go through symmetric Gram + ``torch.linalg.eigh``
(LAPACK on the CPU, cuSOLVER on the card); the JAX package's Jacobi eigh is
a TPU workaround and is not carried over. Random sketches are drawn through
``utils.random.normal`` so tests can inject the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from localmd_tpu_torch.utils.random import make_generator, normal

DEFAULT_OVERSAMPLES = 10


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


def eigh_descending(sym: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., k, k), eigenvalues descending."""
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
