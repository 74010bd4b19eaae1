"""Reference temporal regression on a decomposition's spatial basis.

A decomposition gives the movie as mean + std * (A C): A = U R, the
(pixels, K) spatial basis, and C = diag(s) V, the (K, frames) temporal
coefficients. Given A and the statistics images, the best C for the movie
is the least-squares fit C* = (A^T A)^-1 A^T Y_std of the standardized
frames Y_std = (Y - mean) / std. ``frame_gaps`` measures, frame by frame,
how far a decomposition's own reconstruction A C lies from the best one in
its basis, A C*, relative to the size of A C*.

The decomposition states that A has orthonormal columns, and its temporal
regression is the projection P = A^T Y_std. ``coefficient_gaps`` measures
C against P frame by frame: the regression's arithmetic alone, whatever
A's departure from orthonormal columns.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import products


def spatial_basis(indptr, indices, data, r, order: str, d1: int, d2: int, device) -> torch.Tensor:
    """A = U R as a dense (d1 * d2, K) float64 matrix with rows in C order,
    from U as CSR arrays (rows in ``order``: "F" counts down columns) and R."""
    d = d1 * d2
    u = torch.sparse_csr_tensor(
        torch.as_tensor(np.asarray(indptr, dtype=np.int64)),
        torch.as_tensor(np.asarray(indices, dtype=np.int64)),
        torch.as_tensor(np.asarray(data, dtype=np.float64)),
        size=(d, int(np.shape(r)[0])),
    ).to(device)
    a = u @ torch.as_tensor(np.asarray(r, dtype=np.float64), device=device)
    if order == "F":
        a = a.reshape(d2, d1, -1).transpose(0, 1).reshape(d, -1)
    return a.contiguous()


class Projection:
    """C* for a movie fed to ``add`` in frame chunks, (t, p) counts with
    C-order pixels, in the given precision. A^T Y_std is formed as
    B^T Y - B^T mean with B = A / std, the standardization folded into
    the basis, as a streamed regression over raw counts forms it: in float64
    the two forms agree to rounding; in the control's TF32 the counts
    themselves are rounded."""

    def __init__(self, a: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, t_total: int,
                 precision: str = "float64", max_bytes: int = 1 << 28):
        self.precision = precision
        with products(precision) as dtype:
            self.a = a.to(dtype)
            self.b = (a / std[:, None]).to(dtype)
            self.offset = (mean.to(dtype) @ self.b)[:, None]
            self.rhs = torch.zeros((a.shape[1], t_total), dtype=dtype, device=a.device)
        self.frames_per_product = max(1, max_bytes // (a.shape[0] * 8))

    def add(self, start: int, chunk: torch.Tensor) -> None:
        with products(self.precision) as dtype:
            for s in range(0, chunk.shape[0], self.frames_per_product):
                y = chunk[s : s + self.frames_per_product].to(dtype)
                self.rhs[:, start + s : start + s + y.shape[0]] = (y @ self.b).T - self.offset

    def projection(self) -> torch.Tensor:
        """P = A^T Y_std (K, frames)."""
        return self.rhs

    def solve(self) -> torch.Tensor:
        """C* (K, frames)."""
        with products(self.precision):
            gram = self.a.T @ self.a
            return torch.cholesky_solve(self.rhs, torch.linalg.cholesky(gram))


def frame_gaps(a: torch.Tensor, c_best: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per frame, ||A (C - C*)|| / ||A C*||, in float64."""
    with products("float64"):
        a = a.to(torch.float64)
        gram = a.T @ a
        c_best = c_best.to(torch.float64)
        diff = c.to(torch.float64) - c_best
        num = ((gram @ diff) * diff).sum(dim=0).clamp_min(0.0)
        den = ((gram @ c_best) * c_best).sum(dim=0)
        return torch.sqrt(num / den)


def coefficient_gaps(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per frame, ||C - P|| / ||P||, in float64."""
    p = p.to(torch.float64)
    return (torch.linalg.vector_norm(c.to(torch.float64) - p, dim=0)
            / torch.linalg.vector_norm(p, dim=0))
