"""Reference of how much of each source of the movie a decomposition's
spatial basis leaves out.

A decomposition gives the denoised movie as mean + std * (A C): A = U R,
the (pixels, K) spatial basis, and C = diag(s) V. Its varying part lies in
the span of std * A, whatever the coefficients. The benchmark made the
movie from sources, each a footprint f_i over the pixels times a trace,
plus noise. ``source_gaps`` is, for each source, the root share of its
footprint that lies outside that span:

    sqrt(||(1 - P) f_i||^2 / ||f_i||^2),

P the orthogonal projection on the span of std * A. A block stage that
keeps too few components leaves sources out of the basis; the noise it
keeps does not count. ``projection`` judges the coefficients in the basis.
"""

from __future__ import annotations

import torch

from .precision import products


def source_gaps(a: torch.Tensor, std: torch.Tensor, footprints: torch.Tensor) -> torch.Tensor:
    """(n,) root shares above, in float64; ``a``, ``std`` and the
    (pixels, n) ``footprints`` have C-order pixels."""
    with products("float64") as dtype:
        basis = a.to(dtype) * std.to(dtype).reshape(-1, 1)
        f = footprints.to(dtype)
        b = basis.T @ f
        gram = basis.T @ basis
        del basis
        inside = (b * torch.cholesky_solve(b, torch.linalg.cholesky(gram))).sum(dim=0)
        return (1.0 - inside / f.square().sum(dim=0)).clamp_min(0.0).sqrt()
