"""Reference of the frames a decomposition serves: mean + std * (A C) at
the pixels and frames of a request, from the basis A (``projection.
spatial_basis``) and the coefficients C = diag(s) V, in float64."""

from __future__ import annotations

import torch

from .precision import products


def request_pixels(request: dict, d2: int, device) -> torch.Tensor:
    """C-order ids of the request's (h, w) window, row by row."""
    rows = torch.arange(request["r0"], request["r0"] + request["h"], device=device)
    cols = torch.arange(request["c0"], request["c0"] + request["w"], device=device)
    return (rows[:, None] * d2 + cols[None, :]).reshape(-1)


def served(a: torch.Tensor, c: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, d2: int,
           request: dict, precision: str = "float64") -> torch.Tensor:
    """(n, h, w) frames of a request."""
    with products(precision) as dtype:
        pix = request_pixels(request, d2, a.device)
        t0, n = request["t0"], request["n"]
        sig = a.index_select(0, pix).to(dtype) @ c[:, t0 : t0 + n].to(dtype)
        out = mean.to(dtype)[pix, None] + std.to(dtype)[pix, None] * sig
        return out.T.reshape(n, request["h"], request["w"])


def gap(got: torch.Tensor, ref: torch.Tensor, mean: torch.Tensor, d2: int, request: dict) -> float:
    """||got - ref|| / ||ref - mean|| over a request's frames."""
    pix = request_pixels(request, d2, ref.device)
    base = mean.to(torch.float64)[pix].reshape(1, request["h"], request["w"])
    got = got.to(torch.float64).reshape(ref.shape)
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref - base))
