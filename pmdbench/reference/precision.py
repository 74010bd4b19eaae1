"""The two precisions the reference runs in: ``"float64"`` (the reference)
and ``"tf32"`` (the control, the step below the float32 with TF32 off that
the program states: float32 values, every matrix product in TF32, and
sums over values rounded to bfloat16)."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision is one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def summand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as the precision sums it."""
    if precision == "float64":
        return x.to(torch.float64)
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def products(precision: str):
    """Matrix products in the precision's mode for the body; the caller's
    settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        tf32 = precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        yield dtype_of(precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
