"""Least device time of the port's V projection kernel K2, counted from the
work its function asks for and the call's shapes, at the published peaks
(``peaks.json``): the movie read once in the stream dtype, the projector
read once per launch, V written once, and the (r', d) by (d, t) product's
2 t d r' operations at the card's TF32 rate (its fastest for 32-bit
inputs). The larger of the two terms bounds the call. How K2 reaches
float32 accuracy (3xTF32: three TF32 products) is the kernel's own cost,
not the function's, and is not counted."""

from __future__ import annotations

from pmdbench.rooflines import ITEMSIZE


def k2_bytes(t: int, pixels: int, width: int, stream_dtype: str, launches: int = 1) -> int:
    """The movie read once, the (d, r') f32 projector read once per launch
    and the (r', t) f32 V written once."""
    return t * pixels * ITEMSIZE[stream_dtype] + launches * pixels * width * 4 + width * t * 4


def k2_flops(t: int, pixels: int, width: int) -> int:
    """The product's 2 t d r' operations."""
    return 2 * t * pixels * width


def k2_seconds(t: int, pixels: int, width: int, stream_dtype: str, peaks: dict,
               launches: int = 1) -> float:
    return max(k2_bytes(t, pixels, width, stream_dtype, launches) / peaks["hbm_bytes_per_s"],
               k2_flops(t, pixels, width) / peaks["tf32_flops_per_s"])
