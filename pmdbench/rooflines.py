"""Least device time of the port's movie-reading kernel K1, counted from the
work and the cell's shapes, at the published peaks (``peaks.json``): each
input byte read once, each output byte written once."""

from __future__ import annotations

ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "uint16": 2, "int16": 2, "uint8": 1,
            "int8": 1}


def k1_bytes(t: int, pixels: int, stream_dtype: str) -> int:
    """The movie read once, the mean and noise images written once (f32)."""
    return t * pixels * ITEMSIZE[stream_dtype] + 2 * pixels * 4


def k1_seconds(t: int, pixels: int, stream_dtype: str, peaks: dict) -> float:
    return k1_bytes(t, pixels, stream_dtype) / peaks["hbm_bytes_per_s"]
