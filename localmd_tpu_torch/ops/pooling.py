"""Spatial average-pool downsampling (counterpart of ops/pooling.py).

n x n average pooling over the FOV dims of a (..., d1, d2, T) stack with
SAME padding and count-normalization of partial edge windows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def downsample_average_pooling(array: torch.Tensor, n: int) -> torch.Tensor:
    """Average-pool (..., d1, d2, T) by n x n spatial windows (SAME padding)."""
    if n == 1:
        return array
    d1, d2, t = array.shape[-3], array.shape[-2], array.shape[-1]
    lead = array.shape[:-3]
    if d1 % n == 0 and d2 % n == 0:
        pooled = array.reshape(lead + (d1 // n, n, d2 // n, n, t))
        return pooled.mean(dim=(-4, -2))
    # XLA's SAME padding puts the extra element at the high end; windows are
    # summed over the valid pixels and divided by their count.
    p1 = (-d1) % n
    p2 = (-d2) % n
    lo1, lo2 = p1 // 2, p2 // 2
    x = array.movedim(-1, -3)                                  # (..., T, d1, d2)
    x = F.pad(x, (lo2, p2 - lo2, lo1, p1 - lo1))
    ones = F.pad(
        torch.ones((d1, d2), dtype=array.dtype, device=array.device),
        (lo2, p2 - lo2, lo1, p1 - lo1),
    )
    e1, e2 = x.shape[-2] // n, x.shape[-1] // n
    summed = x.reshape(x.shape[:-2] + (e1, n, e2, n)).sum(dim=(-3, -1))
    counts = ones.reshape(e1, n, e2, n).sum(dim=(-3, -1))
    return (summed / counts).movedim(-3, -1)
