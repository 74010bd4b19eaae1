"""Per-pixel noise estimation (Welch PSD band floor): the plain PyTorch
counterpart of localmd_tpu/ops/noise.py, and the plain twin of kernel K1
(``ops.kernels.movie_stats``).

Welch is evaluated as a windowed partial DFT restricted to bins [65, 129)
(two (nperseg, 64) matmuls per segment) with constant detrend folded in as a
rank-1 correction: F @ (w*(x - m)) = F_w @ x - m * (F_w @ 1).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NPERSEG = 256
NOVERLAP = 128
_STEP = NPERSEG - NOVERLAP
_BAND_START = NPERSEG // 4 + 1   # 65
_BAND_END = NPERSEG // 2 + 1     # 129 (exclusive)
N_BINS = _BAND_END - _BAND_START  # 64


def _hann_periodic(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)


def _band_dft_matrices(nperseg: int = NPERSEG, device="cpu"):
    """Windowed real-DFT matrices for bins [65, 129): (cos_m, sin_m) of shape
    (nperseg, 64) and their column sums.

    Built with the same f32 arithmetic as ops/noise.py:55-61 -- the f32 angle
    ``(-2 pi / N) * n * k`` carries rounding the reference bakes in, so
    K1 receives these matrices instead of computing sincos itself.
    """
    n = torch.arange(nperseg, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(_BAND_START, _BAND_END, dtype=torch.float32, device=device)[None, :]
    ang = torch.tensor(-2.0 * math.pi / nperseg, dtype=torch.float32) * n * k
    win = _hann_periodic(nperseg, device)[:, None]
    cos_m = torch.cos(ang) * win
    sin_m = torch.sin(ang) * win
    return cos_m, sin_m, cos_m.sum(dim=0), sin_m.sum(dim=0)


def welch_scale(nperseg: int, device="cpu") -> torch.Tensor:
    """Density scaling 1 / sum(win^2) as an f32 scalar."""
    win = _hann_periodic(nperseg, device)
    return 1.0 / torch.sum(win * win)


def welch_sigma(traces: torch.Tensor, nperseg: int) -> torch.Tensor:
    """Noise sigma of ``traces`` (..., T) with segment length ``nperseg``
    and overlap 128 -> (...,).

    nperseg = 256 is the documented scipy semantics
    (``welch_noise_estimate``); nperseg = T is the reference's effective
    single-periodogram behaviour (``welch_noise_estimate_ref_compat``). A bin
    at or above Nyquist (2k >= nperseg) keeps the reference's 0.5 factor.
    """
    x = traces.to(torch.float32)
    step = nperseg - NOVERLAP
    segs = x.unfold(-1, nperseg, step)                          # (..., S, nperseg)
    cos_m, sin_m, cos_1, sin_1 = _band_dft_matrices(nperseg, x.device)
    m = segs.mean(dim=-1, keepdim=True)
    re = segs @ cos_m - m * cos_1
    im = segs @ sin_m - m * sin_1
    p = (re * re + im * im) * welch_scale(nperseg, x.device)
    band = p.mean(dim=-2)                                       # over segments
    k = torch.arange(_BAND_START, _BAND_END, device=x.device)
    band = torch.where(2 * k >= nperseg, band * 0.5, band)
    return torch.sqrt(band.mean(dim=-1))


def welch_noise_estimate(traces: torch.Tensor) -> torch.Tensor:
    """Per-trace sigma for (..., T), T >= 256 (ops/noise.py:64-108)."""
    t = traces.shape[-1]
    if t < NPERSEG:
        raise ValueError(f"welch_noise_estimate needs at least {NPERSEG} frames, got {t}")
    return welch_sigma(traces, NPERSEG)


def welch_noise_estimate_ref_compat(traces: torch.Tensor) -> torch.Tensor:
    """Per-trace sigma reproducing the reference's effective output: one
    full-length Hann periodogram per trace (ops/noise.py:111-154)."""
    t = traces.shape[-1]
    if t < 2 * (_BAND_END - 1):
        raise ValueError(
            f"reference-compat noise estimate needs at least "
            f"{2 * (_BAND_END - 1)} frames, got {t}"
        )
    return welch_sigma(traces, t)


def get_mean_chunk(movie: torch.Tensor, mean_divisor) -> torch.Tensor:
    """Mean-only chunk contribution: (d1, d2, T) -> sum over frames / divisor."""
    return movie.to(torch.float32).sum(dim=-1) / mean_divisor


def get_mean_and_noise(movie: torch.Tensor, mean_divisor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk contribution to the running mean + per-pixel sigma (nperseg 256)."""
    return get_mean_chunk(movie, mean_divisor), welch_noise_estimate(movie)


def get_mean_and_noise_ref_compat(movie: torch.Tensor, mean_divisor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk mean + reference-effective sigma (nperseg = T)."""
    return get_mean_chunk(movie, mean_divisor), welch_noise_estimate_ref_compat(movie)


# -- per-trace helpers of the reference's preprocessing_utils, batched over
#    leading dims (ops/noise.py:193-230) ----------------------------------------

# the reference's name (preprocessing_utils.py:28); a single (T,) trace is
# the degenerate batch
get_noise_estimate = welch_noise_estimate


def get_mean(trace: torch.Tensor) -> torch.Tensor:
    """Per-trace mean: (..., T) -> (...,)."""
    return trace.mean(dim=-1)


def center(traces: torch.Tensor) -> torch.Tensor:
    """Subtract each trace's mean: (..., T) -> (..., T)."""
    return traces - traces.mean(dim=-1, keepdim=True)


def center_and_noise_normalize(traces: torch.Tensor) -> torch.Tensor:
    """Center each trace and divide it by its Welch noise sigma; T >= 256."""
    centered = center(traces)
    return centered / welch_noise_estimate(centered)[..., None]


def standardize_block(block: torch.Tensor) -> torch.Tensor:
    """Center and noise-normalize every pixel of a (d1, d2, T) block."""
    return center_and_noise_normalize(block)


def center_and_get_noise_estimate(movie: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Noise sigma image of a (d1, d2, T) movie given its (d1, d2) mean."""
    return welch_noise_estimate(movie - mean[..., None])
