"""Reference movie statistics: the per-pixel mean over all frames, and the
noise image, the mean over the movie's 1024-frame chunks of each pixel's
Welch noise sigma.

The noise sigma of a chunk of at least 256 frames is the square root of
the mean of its Welch power spectral density (Hann window of 256 frames,
overlap 128, constant detrend, density scaling, one-sided) over the bins
[65, 129) -- the upper half of the band -- halved, which is how the
localized PMD method estimates the noise floor; a chunk shorter than 256
frames adds to the mean only. The DFT over the band is a product with a
(256, 64) cosine and sine matrix, so the control's TF32 reaches it; the
control's mean sums the frames rounded to bfloat16.
"""

from __future__ import annotations

import math

import torch

from .precision import products, summand

CHUNK_FRAMES = 1024
MIN_NOISE_FRAMES = 256
NPERSEG = 256
NOVERLAP = 128
BAND = (65, 129)


def band_dft(nperseg: int, dtype, device):
    """Hann-windowed cosine and sine matrices (nperseg, n_bins) of the band
    and the density scale 1 / sum(window^2)."""
    n = torch.arange(nperseg, dtype=torch.float64, device=device)
    win = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / nperseg)
    k = torch.arange(*BAND, dtype=torch.float64, device=device)
    ang = 2.0 * math.pi * n[:, None] * k[None, :] / nperseg
    cos_m = (torch.cos(ang) * win[:, None]).to(dtype)
    sin_m = (torch.sin(ang) * win[:, None]).to(dtype)
    return cos_m, sin_m, 1.0 / float((win * win).sum())


def welch_sigma(x: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """Noise sigma of each column of a (t, p) chunk, t >= 256."""
    with products(precision) as dtype:
        x = x.to(dtype)
        cos_m, sin_m, scale = band_dft(NPERSEG, dtype, x.device)
        segs = x.unfold(0, NPERSEG, NPERSEG - NOVERLAP)          # (S, p, nperseg)
        segs = segs - segs.mean(dim=-1, keepdim=True)
        power = ((segs @ cos_m) ** 2 + (segs @ sin_m) ** 2) * scale   # (S, p, bins)
        power = power.mean(dim=0)
        k = torch.arange(*BAND, device=x.device)
        power = torch.where(2 * k >= NPERSEG, 0.5 * power, power)
        return torch.sqrt(power.mean(dim=-1))


class MovieStats:
    """Mean and noise images of a (t_total, p) movie fed to ``add`` in its
    1024-frame chunks, in order, each as a (t, p) tensor of counts; pixels
    are taken ``pixel_block`` at a time."""

    def __init__(self, t_total: int, n_pixels: int, device, precision: str = "float64",
                 pixel_block: int = 1 << 15):
        self.t_total = t_total
        self.precision = precision
        self.pixel_block = pixel_block
        acc = torch.float64 if precision == "float64" else torch.float32
        self._sum = torch.zeros(n_pixels, dtype=acc, device=device)
        self._noise = torch.zeros(n_pixels, dtype=acc, device=device)
        self._noise_chunks = 0
        self._next = 0

    def add(self, start: int, chunk: torch.Tensor) -> None:
        if start != self._next or chunk.shape[0] != min(CHUNK_FRAMES, self.t_total - start):
            raise ValueError(f"chunks come in order, {CHUNK_FRAMES} frames each: got "
                             f"{chunk.shape[0]} frames at {start}, expected {self._next}")
        self._next += chunk.shape[0]
        with_noise = chunk.shape[0] >= MIN_NOISE_FRAMES
        with products(self.precision) as dtype:
            for a in range(0, chunk.shape[1], self.pixel_block):
                x = chunk[:, a : a + self.pixel_block].to(dtype)
                self._sum[a : a + x.shape[1]] += summand(x, self.precision).sum(dim=0)
                if with_noise:
                    self._noise[a : a + x.shape[1]] += welch_sigma(x, self.precision)
        self._noise_chunks += int(with_noise)

    def result(self):
        """(mean, noise sigma) per pixel."""
        if self._next != self.t_total:
            raise ValueError(f"{self._next} of {self.t_total} frames were added")
        return self._sum / self.t_total, self._noise / max(self._noise_chunks, 1)
