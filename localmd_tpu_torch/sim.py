"""Synthetic functional-imaging movies (counterpart of localmd_tpu/sim.py):
two-photon somatic movies, large-FOV widefield movies with a strong global
background, high-rate voltage movies and volumetric stacks, each made on
``device`` (the card unless ``device="cpu"`` is passed; raises without
CUDA) from seeded ``torch.Generator``s, with the JAX package's defaults
and constants.

The movies fit PMD's model: spatially compact smooth footprints times
temporally smooth traces, plus white noise (and a low-rank background).
torch cannot reproduce JAX's threefry streams, so the same seed gives a
movie of the same construction and statistics, not the same values. As the
JAX package splits one key per part, each part draws from its own
generator (``utils.random.stage_seeds``): the footprints of a seed do not
depend on ``t``.
"""

from __future__ import annotations

import math
from typing import List

import torch

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.utils.random import make_generator, stage_seeds


def _uniform(n: int, low: float, high: float, gen: torch.Generator) -> torch.Tensor:
    return low + (high - low) * torch.rand(n, generator=gen, device=gen.device)


def _gaussian_blobs(gen: torch.Generator, n_cells: int, d1: int, d2: int, radius: float):
    """(d1, d2, n_cells) smooth compact footprints: centres uniform in
    [radius, d - radius), widths radius x U[0.6, 1.4) (sim.py:21-30)."""
    cy = _uniform(n_cells, radius, d1 - radius, gen)
    cx = _uniform(n_cells, radius, d2 - radius, gen)
    r = radius * _uniform(n_cells, 0.6, 1.4, gen)
    yy = torch.arange(d1, dtype=torch.float32, device=gen.device)[:, None, None]
    xx = torch.arange(d2, dtype=torch.float32, device=gen.device)[None, :, None]
    dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return torch.exp(-dist2 / (2.0 * r**2))


def _calcium_traces(gen: torch.Generator, n_cells: int, t: int, rate: float, tau: float):
    """(n_cells, t) Bernoulli(``rate``) spike trains through the exponential
    decay c_k = c_{k-1} exp(-1/tau) + s_k (sim.py:33-44, a ``lax.scan``
    there): a loop over frames on the device, one launch a frame."""
    spikes = (torch.rand(t, n_cells, generator=gen, device=gen.device) < rate).to(torch.float32)
    decay = math.exp(-1.0 / tau)
    traces = torch.empty_like(spikes)
    carry = torch.zeros(n_cells, dtype=torch.float32, device=gen.device)
    for k in range(t):
        carry = torch.add(spikes[k], carry, alpha=decay, out=traces[k])
    return traces.T


def _outer(footprints: torch.Tensor, traces: torch.Tensor) -> torch.Tensor:
    """(d1, d2, n) footprints x (n, t) traces -> (t, d1, d2)."""
    d1, d2, n = footprints.shape
    return (traces.T @ footprints.reshape(d1 * d2, n).T).reshape(-1, d1, d2)


def _generators(seed: int, parts, device):
    seeds = stage_seeds(seed, parts)
    return [make_generator(seeds[p], device) for p in parts]


def two_photon_movie(
    d1: int = 512,
    d2: int = 512,
    t: int = 2048,
    n_cells: int = 150,
    noise_sigma: float = 1.0,
    radius: float = 6.0,
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Somatic two-photon movie: compact blobs x calcium transients (rate
    0.01, tau 20 frames, x5) + white noise + a camera offset of 100. A
    (t, d1, d2) float32 tensor on ``device``."""
    dev = resolve_device(device)
    g_sp, g_tr, g_ns = _generators(seed, ("spatial", "traces", "noise"), dev)
    footprints = _gaussian_blobs(g_sp, n_cells, d1, d2, radius)
    traces = _calcium_traces(g_tr, n_cells, t, rate=0.01, tau=20.0)
    movie = _outer(footprints, traces * 5.0)
    movie += noise_sigma * torch.randn(movie.shape, generator=g_ns, device=dev)
    return movie + 100.0


def widefield_movie(
    d1: int = 1024,
    d2: int = 1024,
    t: int = 1024,
    n_sources: int = 40,
    background_rank: int = 4,
    noise_sigma: float = 1.0,
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Widefield (1-photon) movie: large diffuse sources (radius d / 12,
    rate 0.02, tau 40, x3) + a smooth global background (radius d / 3,
    rate 0.05, tau 100, x10) + noise + an offset of 200."""
    dev = resolve_device(device)
    g_sp, g_tr, g_bs, g_bt, g_ns = _generators(
        seed, ("spatial", "traces", "bg_spatial", "bg_traces", "noise"), dev)
    footprints = _gaussian_blobs(g_sp, n_sources, d1, d2, radius=min(d1, d2) / 12.0)
    traces = _calcium_traces(g_tr, n_sources, t, rate=0.02, tau=40.0)
    movie = _outer(footprints, traces * 3.0)
    bg_space = _gaussian_blobs(g_bs, background_rank, d1, d2, radius=min(d1, d2) / 3.0)
    bg_time = _calcium_traces(g_bt, background_rank, t, rate=0.05, tau=100.0)
    movie += _outer(bg_space, bg_time * 10.0)
    movie += noise_sigma * torch.randn(movie.shape, generator=g_ns, device=dev)
    return movie + 200.0


def voltage_movie(
    d1: int = 256,
    d2: int = 256,
    t: int = 20000,
    n_cells: int = 60,
    noise_sigma: float = 1.0,
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Voltage-imaging movie: fast kinetics (radius 5, rate 0.05, tau 3,
    x8) over a long T + noise + an offset of 50."""
    dev = resolve_device(device)
    g_sp, g_tr, g_ns = _generators(seed, ("spatial", "traces", "noise"), dev)
    footprints = _gaussian_blobs(g_sp, n_cells, d1, d2, radius=5.0)
    traces = _calcium_traces(g_tr, n_cells, t, rate=0.05, tau=3.0)
    movie = _outer(footprints, traces * 8.0)
    movie += noise_sigma * torch.randn(movie.shape, generator=g_ns, device=dev)
    return movie + 50.0


def volumetric_stack(
    n_planes: int = 4,
    d1: int = 256,
    d2: int = 256,
    t: int = 1024,
    seed: int = 0,
    device="cuda",
) -> List[torch.Tensor]:
    """Per-plane (t, d1, d2) two-photon movies of 60 cells, plane p from
    seed + p."""
    return [two_photon_movie(d1, d2, t, n_cells=60, seed=seed + p, device=device)
            for p in range(n_planes)]
