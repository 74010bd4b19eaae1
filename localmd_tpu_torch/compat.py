"""The reference's per-block functions over the batched engine (counterpart
of localmd_tpu/compat.py), for scripts written against
``localmd.decomposition``:

- ``decomposition_no_normalize_approx`` (reference decomposition.py:76-99)
- ``rank_simulation``                   (reference decomposition.py:102-131)
- ``single_block_md``                   (reference decomposition.py:235-330)
- ``single_residual_block_md``          (reference decomposition.py:333-387)
- ``get_temporal_projector``            (reference decomposition.py:390-407)
- ``windowed_pmd``                      (reference decomposition.py:410-525)

The reference's conventions hold: blocks are (d1, d2, T), spatial outputs
(d1, d2, r) with F-order pixels, and ``rank_placeholder``'s length is the
rank (an int is accepted too). Where the JAX package takes a PRNG key these
take a ``torch.Generator``, or None for a generator seeded from numpy's
global RNG. Each runs on the card unless ``device="cpu"`` is passed (and
raises without CUDA); a generator must live on that device. Every draw goes
through ``utils.random.normal``, so tests inject the JAX package's sketches
with ``sketch_override``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.engine import (
    effective_window_length,
    identity,
    single_block_md_batched,
    single_residual_block_md_batched,
    temporal_projector_batched,
    window_count,
    windowed_pmd_batched,
)
from localmd_tpu_torch.ops.linalg import DEFAULT_OVERSAMPLES, truncated_random_svd
from localmd_tpu_torch.ops.roughness import spatial_roughness_stat, temporal_roughness_stat
from localmd_tpu_torch.ops.tiling import flatten_fov, unflatten_fov
from localmd_tpu_torch.utils.random import make_generator, normal


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _placeholder_rank(rank_placeholder) -> int:
    """The reference's convention: ``rank_placeholder``'s length is the rank
    (reference decomposition.py:39, 60); a plain int is accepted too."""
    if isinstance(rank_placeholder, (int, np.integer)):
        return int(rank_placeholder)
    return int(np.shape(rank_placeholder)[0])


def truncated_random_svd_ref(input_matrix, generator: Optional[torch.Generator],
                             rank_placeholder, device="cuda"):
    """The reference-signature randomized SVD (reference
    decomposition.py:37-73), the rank carried by ``rank_placeholder``."""
    dev = resolve_device(device)
    return truncated_random_svd(_f32(input_matrix, dev), _placeholder_rank(rank_placeholder),
                                generator=generator)


def decomposition_no_normalize_approx(block, generator: Optional[torch.Generator],
                                      rank_placeholder, device="cuda"):
    """Roughness statistics of an un-normalized (d1, d2, t) block's rSVD
    components (reference decomposition.py:76-99): (spatial, temporal),
    each (rank,)."""
    dev = resolve_device(device)
    block = _f32(block, dev)
    d1, d2, _ = block.shape
    u, s, v = truncated_random_svd(flatten_fov(block, "F"), _placeholder_rank(rank_placeholder),
                                   generator=generator)
    u_img = unflatten_fov(u, d1, d2, "F")                 # (d1, d2, r)
    return spatial_roughness_stat(u_img.movedim(-1, 0)), temporal_roughness_stat(s[:, None] * v)


def rank_simulation(d1: int, d2: int, t: int, rank_placeholder,
                    generator1: Optional[torch.Generator], generator2: Optional[torch.Generator],
                    device="cuda"):
    """Roughness statistics of a pure-noise block (reference
    decomposition.py:102-131): N(0, 1) noise from ``generator1``, the rSVD
    sketch from ``generator2``."""
    dev = resolve_device(device)
    noise = normal((d1, d2, t), generator1, dev)
    return decomposition_no_normalize_approx(noise, generator2, rank_placeholder, device=dev)


def _sketches(shape, generator: Optional[torch.Generator], dev, batch):
    if generator is None:
        generator = make_generator(None, dev)
    return normal(shape, generator, dev, batch=batch)


def single_block_md(
    block,
    generator: Optional[torch.Generator],
    rank_placeholder,
    temporal_avg_factor: int,
    spatial_average_factor: int,
    spatial_threshold: float,
    temporal_threshold: float,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-stage decomposition of one (d1, d2, t) block (reference
    decomposition.py:235-330), denoisers included. Returns (u (d1, d2, r)
    orthonormal, decisions (r,), v (r, t))."""
    dev = resolve_device(device)
    block = _f32(block, dev)
    d1, d2, t = block.shape
    rank = _placeholder_rank(rank_placeholder)
    sketch = _sketches((t // temporal_avg_factor, rank + DEFAULT_OVERSAMPLES), generator, dev, (1,))
    u, dec, v = single_block_md_batched(
        block[None], sketch, rank, temporal_avg_factor, spatial_average_factor,
        spatial_threshold, temporal_threshold, spatial_denoiser, temporal_denoiser,
    )
    return unflatten_fov(u[0], d1, d2, "F"), dec[0], v[0]


def single_residual_block_md(
    block,
    existing,
    generator: Optional[torch.Generator],
    rank_placeholder,
    temporal_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Components of a (d1, d2, t) block orthogonal to ``existing`` (d1, d2,
    S) (reference decomposition.py:333-387): (u (d1, d2, r), decisions
    (r,), v (r, t))."""
    dev = resolve_device(device)
    block = _f32(block, dev)
    d1, d2, t = block.shape
    rank = _placeholder_rank(rank_placeholder)
    sketch = _sketches((t // temporal_avg_factor, rank + DEFAULT_OVERSAMPLES), generator, dev, (1,))
    u, dec, v = single_residual_block_md_batched(
        block[None], flatten_fov(_f32(existing, dev), "F")[None], sketch, rank,
        temporal_avg_factor, spatial_threshold, temporal_threshold,
    )
    return unflatten_fov(u[0], d1, d2, "F"), dec[0], v[0]


def get_temporal_projector(spatial_decomposition, block, device="cuda") -> torch.Tensor:
    """(d1, d2, r) basis and (d1, d2, t) block -> (r, t) (reference
    decomposition.py:390-407)."""
    dev = resolve_device(device)
    spatial = flatten_fov(_f32(spatial_decomposition, dev), "F")[None]
    return temporal_projector_batched(spatial, flatten_fov(_f32(block, dev), "F")[None])[0]


def windowed_pmd(
    window_length: int,
    block,
    max_rank: int,
    spatial_threshold: float,
    temporal_threshold: float,
    max_consecutive_failures: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """The windowed incremental-basis decomposition of one (d1, d2, t) block
    (reference decomposition.py:410-525). Returns host arrays (spatial (d1,
    d2, ctr), temporal (ctr, t)) cropped to the kept count, as the
    reference does; one sketch per window from ``generator``."""
    dev = resolve_device(device)
    block = _f32(block, dev)
    d1, d2, t = block.shape
    wl = effective_window_length(window_length, t, temporal_avg_factor)
    sketches = _sketches((wl // temporal_avg_factor, max_rank + DEFAULT_OVERSAMPLES), generator,
                         dev, (window_count(t, wl), 1))
    res = windowed_pmd_batched(
        block[None], sketches, window_length, max_rank, spatial_threshold, temporal_threshold,
        max_consecutive_failures, temporal_avg_factor, spatial_avg_factor,
        spatial_denoiser, temporal_denoiser,
    )
    ctr = int(res.counts[0])
    spatial = unflatten_fov(res.spatial[0], d1, d2, "F")[:, :, :ctr].cpu().numpy()
    return spatial, res.temporal[0, :ctr].cpu().numpy()
