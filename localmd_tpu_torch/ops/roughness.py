"""Roughness statistics and the rank-selection fitness test (counterpart of
ops/roughness.py). Signal components are spatially and temporally smoother
than noise; every statistic reduces over trailing dims, so leading
component/block batches come for free."""

from __future__ import annotations

import numpy as np
import torch


def l1_norm(data: torch.Tensor) -> torch.Tensor:
    """Overall L1 norm (roughness.py:28-30)."""
    return data.abs().sum()


def trend_filter_stat(trace: torch.Tensor) -> torch.Tensor:
    """Sum of absolute second differences of traces (..., T) -> (...,)
    (roughness.py:33-37; unused by the pipeline)."""
    second_diff = 2.0 * trace[..., 1:-1] - trace[..., :-2] - trace[..., 2:]
    return second_diff.abs().sum(dim=-1)


def total_variation_stat(img: torch.Tensor) -> torch.Tensor:
    """8-neighbour total variation of images (..., d1, d2) -> (...,)
    (roughness.py:40-52; unused by the pipeline)."""
    centre = img[..., 1:-1, 1:-1]
    acc = torch.zeros_like(centre)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                shifted = img[..., 1 + dy : img.shape[-2] - 1 + dy, 1 + dx : img.shape[-1] - 1 + dx]
                acc = acc + (centre - shifted).abs()
    return acc.sum(dim=(-2, -1))


def spatial_roughness_stat(u: torch.Tensor) -> torch.Tensor:
    """Roughness of images ``u`` shaped (..., d1, d2) -> (...,)."""
    vert = (u[..., 1:, :] - u[..., :-1, :]).abs()
    horiz = (u[..., :, 1:] - u[..., :, :-1]).abs()
    d1, d2 = u.shape[-2], u.shape[-1]
    denom_count = (d1 - 1) * d2 + d1 * (d2 - 1)
    avg_diff = (vert.sum(dim=(-2, -1)) + horiz.sum(dim=(-2, -1))) / denom_count
    avg_elem = u.abs().mean(dim=(-2, -1))
    return avg_diff / avg_elem


def temporal_roughness_stat(v: torch.Tensor) -> torch.Tensor:
    """Roughness of traces ``v`` shaped (..., T) -> (...,)."""
    second_diff = (v[..., :-2] + v[..., 2:] - 2.0 * v[..., 1:-1]).abs()
    return second_diff.mean(dim=-1) / v.abs().mean(dim=-1)


def evaluate_fitness(
    images: torch.Tensor, traces: torch.Tensor, spatial_threshold, temporal_threshold
) -> torch.Tensor:
    """(..., r) int32 keep decision: 1 when both stats are below threshold.

    images: (..., r, d1, d2); traces: (..., r, T)."""
    s_stat = spatial_roughness_stat(images)
    t_stat = temporal_roughness_stat(traces)
    keep = (s_stat < spatial_threshold) & (t_stat < temporal_threshold)
    return keep.to(torch.int32)


def construct_final_fitness_decision(
    images: torch.Tensor, traces: torch.Tensor, spatial_threshold, temporal_threshold
) -> torch.Tensor:
    """Reference-signature adapter: images (d1, d2, r), traces (T, r)."""
    return evaluate_fitness(
        images.movedim(-1, 0), traces.transpose(-1, -2),
        spatial_threshold, temporal_threshold,
    )


def filter_by_failures(decisions: torch.Tensor, max_consecutive_failures: int) -> torch.Tensor:
    """Sequential failure filter in cumulative form (the ``lax.scan`` of
    ops/roughness.py:94-131).

    Walking components in order, a failure is still kept until the
    ``max_consecutive_failures``-th consecutive failure (kept too); every
    component after that is dropped. Component k is kept iff no earlier
    component j < k ended a run of ``max_consecutive_failures`` failures.

    The run length ending at k is ``k - (index of the last success <= k)``,
    a cumulative max; a component "hits the limit" when that run equals the
    limit, and a cumulative OR shifted by one gives the dead mask.
    """
    dec = decisions.to(torch.bool)
    r = dec.shape[-1]
    idx = torch.arange(r, device=dec.device)
    last_success = torch.where(dec, idx, torch.full_like(idx, -1)).cummax(dim=-1).values
    run = idx - last_success                       # consecutive failures ending at k
    hit = (~dec) & (run == max_consecutive_failures)
    hit_before = torch.cumsum(hit.to(torch.int32), dim=-1) - hit.to(torch.int32)
    return hit_before == 0


def filter_by_failures_np(decisions: np.ndarray, max_consecutive_failures: int) -> np.ndarray:
    """Host oracle with the reference's sequential semantics (copied from
    ops/roughness.py:134-151)."""
    decisions = np.array(decisions, dtype=bool, copy=True)
    out = np.empty_like(decisions)
    number_of_failures = 0
    dead = False
    for k in range(decisions.shape[0]):
        if dead:
            out[k] = False
        elif not decisions[k]:
            number_of_failures += 1
            out[k] = True
            if number_of_failures == max_consecutive_failures:
                dead = True
        else:
            number_of_failures = 0
            out[k] = True
    return out
