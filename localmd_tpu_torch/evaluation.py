"""The reference's ``evaluation`` names over :mod:`localmd_tpu_torch.ops.roughness`
(counterpart of localmd_tpu/evaluation.py). The ``*_vmap`` adapters keep
the reference's axes: images with the component axis last, fitness traces
as (t, r)."""

import torch

from localmd_tpu_torch.ops.roughness import (
    construct_final_fitness_decision,
    evaluate_fitness,
    filter_by_failures,
    filter_by_failures_np,
    l1_norm,
    spatial_roughness_stat,
    temporal_roughness_stat,
    total_variation_stat,
    trend_filter_stat,
)


def spatial_roughness_stat_vmap(u: torch.Tensor) -> torch.Tensor:
    """(d1, d2, r) images, component axis last -> (r,) statistics."""
    return spatial_roughness_stat(u.movedim(-1, 0))


def temporal_roughness_stat_vmap(v: torch.Tensor) -> torch.Tensor:
    """(r, t) traces -> (r,) statistics."""
    return temporal_roughness_stat(v)


def evaluate_fitness_vmap(images: torch.Tensor, traces: torch.Tensor, spatial_threshold,
                          temporal_threshold) -> torch.Tensor:
    """Images (d1, d2, r) and traces (t, r) -> (r,) 0/1 decisions."""
    return evaluate_fitness(images.movedim(-1, 0), traces.T, spatial_threshold,
                            temporal_threshold)


__all__ = [
    "l1_norm",
    "trend_filter_stat",
    "total_variation_stat",
    "spatial_roughness_stat",
    "temporal_roughness_stat",
    "spatial_roughness_stat_vmap",
    "temporal_roughness_stat_vmap",
    "evaluate_fitness",
    "evaluate_fitness_vmap",
    "construct_final_fitness_decision",
    "filter_by_failures",
    "filter_by_failures_np",
]
