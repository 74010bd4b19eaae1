"""Faults planted in the program's timed path, for the readings that set a
check's limits (``readings.py``) and for the tests that see a broken path
come out not correct. Each is a context manager that patches the port for
its body and restores it on exit."""

from __future__ import annotations

import contextlib

import torch

# the block stage's entry points, as the pipeline calls them
_BLOCK_STAGE = ("window0_coset_stage", "window0_chunk_step", "windowed_pmd_batched")


def _keep_half(stage):
    def run(*args, **kwargs):
        acc, counts, v_fit, *rest = stage(*args, **kwargs)
        keep = counts // 2
        on = torch.arange(acc.shape[-1], device=acc.device)[None, :] < keep[:, None]
        return (acc * on[:, None, :], keep, v_fit * on[:, :, None], *rest)

    return run


@contextlib.contextmanager
def half_blocks():
    """The block stage keeps the first half of each block's components,
    rounded down, and drops the rest."""
    from localmd_tpu_torch import pipeline

    saved = {name: getattr(pipeline, name) for name in _BLOCK_STAGE}
    try:
        for name, stage in saved.items():
            setattr(pipeline, name, _keep_half(stage))
        yield
    finally:
        for name, stage in saved.items():
            setattr(pipeline, name, stage)


def _drop_half_grid(build):
    def run(*args, panels, **kwargs):
        panels = panels.clone()
        panels[panels.shape[0] // 2 :] = 0
        return build(*args, panels=panels, **kwargs)

    return run


@contextlib.contextmanager
def half_grid():
    """The block stage's components of the second half of the block grid
    (the lower half of the field of view, the grid being in raster order)
    left out of the spatial basis."""
    from localmd_tpu_torch import pipeline

    saved = pipeline.BlockSparseMatrix
    try:
        pipeline.BlockSparseMatrix = _drop_half_grid(saved)
        yield
    finally:
        pipeline.BlockSparseMatrix = saved
