"""The reference's ``pmd_loader`` names over :mod:`localmd_tpu_torch.loader`
(counterpart of localmd_tpu/pmd_loader.py). ``FrameDataloader`` is a
``torch.utils.data.Dataset`` of frame chunks with the reference's merged
tail; ``v_projection_routine`` is a plain function."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from localmd_tpu_torch.dataset import as_dataset
from localmd_tpu_torch.loader import PMDLoader, _chunk_ranges, standardize_and_filter
from localmd_tpu_torch.ops.linalg import DEFAULT_OVERSAMPLES
from localmd_tpu_torch.ops.linalg import truncated_random_svd as _truncated_random_svd
from localmd_tpu_torch.ops.tiling import flatten_fov
from localmd_tpu_torch.utils import display
from localmd_tpu_torch.utils.keys import make_jax_random_key, make_key


def truncated_random_svd(input_matrix: torch.Tensor, generator: Optional[torch.Generator],
                         rank: int, num_oversamples: int = DEFAULT_OVERSAMPLES):
    """The reference pmd_loader variant (pmd_loader.py:24-28): an int rank,
    the singular values folded into V; returns (U, V)."""
    u, s, vt = _truncated_random_svd(input_matrix, int(rank), generator=generator,
                                     num_oversamples=num_oversamples)
    return u, s[:, None] * vt


class FrameDataloader(torch.utils.data.Dataset):
    """Frame chunks of a movie (pmd_loader.py:31-56): ``len`` is the number
    of chunks, the final partial chunk merged into the one before; items
    are (d1, d2, t_chunk) numpy arrays. Indexing past the end raises
    ``IndexError`` (ending Python's sequence iteration); negative indices
    count from the end."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = as_dataset(dataset)
        self.batch_size = int(batch_size)
        self._ranges = _chunk_ranges(self.dataset.shape[0], self.batch_size, merge_tail=True)

    def __len__(self) -> int:
        return len(self._ranges)

    def __getitem__(self, index: int) -> np.ndarray:
        n = len(self._ranges)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(f"chunk index {index} out of range")
        a, b = self._ranges[index]
        chunk = self.dataset[slice(a, b)]
        if isinstance(chunk, torch.Tensor):
            chunk = chunk.cpu().numpy()
        return np.asarray(chunk).transpose(1, 2, 0)


def v_projection_inner_loop(dense_projector, sparse_projector, data):
    """P @ (U^T @ X) (pmd_loader.py:59-63): the sparse projector first, so
    the dense mix runs on the small rank axis."""
    return dense_projector @ (sparse_projector @ data)


def v_projection_routine(order: str, dense_projection_term, sparse_projection_term, data,
                         mean_img_r, std_img_r):
    """Flatten a (d1, d2, t) chunk in ``order``, standardize it and regress
    it onto the spatial basis (pmd_loader.py:66-81). The pipeline runs the
    folded one-product form (K2); this keeps the reference's calls."""
    centered = (flatten_fov(data, order) - mean_img_r) / std_img_r
    return v_projection_inner_loop(dense_projection_term, sparse_projection_term, centered)


__all__ = [
    "PMDLoader",
    "FrameDataloader",
    "standardize_and_filter",
    "truncated_random_svd",
    "v_projection_routine",
    "v_projection_inner_loop",
    "display",
    "make_jax_random_key",
    "make_key",
]
