"""In-memory movie sources (counterpart of localmd_tpu/dataset.py for numpy
arrays and tensors; file-backed sources are not ported yet).

A torch tensor on the card is the counterpart of the JAX package's
``DeviceMovie``: the loader slices frames on the device and nothing crosses
the host link.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class NumpyArray:
    """A (T, d1, d2) ndarray; frames cross to the device chunk by chunk."""

    def __init__(self, array: np.ndarray):
        array = np.asarray(array)
        if array.ndim != 3:
            raise ValueError("NumpyArray expects a (T, d1, d2) array")
        self._array = array

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self._array.shape)

    def frames(self, rng: slice, device: torch.device) -> torch.Tensor:
        """Contiguous frame range as a native-dtype tensor on ``device``."""
        return torch.from_numpy(np.ascontiguousarray(self._array[rng])).to(device)

    def gather(self, idx, device: torch.device) -> torch.Tensor:
        """Frames at the (sorted) indices ``idx`` on ``device``."""
        return torch.from_numpy(np.ascontiguousarray(self._array[np.asarray(idx)])).to(device)


class TensorMovie:
    """A (T, d1, d2) tensor, float32 or uint16, on any device."""

    def __init__(self, array: torch.Tensor):
        if array.dim() != 3:
            raise ValueError("TensorMovie expects a (T, d1, d2) tensor")
        self._array = array.contiguous()

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self._array.shape)

    def frames(self, rng: slice, device: torch.device) -> torch.Tensor:
        return self._array[rng].to(device)

    def gather(self, idx, device: torch.device) -> torch.Tensor:
        arr = self._array
        index = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=arr.device)
        if arr.dtype == torch.uint16:
            # PyTorch covers uint16 with few kernels; gather the same bits
            # as int16, which every backend indexes
            return arr.view(torch.int16).index_select(0, index).view(torch.uint16).to(device)
        return arr.index_select(0, index).to(device)


def as_dataset(obj):
    """Normalize user input (ndarray | tensor | dataset object)."""
    if isinstance(obj, (NumpyArray, TensorMovie)):
        return obj
    if isinstance(obj, torch.Tensor):
        return TensorMovie(obj)
    if isinstance(obj, np.ndarray):
        return NumpyArray(obj)
    raise TypeError(
        f"Cannot interpret {type(obj)} as a PMD dataset: the port takes "
        "in-memory numpy arrays and torch tensors"
    )
