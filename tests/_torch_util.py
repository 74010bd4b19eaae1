"""Shared helpers for the PyTorch-port tests (tests/test_torch_*.py).

The port's tests feed the same numpy inputs to a ``localmd_tpu`` function
and its ``localmd_tpu_torch`` counterpart and compare the results. Tier-1
runs with six xdist workers, so each worker's torch uses two threads.
"""

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_fro(a, b) -> float:
    """||a - b||_F / ||b||_F in float64."""
    a = to_np(a).astype(np.float64)
    b = to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t32(x) -> torch.Tensor:
    """float32 CPU tensor of ``x``."""
    return torch.as_tensor(np.asarray(x, dtype=np.float32))
