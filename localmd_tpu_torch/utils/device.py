"""Device memory helpers (counterpart of localmd_tpu/utils/device.py, which
shrinks to ``torch.cuda.mem_get_info`` here)."""

from __future__ import annotations

import torch

# bound on one step's transient buffers (the JAX package's floor)
TRANSIENT_FLOOR_BYTES = 1 << 30


def free_bytes(device: torch.device):
    """Free device memory in bytes, or None on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free)
