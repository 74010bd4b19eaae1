"""Device memory helpers (counterpart of localmd_tpu/utils/device.py, which
shrinks to ``torch.cuda`` queries here)."""

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


def transient_budget_bytes(device) -> int:
    """Per-call transient-buffer budget scaled to the card: its memory / 16,
    floored at 1 GiB (utils/device.py:36-60). The CPU keeps the floor, so
    test behaviour does not depend on the host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return TRANSIENT_FLOOR_BYTES
    total = torch.cuda.get_device_properties(dev).total_memory
    return max(TRANSIENT_FLOOR_BYTES, int(total // 16))


def is_device_oom(e: BaseException) -> bool:
    """True iff ``e`` is the allocator's out-of-memory error."""
    return isinstance(e, torch.cuda.OutOfMemoryError)
