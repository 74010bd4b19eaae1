"""Device memory helpers (counterpart of localmd_tpu/utils/device.py, which
shrinks to ``torch.cuda`` queries here)."""

from __future__ import annotations

import torch

# bound on one step's transient buffers (the JAX package's floor)
TRANSIENT_FLOOR_BYTES = 1 << 30


def device_free_bytes(device, assumed_live_bytes: int = 0, pending_bytes: int = 0):
    """Memory this process can still allocate on ``device``, or None on the
    CPU (utils/device.py:69-96): ``mem_get_info``'s free bytes plus the caching
    allocator's reserved but unallocated bytes, less ``pending_bytes``
    (buffers that will be live at dispatch but are not allocated yet). This
    is JAX's ``bytes_limit - bytes_in_use`` in the allocator's terms: the
    blocks a stream has cached are free to the next allocation, so the
    count does not depend on what an earlier call left cached.
    ``assumed_live_bytes`` has no effect: JAX subtracts it only from a
    device's nominal memory when its runtime reports none, and the card
    always reports its memory."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    # one query of the allocator: memory_reserved and memory_allocated each
    # flatten every statistic into a Python dict (1-2 ms a call on an H100)
    stats = torch.cuda.memory_stats_as_nested_dict(dev)
    cached = stats["reserved_bytes"]["all"]["current"] - stats["allocated_bytes"]["all"]["current"]
    return int(free + cached - pending_bytes)


def block_batch_budget(
    device,
    *,
    per_block_bytes: int,
    n_blocks: int,
    block_batch_size: int,
    assumed_live_bytes: int = 0,
    pending_bytes: int = 0,
) -> int:
    """The block stage's batch size (utils/device.py:99-142): as many blocks
    as 40% of ``device_free_bytes`` holds at ``per_block_bytes`` each (1 GB
    when that is more, and on the CPU), at least 16, at most
    ``block_batch_size`` and ``n_blocks``; a batch below ``n_blocks`` is
    rounded down to a power of two, so memory left free by an earlier call
    does not change the batches. Where JAX raises a batch below 16 to 16,
    this keeps a caller's ``block_batch_size`` below 16 and never exceeds
    ``n_blocks``: both mean the same batches. Mesh rounding stays with the
    caller. ``assumed_live_bytes`` has no effect (``device_free_bytes``)."""
    budget = int(1e9)
    free = device_free_bytes(device, pending_bytes=pending_bytes)
    if free is not None:
        budget = max(budget, int(free * 0.4))
    bb = max(1, min(block_batch_size, n_blocks, max(16, budget // per_block_bytes)))
    if bb < n_blocks:
        bb = 1 << (bb.bit_length() - 1)
    return int(bb)


def transient_budget_bytes(device=None) -> int:
    """Per-call transient-buffer budget scaled to the card: its memory / 16,
    floored at 1 GiB (utils/device.py:36-66). ``None`` is the current CUDA
    device when there is one, else the CPU. The CPU keeps the floor, so
    test behaviour does not depend on the host."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return TRANSIENT_FLOOR_BYTES
    total = torch.cuda.get_device_properties(dev).total_memory
    return max(TRANSIENT_FLOOR_BYTES, int(total // 16))


def is_device_oom(e: BaseException) -> bool:
    """True iff ``e`` is the allocator's out-of-memory error."""
    return isinstance(e, torch.cuda.OutOfMemoryError)
