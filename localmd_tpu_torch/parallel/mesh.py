"""Device mesh helpers for the PMD pipeline on ``torch.distributed``
(counterpart of localmd_tpu/parallel/mesh.py).

One process per device, as ``torchrun`` starts them: the mesh is a 1-D
``DeviceMesh`` over every rank of the job, its one dimension named
``BLOCK_AXIS``. The block grid is split over it (each rank decomposes a
contiguous share of every block batch) and the two whole-movie passes are
striped over it (each rank streams its own frames); see ``multihost`` for
the stages and ``sharded`` for the split functions.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from localmd_tpu_torch.config import resolve_device

if TYPE_CHECKING:
    from torch.distributed.tensor import Placement

# ``torch.distributed.tensor`` (DTensor) is imported only by the functions
# that build placements: importing it takes seconds, and a run without a
# mesh never needs it.

BLOCK_AXIS = "blocks"


def local_device_index() -> int:
    """The CUDA device this rank computes on: ``LOCAL_RANK`` (torchrun's;
    the global rank without it) modulo the visible device count, so ranks
    that outnumber the cards share them."""
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return local % torch.cuda.device_count()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = BLOCK_AXIS,
              device="cuda") -> DeviceMesh:
    """1-D mesh over every rank of the job (mesh.py:30-35).

    Without a default process group, joins one from the ``torchrun``
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``): NCCL for ``device="cuda"``, gloo for ``device="cpu"``.
    A group the caller made first is used as it is. On the card, this
    rank's device (``local_device_index``) becomes the current device.
    ``n_devices`` other than None or the world size raises: a mesh that
    leaves a rank out is what ``multihost.validate_multihost_mesh`` refuses.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices}, but the job has {world} ranks: the mesh spans "
            "every rank (one device per rank)"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(local_device_index())
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


def block_sharding(mesh: DeviceMesh) -> List[Placement]:
    """Split the leading (n_blocks) axis over ``mesh`` (mesh.py:38-40)."""
    from torch.distributed.tensor import Shard

    return [Shard(0)]


def frame_sharding(mesh: DeviceMesh) -> List[Placement]:
    """Split the trailing frames axis of a (pixels, frames) chunk (mesh.py:43-45)."""
    from torch.distributed.tensor import Shard

    return [Shard(1)]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    from torch.distributed.tensor import Replicate

    return [Replicate()]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
