"""Multi-rank plumbing for the PMD pipeline on ``torch.distributed``
(counterpart of localmd_tpu/parallel/multihost.py).

One process per device; every rank calls ``localmd_decomposition`` with the
same arguments and the same mesh and gets back an identical ``PMDArray``.
With more than one rank the stages follow the JAX package's multi-host
design (multihost.py:1-28, docs/ARCHITECTURE.md "Multi-host execution"):

- **statistics pass**: each rank streams its contiguous stripe of whole
  stats chunks through K1; the three accumulators are all-gathered and
  summed in rank order, so every rank holds bit-identical images
  (``loader.PMDLoader._initialize_normalizers``);
- **thresholds, init frames, factorized SVD, final reformat**: run on every
  rank; each is a deterministic function of the seed and the identical
  statistics;
- **block stage**: every block batch is split over the ranks, each rank
  decomposes its contiguous share, and the outputs are all-gathered so
  every rank holds the full panels (``replicate_block_outputs``);
- **V regression**: each rank streams its ceil-division stripe of frames
  through K2 and the stripes are all-gathered (``replicate_frame_sharded``).

With one rank the mesh path runs with one-rank collectives and follows the
JAX single-process mesh; the factorized SVD's Gram then goes through
``sharded.sharded_gram_quadratic``.

Every collective runs on the mesh's group with the tensors on the rank's
device, NCCL's and gloo's alike: with torch 2.11 a gloo group took CUDA
tensors in every collective used here (all-gather into a tensor,
all-reduce sum/max/min, reduce-scatter), so nothing is staged through the
host, and nothing falls back on a failure.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def process_count() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def validate_multihost_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Fail fast, before any streaming (multihost.py:50-82): ``mesh`` must
    be None or a 1-D ``DeviceMesh`` over every rank, and a job of more than
    one rank needs one."""
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"mesh must be a torch.distributed DeviceMesh (parallel.make_mesh()), "
                f"got {type(mesh).__name__}"
            )
        if mesh.ndim != 1:
            raise ValueError(f"mesh must be 1-D, got {mesh.ndim} dimensions")
    n_proc = process_count()
    if mesh is None:
        if n_proc > 1:
            raise ValueError(
                f"This is a {n_proc}-rank torch.distributed job, but no mesh was passed "
                "to localmd_decomposition. Every rank must pass the same mesh over all "
                "ranks: parallel.make_mesh()."
            )
        return
    if mesh.size() != n_proc:
        raise ValueError(
            f"mesh spans {mesh.size()} ranks but the job has {n_proc}: every rank must "
            "take part (parallel.make_mesh())."
        )


def world_and_rank(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(ranks in ``mesh``, this rank's place in it); (1, 0) without one."""
    if mesh is None:
        return 1, 0
    return mesh.size(), mesh.get_local_rank()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's collectives of ``mesh`` use by default."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -- collectives -----------------------------------------------------------------

def all_gather_into(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0, in rank order: (world * n, ...)."""
    x = x.contiguous()
    out = torch.empty((mesh.size() * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.get_group())
    return out


def all_reduce_(mesh: DeviceMesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``x`` ("sum", "max" or "min")."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(x, op=red, group=mesh.get_group())
    return x


def reduce_scatter_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x`` (world * n, ...), this rank keeping rows
    [rank * n, (rank + 1) * n) (JAX's ``psum_scatter(..., tiled=True)``)."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // mesh.size(),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, group=mesh.get_group())
    return out


# -- the pipeline's helpers --------------------------------------------------------

def host_local_to_global(mesh: DeviceMesh, spec, full_array, shard_axis: int = 0):
    """This rank's part of an array every rank holds in full (multihost.py:85-116):
    the array itself for a replicated ``spec``, else this rank's contiguous
    stripe of ``shard_axis`` (its length divisible by the mesh size)."""
    from torch.distributed.tensor import Replicate  # seconds to import: only with a mesh

    if all(isinstance(p, Replicate) for p in spec):
        return full_array
    world, rank = world_and_rank(mesh)
    n = full_array.shape[shard_axis]
    if n % world:
        raise ValueError(f"axis {shard_axis} ({n}) not divisible by the mesh size {world}")
    per = n // world
    idx = [slice(None)] * full_array.ndim
    idx[shard_axis] = slice(rank * per, (rank + 1) * per)
    return full_array[tuple(idx)]


def replicate_block_outputs(mesh: DeviceMesh, *arrays: torch.Tensor) -> tuple:
    """Each rank's block-axis share gathered into the full arrays on every
    rank (multihost.py:119-138): one all-gather per array."""
    if mesh.size() == 1:
        return tuple(arrays)
    return tuple(all_gather_into(mesh, a) for a in arrays)


def replicate_frame_sharded(mesh: DeviceMesh, local: torch.Tensor, t: int) -> torch.Tensor:
    """The full (r, t) array on every rank from each rank's (r, t_local)
    ceil-division stripe of frames (multihost.py:141-175): stripes padded to
    the shard width with zeros, gathered along frames, trimmed to ``t``."""
    world = mesh.size()
    if world == 1:
        return local
    r = local.shape[0]
    shard = -(-t // world)
    padded = torch.zeros((shard, r), dtype=local.dtype, device=local.device)
    padded[: local.shape[1]] = local.T
    return all_gather_into(mesh, padded)[:t].T.contiguous()


def agree_int_min(value: int, mesh: DeviceMesh) -> int:
    """The minimum of a per-rank int over the mesh (multihost.py:178-187):
    every rank must use the same block batch size, which each derives from
    its own free device memory."""
    if mesh.size() == 1:
        return int(value)
    x = torch.tensor([int(value)], dtype=torch.int64, device=mesh_device(mesh))
    return int(all_reduce_(mesh, x, "min").item())
