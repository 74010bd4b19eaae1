"""The PMD phases split over a mesh's ranks (counterpart of
localmd_tpu/parallel/sharded.py, whose ``shard_map`` programs become one
process per rank).

Every function takes the full inputs, which every rank holds alike, runs
this rank's contiguous share of the block or frame axis through the port's
single-device code (and so its kernels), and returns the full result on
every rank:

1. ``sharded_window0_chunk_step``, ``sharded_windowed_pmd`` and
   ``sharded_block_decomposition``: the block axis split; the outputs are
   all-gathered (``multihost.replicate_block_outputs``). The multi-window
   loop agrees on its early stop and fallback tier with one all-reduce a
   window.
2. ``sharded_v_projection_chunk``: the frame axis split; no collective but
   the final gather.
3. ``sharded_gram_quadratic``: right.T (U.T U) right with the block panels
   split; per column slice a local overlap-add, a reduce-scatter that sums
   the overlap seams and leaves each rank its pixel shard, then one
   all-reduce of Z_shard.T Z_shard.

The block axis must be divisible by the mesh size, as in the JAX package.
The sketches come in per block (and window) over the global grid, so a
block's result does not depend on the rank that computes it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from localmd_tpu_torch.parallel.mesh import block_sharding, frame_sharding
from localmd_tpu_torch.parallel.multihost import (
    all_reduce_,
    host_local_to_global,
    reduce_scatter_rows,
    replicate_block_outputs,
    replicate_frame_sharded,
    world_and_rank,
)


def sharded_window0_chunk_step(
    mesh: DeviceMesh,
    data: torch.Tensor,
    starts,
    sketches: torch.Tensor,
    b1: int,
    b2: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    max_consecutive_failures: int,
    spatial_denoiser=None,
    temporal_denoiser=None,
    t_used: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``engine.window0_chunk_step`` with the blocks split (sharded.py:38-86):
    ``data`` (d1, d2, t) whole on every rank, ``starts`` (n, 2) on the host
    and ``sketches`` (n, t', k) split by block. Returns (acc, counts,
    v_fit) for all n blocks."""
    from localmd_tpu_torch.engine import identity, window0_chunk_step

    spec = block_sharding(mesh)
    acc, counts, v_fit = window0_chunk_step(
        data, host_local_to_global(mesh, spec, starts), host_local_to_global(mesh, spec, sketches),
        b1, b2, max_rank, temporal_avg_factor, spatial_avg_factor, spatial_threshold,
        temporal_threshold, max_consecutive_failures,
        spatial_denoiser if spatial_denoiser is not None else identity,
        temporal_denoiser if temporal_denoiser is not None else identity,
        t_used,
    )
    return replicate_block_outputs(mesh, acc, counts, v_fit)


def sharded_windowed_pmd(
    mesh: DeviceMesh,
    patches: torch.Tensor,
    sketches: torch.Tensor,
    spatial_threshold,
    temporal_threshold,
    *,
    n_windows: int,
    window_length: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    max_consecutive_failures: int,
    spatial_denoiser=None,
    temporal_denoiser=None,
    residual_span=contextlib.nullcontext,
):
    """The multi-window loop with the blocks split (sharded.py:89-137).

    ``patches`` (n, b1, b2, t), ``sketches`` (n_windows, n, t', k). Each
    rank runs the loop on its share; once a window the ranks all-reduce
    (max) ``[-min(counts), zero-count blocks]``, JAX's ``pmin`` of the early
    stop and ``pmax`` of the fallback tier, so they stop together. Returns
    ``engine.WindowedPMDResult`` for all n blocks."""
    from localmd_tpu_torch.engine import WindowedPMDResult, _windowed_loop, identity

    res = _windowed_loop(
        host_local_to_global(mesh, block_sharding(mesh), patches),
        host_local_to_global(mesh, frame_sharding(mesh), sketches, shard_axis=1),
        window_length, n_windows, max_rank, spatial_threshold, temporal_threshold,
        max_consecutive_failures, temporal_avg_factor, spatial_avg_factor,
        spatial_denoiser if spatial_denoiser is not None else identity,
        temporal_denoiser if temporal_denoiser is not None else identity,
        agree=lambda stat: all_reduce_(mesh, stat, "max"),
        residual_span=residual_span,
    )
    acc, counts, temporal = replicate_block_outputs(mesh, res.spatial, res.counts, res.temporal)
    return WindowedPMDResult(acc, counts, temporal, res.windows_run, res.fallback)


def sharded_block_decomposition(
    mesh: DeviceMesh,
    local_fn: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]],
    patches: torch.Tensor,
    sketches: torch.Tensor,
) -> tuple:
    """``local_fn(patches_share, sketches_share)`` on this rank's blocks
    (sharded.py:140-161), e.g. a partial of
    ``engine.single_block_md_batched``; its outputs gathered by block.
    ``patches`` (n, b1, b2, t), ``sketches`` (n, t', k)."""
    spec = block_sharding(mesh)
    out = local_fn(host_local_to_global(mesh, spec, patches),
                   host_local_to_global(mesh, spec, sketches))
    return replicate_block_outputs(mesh, *out)


def sharded_v_projection_chunk(
    mesh: DeviceMesh,
    panels: torch.Tensor,
    rows: torch.Tensor,
    dense_basis: torch.Tensor,
    p_matrix: torch.Tensor,
    chunk_flat: torch.Tensor,
    mean_flat: torch.Tensor,
    std_flat: torch.Tensor,
) -> torch.Tensor:
    """V chunk = P^T U^T standardize(X) with the frames split
    (sharded.py:164-196). ``chunk_flat`` (d, t_c) raw frames, pixels in
    the rows' order; each rank takes a ceil-division stripe of frames, and
    the (r', t_c) result is gathered along frames."""
    world, rank = world_and_rank(mesh)
    t_c = chunk_flat.shape[1]
    shard = -(-t_c // world)
    chunk_l = chunk_flat[:, min(rank * shard, t_c): min((rank + 1) * shard, t_c)]
    x = (chunk_l - mean_flat[:, None]) / std_flat[:, None]
    block_part = (panels.transpose(-1, -2) @ x[rows]).reshape(-1, x.shape[1])   # (n * S, t_l)
    utx = torch.cat([block_part, dense_basis.T @ x], dim=0)
    return replicate_frame_sharded(mesh, p_matrix.T @ utx, t_c)


def sharded_gram_quadratic(
    mesh: DeviceMesh,
    panels: torch.Tensor,
    rows: torch.Tensor,
    dense_basis: torch.Tensor,
    right: torch.Tensor,
    n_pixels: int,
    col_chunk: int = 1024,
    cosets=None,
    coset_info=None,
    block_shape=None,
) -> torch.Tensor:
    """Symmetrized right.T (U.T U) right with the block panels split
    (sharded.py:199-275), in bounded memory per rank.

    For each ``col_chunk`` slice of ``right``'s columns, each rank
    overlap-adds its blocks' part of Z = U @ right into a (p_pad, mc)
    buffer; a reduce-scatter sums the seams and leaves the rank its pixel
    shard of the slice; the background term, which every rank holds, is
    added on that shard only (before the scatter it would be summed once a
    rank). The (m, m) result is one all-reduce of Z_shard.T Z_shard.

    ``cosets`` (``BlockGrid.cosets()``'s block ids: groups of blocks that
    share no pixel) orders the overlap-add as ``BlockSparseMatrix.matmul``
    does (``blocksparse.coset_overlap_add``), so a run repeats bit for bit
    and one rank gives ``gram_quadratic``'s bits; None makes each block its
    own group (one scatter a block). With the grid's ``coset_info``
    (``BlockGrid.coset_info``) and ``block_shape`` each rank places its
    share of every coset by reshape and permute, the lattice places of
    other ranks' blocks left zero (``blocksparse.coset_placement``)."""
    from localmd_tpu_torch.blocksparse import coset_order, coset_overlap_add, coset_placement

    world, rank = world_and_rank(mesh)
    n_blocks, _, slots = panels.shape
    if n_blocks % world:
        raise ValueError(f"{n_blocks} blocks are not divisible by the mesh size {world}")
    m = right.shape[1]
    nb_l = n_blocks // world
    shard_rows = -(-n_pixels // world)
    p_pad = shard_rows * world
    lo, hi = rank * shard_rows, min((rank + 1) * shard_rows, n_pixels)
    bg_shard = dense_basis.new_zeros((shard_rows, dense_basis.shape[1]))
    bg_shard[: max(hi - lo, 0)] = dense_basis[lo:hi]
    order, bounds = coset_order(cosets if cosets is not None else [[b] for b in range(n_blocks)],
                                rank * nb_l, (rank + 1) * nb_l)
    placement = None
    if cosets is not None and coset_info is not None and block_shape is not None:
        placement = coset_placement(cosets, coset_info, block_shape, rank * nb_l,
                                    (rank + 1) * nb_l, panels.device)
    perm = torch.as_tensor(order, device=panels.device)
    panels_l = panels[rank * nb_l: (rank + 1) * nb_l].index_select(0, perm)
    rows_l = rows[rank * nb_l: (rank + 1) * nb_l].long().index_select(0, perm)
    right_l = right[rank * nb_l * slots: (rank + 1) * nb_l * slots].reshape(nb_l, slots, m)
    right_l = right_l.index_select(0, perm)
    right_bg = right[n_blocks * slots:]
    z_shard = torch.empty((shard_rows, m), dtype=torch.float32, device=right.device)
    for c0 in range(0, m, col_chunk):
        c1 = min(c0 + col_chunk, m)
        zc = coset_overlap_add(panels_l, rows_l, right_l[:, :, c0:c1], n_pixels, bounds, placement)
        if p_pad > n_pixels:
            zc = torch.cat([zc, zc.new_zeros((p_pad - n_pixels, c1 - c0))])
        zc = reduce_scatter_rows(mesh, zc)                                        # (shard_rows, mc)
        z_shard[:, c0:c1] = zc + bg_shard @ right_bg[:, c0:c1]
    quad = all_reduce_(mesh, z_shard.T @ z_shard, "sum")
    return 0.5 * (quad + quad.T)
