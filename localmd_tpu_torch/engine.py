"""Batched per-block PMD decomposition (counterpart of localmd_tpu/engine.py).

- ``single_block_md_batched``: the first-window decomposition of a batch of
  blocks (engine.py:76-147).
- ``single_residual_block_md_batched``: further components orthogonal to
  each block's accumulated basis (engine.py:151-178).
- ``_pack_components_route`` / ``pack_components``: the failure filter plus
  one-hot routing of kept components into per-block slots
  (engine.py:182-239).
- ``window0_chunk_step``: gather -> decompose -> pack for one batch of
  blocks (engine.py:250-301); the JAX package's CPU reference path.
- ``window0_coset_stage`` and its plan, eligibility and memory estimate:
  the same first-window stage over the coset lattices of the grid with no
  patch gather (engine.py:304-591), behind ``COSET_STAGE`` ("auto": on for
  the card).
- ``windowed_pmd_batched``: the multi-window block stage (engine.py:593-903)
  as a Python loop over windows, with the host reading two scalars per
  window (early stop, fallback tier) where JAX keeps them on the device;
  with ``mesh`` the blocks are split over the ranks
  (``parallel.sharded_windowed_pmd``). Each window is an ``engine.window``
  span and each read an ``engine.window_wait`` span (host ranges of the
  profiler's trace while it runs).
- ``threshold_heuristic``: the noise-null Monte-Carlo for the roughness
  cutoffs (engine.py:911-1060), memoized on a caller's ``cache_token``;
  ``jnp.percentile`` becomes ``torch.quantile`` with linear interpolation.

``vmap`` is an explicit leading block axis throughout, except for the
user's denoisers: they are written for one block and mapped over the block
axis with ``torch.func.vmap``, as the JAX package maps them with
``jax.vmap``. A denoiser must be made of pure torch operations: no
``.item()`` or other read of a value to the host, no in-place write to its
input, no data-dependent Python control flow. ``torch.func.vmap`` raises
for such a denoiser; nothing catches that and falls back to a loop.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device, route_enabled
from localmd_tpu_torch.ops.linalg import (
    DEFAULT_OVERSAMPLES,
    _rsvd_core,
    batched_truncated_random_svd,
    cholesky_qr2,
    svd_gram_left,
)
from localmd_tpu_torch.ops.pooling import downsample_average_pooling
from localmd_tpu_torch.ops.roughness import (
    evaluate_fitness,
    filter_by_failures,
    spatial_roughness_stat,
    temporal_roughness_stat,
)
from localmd_tpu_torch.ops.tiling import block_grid, extract_patches, flatten_fov, unflatten_fov
from localmd_tpu_torch.parallel.multihost import validate_multihost_mesh
from localmd_tpu_torch.parallel.sharded import sharded_windowed_pmd
from localmd_tpu_torch.utils.logging import span
from localmd_tpu_torch.utils.random import normal, random_draws_are_live


def _bin_consecutive(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average consecutive groups of ``factor`` frames: (..., t) -> (..., t//factor)."""
    *lead, t = x.shape
    return x.reshape(*lead, t // factor, factor).mean(dim=-1)


def identity(x: torch.Tensor) -> torch.Tensor:
    """The denoiser that changes nothing (engine.py:67-68); ``None`` in
    ``localmd_decomposition`` maps to it."""
    return x


def single_block_md_batched(
    blocks: torch.Tensor,
    sketches: torch.Tensor,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
):
    """First-window decomposition of every block at once.

    blocks: (n, b1, b2, t) standardized patches; sketches: (n, t', k) rSVD
    sketches for the binned (t' = t // temporal_avg_factor) coarse problem.
    ``temporal_denoiser`` maps one block's (r, t) coarse traces to the same
    shape, ``spatial_denoiser`` one block's (r, b1, b2) component images;
    each is mapped over the block axis (engine.py:84-131).
    Returns u (n, b1*b2, r) F-order orthonormal bases, decisions (n, r)
    int32 and v (n, r, t) with the singular values folded in."""
    _, b1, b2, _ = blocks.shape
    down = downsample_average_pooling(blocks, spatial_avg_factor)
    down_flat = flatten_fov(down)                                    # (n, p', t)
    down_avg = _bin_consecutive(down_flat, temporal_avg_factor)
    u_coarse = batched_truncated_random_svd(down_avg, max_rank, sketch=sketches)[0]
    v_coarse = u_coarse.transpose(-1, -2) @ down_flat                # (n, r, t)
    if temporal_denoiser is not identity:
        v_coarse = torch.func.vmap(temporal_denoiser)(v_coarse)
    # any orthonormal basis of v_coarse's row space serves, unless a spatial
    # denoiser acts per component on the images this basis defines: then
    # the Gram SVD's basis, as the JAX package keeps it (engine.py:111-123)
    if spatial_denoiser is identity:
        v_basis = cholesky_qr2(v_coarse.transpose(-1, -2)).transpose(-1, -2)
    else:
        v_basis = svd_gram_left(v_coarse)[2]

    blocks_flat = flatten_fov(blocks)                                # (n, p, t)
    spatial_proj = blocks_flat @ v_basis.transpose(-1, -2)           # (n, p, r)
    if spatial_denoiser is not identity:
        proj_img = unflatten_fov(spatial_proj, b1, b2)               # (n, b1, b2, r)
        proj_img = torch.func.vmap(lambda im: spatial_denoiser(im.movedim(-1, 0)))(proj_img)
        spatial_proj = flatten_fov(proj_img.movedim(1, -1))          # (n, r, b1, b2) -> (n, p, r)
    u_final = cholesky_qr2(spatial_proj)
    v_new = u_final.transpose(-1, -2) @ blocks_flat                  # (n, r, t)
    v_left, v_sing, v_right = svd_gram_left(v_new)
    u_final = u_final @ v_left
    v_final = v_sing[..., :, None] * v_right

    u_img = unflatten_fov(u_final, b1, b2)                           # (n, b1, b2, r)
    decisions = evaluate_fitness(
        u_img.movedim(-1, 1), v_final, spatial_threshold, temporal_threshold
    )
    return u_final, decisions, v_final


def single_residual_block_md_batched(
    blocks: torch.Tensor,
    existing: torch.Tensor,
    sketches: torch.Tensor,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
):
    """Further components of each block orthogonal to its accumulated basis.

    existing: (n, b1*b2, S) zero-padded bases (zero slots project out
    nothing); sketches: (n, t', k) for the binned residual. Returns
    (u (n, p, r), decisions (n, r), v (n, r, t))."""
    _, b1, b2, _ = blocks.shape
    blocks_flat = flatten_fov(blocks)
    coeff = existing.transpose(-1, -2) @ blocks_flat                 # (n, S, t)
    resid = blocks_flat - existing @ coeff
    resid_avg = _bin_consecutive(resid, temporal_avg_factor)
    u = batched_truncated_random_svd(resid_avg, max_rank, sketch=sketches)[0]
    v = u.transpose(-1, -2) @ resid
    decisions = evaluate_fitness(
        unflatten_fov(u, b1, b2).movedim(-1, 1), v, spatial_threshold, temporal_threshold
    )
    return u, decisions, v


def _pack_components_route(
    u_new: torch.Tensor,
    v_new: Optional[torch.Tensor],
    decisions: torch.Tensor,
    acc: torch.Tensor,
    counts: torch.Tensor,
    max_consecutive_failures: int,
):
    """Write each kept component of block b into slot ``counts[b] + (rank
    among kept)`` with a one-hot matmul, optionally routing the temporal
    components through the same one-hot (then ``v_fit == acc^T @ X``)."""
    slots = acc.shape[-1]
    keep = filter_by_failures(decisions > 0, max_consecutive_failures)
    target = counts[:, None] + torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    valid = keep & (target < slots)
    onehot = (
        valid[..., None]
        & (target[..., None] == torch.arange(slots, device=acc.device)[None, None, :])
    ).to(u_new.dtype)                                                # (n, r, S)
    acc = acc + u_new @ onehot
    counts = counts + valid.sum(dim=-1).to(counts.dtype)
    v_fit = None
    if v_new is not None:
        v_fit = onehot.transpose(-1, -2) @ v_new                     # (n, S, t)
    return acc, counts, v_fit


def pack_components(u_new, decisions, acc, counts, max_consecutive_failures: int):
    """Route kept components into the accumulator: (acc, counts)."""
    acc, counts, _ = _pack_components_route(
        u_new, None, decisions, acc, counts, max_consecutive_failures
    )
    return acc, counts


def temporal_projector_batched(spatial: torch.Tensor, blocks_flat: torch.Tensor) -> torch.Tensor:
    """(n, p, S)^T @ (n, p, t) -> (n, S, t)."""
    return spatial.transpose(-1, -2) @ blocks_flat


def window0_chunk_step(
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
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
    t_used: int = 0,
):
    """One batch of blocks: patch gather -> decomposition -> failure filter
    + packing. data (d1, d2, t); starts (n, 2); sketches (n, t', k).
    Returns (acc (n, b1*b2, max_rank), counts (n,) int32, v_fit (n, max_rank, t))."""
    patches = extract_patches(data, starts, b1, b2)
    if t_used and t_used < patches.shape[-1]:
        patches = patches[..., :t_used]
    u, decisions, v = single_block_md_batched(
        patches, sketches, max_rank, temporal_avg_factor, spatial_avg_factor,
        spatial_threshold, temporal_threshold, spatial_denoiser, temporal_denoiser,
    )
    n = patches.shape[0]
    acc = torch.zeros((n, b1 * b2, max_rank), dtype=patches.dtype, device=patches.device)
    counts = torch.zeros((n,), dtype=torch.int32, device=patches.device)
    return _pack_components_route(u, v, decisions, acc, counts, max_consecutive_failures)


# ---------------------------------------------------------------------------
# Coset block stage (gather-free)
# ---------------------------------------------------------------------------
#
# The half-overlap block grid is a union of <= 4 lattices of disjoint
# blocks (offsets {0, b/2} x {0, b/2}); within one lattice the blocks tile
# the FOV without overlap, so the patch tensor of a coset is a slice and
# reshape of the init movie, with no gather (engine.py:304-591). Blocks
# off the lattices (the snapped tail of a FOV the blocks do not divide)
# run through the gather path. "auto" turns the stage on for the card and
# off on the CPU (config.route_enabled); True or False force it.
COSET_STAGE = "auto"


def coset_stage_supported(b1: int, b2: int, spatial_avg_factor: int) -> bool:
    """The geometry the coset stage needs (engine.py:323-336): even blocks
    (the lattices exist), savg | b (pooling a block equals pooling the FOV
    over it) and savg | b/2 (lattice offsets fall on pooling windows)."""
    sa = spatial_avg_factor
    return (
        b1 % 2 == 0 and b2 % 2 == 0
        and b1 % sa == 0 and b2 % sa == 0
        and (b1 // 2) % sa == 0 and (b2 // 2) % sa == 0
    )


def coset_stage_eligible(b1: int, b2: int, spatial_avg_factor: int, spatial_denoiser,
                         temporal_denoiser, checkpoint_path, device="cuda") -> bool:
    """The options' and the geometry's part of the coset dispatch
    (engine.py:339-370): no checkpoint, identity denoisers, a supported
    geometry and ``COSET_STAGE`` on for ``device``. The pipeline adds one
    window, no mesh, a plan (``coset_stage_plan``) and the memory gate."""
    return (
        checkpoint_path is None
        and spatial_denoiser is identity
        and temporal_denoiser is identity
        and coset_stage_supported(b1, b2, spatial_avg_factor)
        and route_enabled(COSET_STAGE, device)
    )


def coset_stage_transient_bytes(d1: int, d2: int, t: int, b1: int, b2: int, max_rank: int,
                                temporal_avg_factor: int, spatial_avg_factor: int,
                                n_sel: int) -> int:
    """Peak transient bytes of the coset stage beside the init movie
    (engine.py:373-411): the binned and pooled FOV copies, the outputs of
    every coset, one coset's intermediates, and one movie-sized copy of a
    coset view (the strided copy ``window0_coset_stage`` makes for its two
    full-resolution products)."""
    d = d1 * d2
    sa = spatial_avg_factor
    tb = max(1, t // max(1, temporal_avg_factor))
    p = b1 * b2
    n_big = max(1, -(-n_sel // 3))
    binned = d * tb * 4
    pooled = (d // (sa * sa)) * t * 4
    acc_total = n_sel * p * max_rank * 4
    v_total = n_sel * max_rank * t * 4
    per_coset_extra = 2 * n_big * p * max_rank * 4 + 3 * n_big * max_rank * t * 4
    view_copy = d * t * 4
    return binned + pooled + acc_total + v_total + per_coset_extra + view_copy


def coset_stage_plan(d1: int, d2: int, b1: int, b2: int):
    """The block grid as regular coset lattices plus a remainder
    (engine.py:414-459): ``(meta, ids, remainder)`` with ``meta`` a tuple of
    (r_off, c_off, nr, nc) per lattice, ``ids`` the block ids in lattice
    order (row-major within a lattice) and ``remainder`` the ids on no
    lattice; None when the grid has none (odd blocks)."""
    if b1 % 2 or b2 % 2:
        return None
    grid = block_grid(d1, d2, (b1, b2))
    s1, s2 = b1 // 2, b2 // 2
    id_of = {(int(r), int(c)): i for i, (r, c) in enumerate(np.asarray(grid.starts))}
    used = np.zeros(grid.n_blocks, bool)
    meta, id_parts = [], []
    for g1 in (0, 1):
        for g2 in (0, 1):
            r_off, c_off = g1 * s1, g2 * s2
            nr = (d1 - r_off) // b1
            nc = (d2 - c_off) // b2
            if nr <= 0 or nc <= 0:
                continue
            ids = []
            for a in range(nr):
                for c in range(nc):
                    i = id_of.get((r_off + a * b1, c_off + c * b2))
                    if i is None or used[i]:
                        ids = None
                        break
                    ids.append(i)
                if ids is None:
                    break
            if ids is None:
                continue
            used[np.asarray(ids)] = True
            meta.append((r_off, c_off, nr, nc))
            id_parts.append(np.asarray(ids, np.int64))
    if not meta:
        return None
    return tuple(meta), np.concatenate(id_parts), np.where(~used)[0]


def _pool_fov(x: torch.Tensor, sa: int) -> torch.Tensor:
    """VALID sa x sa average pooling of a (d1, d2, t) field of view."""
    d1, d2, t = x.shape
    e1, e2 = d1 // sa, d2 // sa
    return x[: e1 * sa, : e2 * sa].reshape(e1, sa, e2, sa, t).sum(dim=(1, 3)) * (1.0 / (sa * sa))


def window0_coset_stage(
    data: torch.Tensor,
    sketches: torch.Tensor,
    meta: tuple,
    b1: int,
    b2: int,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    max_consecutive_failures: int,
    t_used: int = 0,
):
    """The single-window block stage over the coset lattices, with no patch
    gather (engine.py:462-591).

    The whole FOV is binned and pooled once; per lattice, the blocks are a
    slice-and-reshape view of the movie and of the pooled copies, the
    batched rSVD runs on the pooled, binned view, the coarse temporal
    product is a ``torch.einsum`` on the pooled view, and the two products
    that touch the full-resolution movie share one strided copy of the
    lattice's view (the one movie-sized copy that
    ``coset_stage_transient_bytes`` counts). Then
    CholeskyQR2, ``svd_gram_left`` (K4 on the card), the roughness test and
    the packing, as ``window0_chunk_step``. Pixels go in C order within a
    block and the panels are turned to F order at the end.

    data (d1, d2, t) standardized init frames; sketches (n_sel, t', k),
    one per block in ``coset_stage_plan``'s ``ids`` order; meta from
    ``coset_stage_plan``. Needs identity denoisers, savg | b and
    t_used % temporal_avg_factor == 0. Returns (acc (n_sel, b1*b2,
    max_rank), counts (n_sel,), v_fit (n_sel, max_rank, t))."""
    if t_used and t_used < data.shape[-1]:
        data = data[:, :, :t_used]
    d1, d2, t = data.shape
    tavg, sa = temporal_avg_factor, spatial_avg_factor
    tb = t // tavg
    hb1, hb2 = b1 // sa, b2 // sa
    binned = data[:, :, : tb * tavg].reshape(d1, d2, tb, tavg).mean(dim=-1)
    pooled_g = _pool_fov(data, sa)
    pooled_binned_g = _pool_fov(binned, sa)
    del binned

    accs, counts_l, vfits = [], [], []
    off = 0
    for r_off, c_off, nr, nc in meta:
        n_g = nr * nc
        sk = sketches[off: off + n_g]
        off += n_g
        view = data[r_off: r_off + nr * b1, c_off: c_off + nc * b2].reshape(nr, b1, nc, b2, t)
        hr, hc = r_off // sa, c_off // sa
        down_avg = (
            pooled_binned_g[hr: hr + nr * hb1, hc: hc + nc * hb2]
            .reshape(nr, hb1, nc, hb2, tb).permute(0, 2, 1, 3, 4).reshape(n_g, hb1 * hb2, tb)
        )
        u_c = batched_truncated_random_svd(down_avg, max_rank, sketch=sk)[0]
        pooled = pooled_g[hr: hr + nr * hb1, hc: hc + nc * hb2].reshape(nr, hb1, nc, hb2, t)
        ucg = u_c.reshape(nr, nc, hb1, hb2, max_rank)
        v_coarse = torch.einsum("aicjt,acijr->acrt", pooled, ucg).reshape(n_g, max_rank, t)
        v_basis = cholesky_qr2(v_coarse.transpose(-1, -2)).transpose(-1, -2)
        # the coset's blocks as one (n_g, b1*b2, t) layout, C order within a
        # block: a strided copy of the view, made once for both products
        # (an einsum on the view would make it once per product)
        blocks_c = view.permute(0, 2, 1, 3, 4).reshape(n_g, b1 * b2, t)
        spatial_proj = blocks_c @ v_basis.transpose(-1, -2)            # (n_g, p, r)
        u_final = cholesky_qr2(spatial_proj)
        v_new = u_final.transpose(-1, -2) @ blocks_c                    # (n_g, r, t)
        del blocks_c
        v_left, v_sing, v_right = svd_gram_left(v_new)
        u_final = u_final @ v_left
        v_final = v_sing[..., :, None] * v_right
        u_img = u_final.reshape(n_g, b1, b2, max_rank)                 # (i, j) image
        decisions = evaluate_fitness(
            u_img.movedim(-1, 1), v_final, spatial_threshold, temporal_threshold
        )
        # panel rows are F order within the block (BlockGrid.rows)
        u_f = u_img.transpose(1, 2).reshape(n_g, b1 * b2, max_rank)
        acc0 = torch.zeros((n_g, b1 * b2, max_rank), dtype=data.dtype, device=data.device)
        c0 = torch.zeros((n_g,), dtype=torch.int32, device=data.device)
        acc, cnt, v_fit = _pack_components_route(
            u_f, v_final, decisions, acc0, c0, max_consecutive_failures
        )
        accs.append(acc)
        counts_l.append(cnt)
        vfits.append(v_fit)
    return torch.cat(accs), torch.cat(counts_l), torch.cat(vfits)


# ---------------------------------------------------------------------------
# Multi-window block stage
# ---------------------------------------------------------------------------

def _md_pack_step(
    window, sketches, acc, counts, max_rank, temporal_avg_factor, spatial_avg_factor,
    spatial_threshold, temporal_threshold, max_consecutive_failures,
    spatial_denoiser: Callable = identity, temporal_denoiser: Callable = identity,
):
    """Window-0 decomposition + failure filter + packing: (acc, counts)."""
    u, decisions, _ = single_block_md_batched(
        window, sketches, max_rank, temporal_avg_factor, spatial_avg_factor,
        spatial_threshold, temporal_threshold, spatial_denoiser, temporal_denoiser,
    )
    return pack_components(u, decisions, acc, counts, max_consecutive_failures)


def _fallback_rerun(
    window: torch.Tensor,
    sketches: torch.Tensor,
    u_r: torch.Tensor,
    dec_r: torch.Tensor,
    is_zero: torch.Tensor,
    n_zero: int,
    fallback_cap: int,
    *,
    max_rank: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_threshold,
    temporal_threshold,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
):
    """Replace the residual results of blocks that still hold no component
    with the full two-stage kernel's (reference decomposition.py:476-488).

    Tiers, chosen from the host count ``n_zero``: none; up to
    ``fallback_cap`` zero blocks -> the full kernel on a cap-sized gather
    (zero blocks first, in index order), scattered back; more -> the full
    kernel on every block with a per-block selection. The gathered tier
    gives the full tier's output."""
    n = window.shape[0]
    if n_zero == 0:
        return u_r, dec_r
    kw = dict(
        max_rank=max_rank, temporal_avg_factor=temporal_avg_factor,
        spatial_avg_factor=spatial_avg_factor, spatial_threshold=spatial_threshold,
        temporal_threshold=temporal_threshold, spatial_denoiser=spatial_denoiser,
        temporal_denoiser=temporal_denoiser,
    )
    if fallback_cap < n and n_zero <= fallback_cap:
        idx = torch.argsort((~is_zero).to(torch.int8), stable=True)[:fallback_cap]
        u_f, dec_f, _ = single_block_md_batched(window[idx], sketches[idx], **kw)
        sel = is_zero[idx]
        u_new, dec_new = u_r.clone(), dec_r.clone()
        u_new[idx] = torch.where(sel[:, None, None], u_f, u_r[idx])
        dec_new[idx] = torch.where(sel[:, None], dec_f, dec_r[idx])
        return u_new, dec_new
    u_f, dec_f, _ = single_block_md_batched(window, sketches, **kw)
    return (
        torch.where(is_zero[:, None, None], u_f, u_r),
        torch.where(is_zero[:, None], dec_f, dec_r),
    )


class WindowedPMDResult(NamedTuple):
    spatial: torch.Tensor    # (n, p, max_rank) zero-padded accumulated bases
    counts: torch.Tensor     # (n,) kept components per block
    temporal: torch.Tensor   # (n, max_rank, t) projection of the whole block
    windows_run: int         # windows decomposed before the early stop
    fallback: int            # zero-component blocks re-run by the full kernel, summed over windows


def effective_window_length(window_length: int, t: int, temporal_avg_factor: int) -> int:
    """The window length the loop uses: clamped to the movie, rounded down
    to a multiple of the binning factor (engine.py:820-829)."""
    window_length = min(window_length, t)
    return max(temporal_avg_factor, (window_length // temporal_avg_factor) * temporal_avg_factor)


def window_count(t: int, window_length: int) -> int:
    return len(range(0, t, window_length))


def windowed_pmd_batched(
    blocks: torch.Tensor,
    sketches: torch.Tensor,
    window_length: int,
    max_rank: int,
    spatial_threshold,
    temporal_threshold,
    max_consecutive_failures: int,
    temporal_avg_factor: int,
    spatial_avg_factor: int,
    spatial_denoiser: Callable = identity,
    temporal_denoiser: Callable = identity,
    mesh=None,
    residual_span: Callable = contextlib.nullcontext,
) -> WindowedPMDResult:
    """Windowed blockwise PMD over a batch of blocks (engine.py:843-903).

    blocks: (n, b1, b2, t) patches; sketches: (n_windows, n, wl / f, k), one
    per (window, block), drawn by the caller over the global block grid.
    Window 0 runs the two-stage kernel; window w >= 1 starts at
    ``min(w * wl, t - wl)`` and extracts residual components against the
    accumulated basis, blocks still at zero components re-running the full
    kernel on that window's sketch; the loop stops once every block is full.
    The temporal components are the whole crop projected on the bases. The
    denoisers reach every run of the two-stage kernel; the residual kernel
    takes none, as in the JAX package. With ``mesh`` (``parallel.make_mesh``)
    the blocks are split over its ranks (``parallel.sharded_windowed_pmd``);
    n must be divisible by the mesh size. ``residual_span`` (a callable
    giving a context manager, such as ``utils.logging.DeviceSpans.span``)
    encloses each residual window's work: the residual kernel, the
    fallback and the packing."""
    n, b1, b2, t = blocks.shape
    wl = effective_window_length(window_length, t, temporal_avg_factor)
    n_windows = window_count(t, wl)
    if tuple(sketches.shape[:2]) != (n_windows, n):
        raise ValueError(f"sketches shape {tuple(sketches.shape[:2])} != {(n_windows, n)}")
    if mesh is not None:
        validate_multihost_mesh(mesh)
        return sharded_windowed_pmd(
            mesh, blocks, sketches, spatial_threshold, temporal_threshold,
            n_windows=n_windows, window_length=wl, max_rank=max_rank,
            temporal_avg_factor=temporal_avg_factor, spatial_avg_factor=spatial_avg_factor,
            max_consecutive_failures=max_consecutive_failures,
            spatial_denoiser=spatial_denoiser, temporal_denoiser=temporal_denoiser,
            residual_span=residual_span,
        )
    return _windowed_loop(
        blocks, sketches, wl, n_windows, max_rank, spatial_threshold, temporal_threshold,
        max_consecutive_failures, temporal_avg_factor, spatial_avg_factor, spatial_denoiser,
        temporal_denoiser, residual_span=residual_span,
    )


def _windowed_loop(
    blocks, sketches, wl, n_windows, max_rank, spatial_threshold, temporal_threshold,
    max_consecutive_failures, temporal_avg_factor, spatial_avg_factor,
    spatial_denoiser: Callable = identity, temporal_denoiser: Callable = identity,
    agree: Optional[Callable] = None,
    residual_span: Callable = contextlib.nullcontext,
) -> WindowedPMDResult:
    """The window loop of ``windowed_pmd_batched`` (engine.py:693-790), the
    host reading two scalars a window: ``[-min(counts), zero-count
    blocks]``. ``agree`` (the mesh path's all-reduce, max) makes them the
    ranks' common values, so every rank stops and picks the fallback tier
    together; ``fallback_cap`` stays this rank's n // 8, as inside JAX's
    ``shard_map``. Each window run is an ``engine.window`` span, each read
    an ``engine.window_wait`` span between them; ``residual_span`` encloses
    every residual window's work. ``fallback`` sums the read zero-block
    counts of the residual windows run (the ranks' common value on a
    mesh)."""
    n, b1, b2, t = blocks.shape
    kw = dict(
        max_rank=max_rank, temporal_avg_factor=temporal_avg_factor,
        spatial_avg_factor=spatial_avg_factor, spatial_threshold=spatial_threshold,
        temporal_threshold=temporal_threshold, spatial_denoiser=spatial_denoiser,
        temporal_denoiser=temporal_denoiser,
    )
    acc = torch.zeros((n, b1 * b2, max_rank), dtype=blocks.dtype, device=blocks.device)
    counts = torch.zeros((n,), dtype=torch.int32, device=blocks.device)
    with span(None, None, "engine.window"):
        acc, counts = _md_pack_step(
            blocks[..., :wl], sketches[0], acc, counts, max_rank, temporal_avg_factor,
            spatial_avg_factor, spatial_threshold, temporal_threshold, max_consecutive_failures,
            spatial_denoiser, temporal_denoiser,
        )
    fallback_cap = max(1, n // 8)
    fallback = 0
    w = 1
    while w < n_windows:
        is_zero = counts == 0
        stat = torch.stack([-counts.min(), is_zero.sum().to(counts.dtype)])
        if agree is not None:
            stat = agree(stat)
        with span(None, None, "engine.window_wait"):
            neg_least, n_zero = stat.tolist()
        if -neg_least >= max_rank:
            break
        with span(None, None, "engine.window"), residual_span():
            start = min(w * wl, t - wl)
            window = blocks[..., start : start + wl]
            u, dec, _ = single_residual_block_md_batched(
                window, acc, sketches[w], max_rank, temporal_avg_factor,
                spatial_threshold, temporal_threshold,
            )
            u, dec = _fallback_rerun(window, sketches[w], u, dec, is_zero, n_zero, fallback_cap,
                                     **kw)
            acc, counts = pack_components(u, dec, acc, counts, max_consecutive_failures)
        fallback += n_zero
        w += 1
    temporal = temporal_projector_batched(acc, flatten_fov(blocks))
    return WindowedPMDResult(acc, counts, temporal, w, fallback)


# ---------------------------------------------------------------------------
# Threshold calibration (Monte-Carlo on pure noise)
# ---------------------------------------------------------------------------

def _rank_simulation_batch(
    noise: torch.Tensor, sketches: torch.Tensor, num_comps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roughness stats of a rank-``num_comps`` rSVD of each noise block.

    noise: (n, d1, d2, t) iid N(0, 1); sketches: (n, t, num_comps + 10).
    Returns (spatial (n, num_comps), temporal (n, num_comps)) -- the
    draws-as-inputs form of engine.py:910-934. The pixels are flattened in
    C order (a free reshape) where the JAX package uses F: the rSVD is
    row-permutation equivariant, so the images and statistics are the same."""
    _, d1, d2, _ = noise.shape
    u, s, vt = _rsvd_core(flatten_fov(noise, "C"), sketches, num_comps)
    v = s[..., :, None] * vt
    u_img = unflatten_fov(u, d1, d2, "C")
    return spatial_roughness_stat(u_img.movedim(-1, 1)), temporal_roughness_stat(v)


# Thresholds memoized per exact argument set (engine.py:970-1060): the
# Monte-Carlo is a pure function of its inputs, so a seeded rerun (a warm
# call, a notebook re-run) need not simulate again. Only calls that name a
# ``cache_token`` (the pipeline passes its seed) are memoized, never under a
# sketch override; the key holds the matmul precision and the device, whose
# results differ. Writes are locked: volumetric planes may run in threads.
_threshold_cache: dict = {}
_THRESHOLD_CACHE_MAX = 64
_threshold_cache_lock = threading.Lock()


def threshold_heuristic(
    dimensions: Tuple[int, int, int],
    num_comps: int = 1,
    iters: int = 250,
    percentile_threshold: float = 5.0,
    generator: Optional[torch.Generator] = None,
    sim_batch: int = 32,
    as_device: bool = False,
    cache_token=None,
    device="cuda",
):
    """Spatial/temporal roughness cutoffs from a noise-null Monte-Carlo:
    whole ``sim_batch`` batches of simulated blocks, the percentile taken
    over exactly the first ``iters`` draws (engine.py:983-1053). Runs on the
    card unless ``device="cpu"`` is passed; raises without CUDA. Returns two
    floats, or with ``as_device`` two 0-d float32 tensors on ``device`` of
    the same values. With a ``cache_token`` (which must name the generator's
    seed) the result is memoized on it, the dimensions, the counts, the
    percentile, torch's fp32 matmul precision and the device."""
    device = resolve_device(device)
    d1, d2, t = dimensions
    n_batches = max(1, -(-iters // sim_batch))
    cache_key = None
    if cache_token is not None and random_draws_are_live():
        cache_key = (
            d1, d2, t, num_comps, n_batches, sim_batch, iters, float(percentile_threshold),
            cache_token, torch.get_float32_matmul_precision(), str(device),
        )
        cached = _threshold_cache.get(cache_key)
        if cached is not None:
            return _thresholds_on(cached, device) if as_device else cached
    sps, tps = [], []
    for _ in range(n_batches):
        noise = normal((d1, d2, t), generator, device, batch=(sim_batch,))
        sketch = normal((t, num_comps + DEFAULT_OVERSAMPLES), generator, device, batch=(sim_batch,))
        sp, tp = _rank_simulation_batch(noise, sketch, num_comps)
        sps.append(sp)
        tps.append(tp)
    n_used = iters if iters else n_batches * sim_batch
    sp_all = torch.cat(sps).reshape(-1)[:n_used]
    tp_all = torch.cat(tps).reshape(-1)[:n_used]
    q = percentile_threshold / 100.0
    result = float(torch.quantile(sp_all, q)), float(torch.quantile(tp_all, q))
    if cache_key is not None:
        with _threshold_cache_lock:
            if len(_threshold_cache) >= _THRESHOLD_CACHE_MAX:
                _threshold_cache.pop(next(iter(_threshold_cache)), None)
            _threshold_cache[cache_key] = result
    return _thresholds_on(result, device) if as_device else result


def _thresholds_on(result: Tuple[float, float], device) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.tensor(x, dtype=torch.float32, device=device) for x in result)
