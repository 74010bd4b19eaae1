"""Batched per-block PMD decomposition (counterpart of localmd_tpu/engine.py,
gather path).

- ``single_block_md_batched``: the first-window decomposition of a batch of
  blocks (engine.py:76-147).
- ``single_residual_block_md_batched``: further components orthogonal to
  each block's accumulated basis (engine.py:151-178).
- ``_pack_components_route`` / ``pack_components``: the failure filter plus
  one-hot routing of kept components into per-block slots
  (engine.py:182-239).
- ``window0_chunk_step``: gather -> decompose -> pack for one batch of
  blocks (engine.py:250-301); the JAX package's CPU reference path.
- ``windowed_pmd_batched``: the multi-window block stage (engine.py:593-903)
  as a Python loop over windows, with the host reading two scalars per
  window (early stop, fallback tier) where JAX keeps them on the device;
  with ``mesh`` the blocks are split over the ranks
  (``parallel.sharded_windowed_pmd``).
- ``threshold_heuristic``: the noise-null Monte-Carlo for the roughness
  cutoffs (engine.py:911-1053); ``jnp.percentile`` becomes
  ``torch.quantile`` with linear interpolation.

``vmap`` is an explicit leading block axis throughout, except for the
user's denoisers: they are written for one block and mapped over the block
axis with ``torch.func.vmap``, as the JAX package maps them with
``jax.vmap``. A denoiser must be made of pure torch operations: no
``.item()`` or other read of a value to the host, no in-place write to its
input, no data-dependent Python control flow. ``torch.func.vmap`` raises
for such a denoiser; nothing catches that and falls back to a loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from localmd_tpu_torch.config import resolve_device
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
from localmd_tpu_torch.ops.tiling import extract_patches, flatten_fov, unflatten_fov
from localmd_tpu_torch.parallel.multihost import validate_multihost_mesh
from localmd_tpu_torch.parallel.sharded import sharded_windowed_pmd
from localmd_tpu_torch.utils.random import normal


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
    n must be divisible by the mesh size."""
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
        )
    return _windowed_loop(
        blocks, sketches, wl, n_windows, max_rank, spatial_threshold, temporal_threshold,
        max_consecutive_failures, temporal_avg_factor, spatial_avg_factor, spatial_denoiser,
        temporal_denoiser,
    )


def _windowed_loop(
    blocks, sketches, wl, n_windows, max_rank, spatial_threshold, temporal_threshold,
    max_consecutive_failures, temporal_avg_factor, spatial_avg_factor,
    spatial_denoiser: Callable = identity, temporal_denoiser: Callable = identity,
    agree: Optional[Callable] = None,
) -> WindowedPMDResult:
    """The window loop of ``windowed_pmd_batched`` (engine.py:693-790), the
    host reading two scalars a window: ``[-min(counts), zero-count
    blocks]``. ``agree`` (the mesh path's all-reduce, max) makes them the
    ranks' common values, so every rank stops and picks the fallback tier
    together; ``fallback_cap`` stays this rank's n // 8, as inside JAX's
    ``shard_map``."""
    n, b1, b2, t = blocks.shape
    kw = dict(
        max_rank=max_rank, temporal_avg_factor=temporal_avg_factor,
        spatial_avg_factor=spatial_avg_factor, spatial_threshold=spatial_threshold,
        temporal_threshold=temporal_threshold, spatial_denoiser=spatial_denoiser,
        temporal_denoiser=temporal_denoiser,
    )
    acc = torch.zeros((n, b1 * b2, max_rank), dtype=blocks.dtype, device=blocks.device)
    counts = torch.zeros((n,), dtype=torch.int32, device=blocks.device)
    acc, counts = _md_pack_step(
        blocks[..., :wl], sketches[0], acc, counts, max_rank, temporal_avg_factor,
        spatial_avg_factor, spatial_threshold, temporal_threshold, max_consecutive_failures,
        spatial_denoiser, temporal_denoiser,
    )
    fallback_cap = max(1, n // 8)
    w = 1
    while w < n_windows:
        is_zero = counts == 0
        stat = torch.stack([-counts.min(), is_zero.sum().to(counts.dtype)])
        if agree is not None:
            stat = agree(stat)
        neg_least, n_zero = stat.tolist()
        if -neg_least >= max_rank:
            break
        start = min(w * wl, t - wl)
        window = blocks[..., start : start + wl]
        u, dec, _ = single_residual_block_md_batched(
            window, acc, sketches[w], max_rank, temporal_avg_factor,
            spatial_threshold, temporal_threshold,
        )
        u, dec = _fallback_rerun(window, sketches[w], u, dec, is_zero, n_zero, fallback_cap, **kw)
        acc, counts = pack_components(u, dec, acc, counts, max_consecutive_failures)
        w += 1
    temporal = temporal_projector_batched(acc, flatten_fov(blocks))
    return WindowedPMDResult(acc, counts, temporal, w)


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


def threshold_heuristic(
    dimensions: Tuple[int, int, int],
    num_comps: int = 1,
    iters: int = 250,
    percentile_threshold: float = 5.0,
    generator: Optional[torch.Generator] = None,
    sim_batch: int = 32,
    device="cuda",
) -> Tuple[float, float]:
    """Spatial/temporal roughness cutoffs from a noise-null Monte-Carlo:
    whole ``sim_batch`` batches of simulated blocks, the percentile taken
    over exactly the first ``iters`` draws (engine.py:937-967). Runs on the
    card unless ``device="cpu"`` is passed; raises without CUDA."""
    device = resolve_device(device)
    d1, d2, t = dimensions
    n_batches = max(1, -(-iters // sim_batch))
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
    return float(torch.quantile(sp_all, q)), float(torch.quantile(tp_all, q))
