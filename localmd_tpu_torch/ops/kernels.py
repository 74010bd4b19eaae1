"""The four kernels of the port, each beside its plain PyTorch version.

Counterpart of localmd_tpu/ops/pallas_kernels.py. Every wrapper takes its
plain version only because the tensor it was given lies on the CPU; for a
CUDA tensor it launches the hand-written CUDA kernel (``csrc/``, built by
``ops._build``) or raises. There is no fallback and no switch. Each wrapper
carries ``launches``, a plain int counting the calls that launched its CUDA
kernel, so a run can show that the main path went through it.

- K1 ``movie_stats``: per-pixel mean + Welch sigma of a raw chunk in any
  of ``KERNEL_DTYPES`` (``csrc/movie_stats.cu``; plain twin: ``ops.noise``).
- K2 ``v_projection``: ``(raw @ A - c)^T`` over a raw chunk in its native
  dtype (``csrc/v_projection.cu``; plain twin: loader.py:365-372).
- K3 ``block_reconstruct``: overlap-add of per-block ``U_b @ V_b`` into a
  (d1, d2, f) canvas, one launch gathering each 8 x 8 pixel tile's blocks
  (``csrc/block_reconstruct.cu``; plain twin: a scatter-add).
- K4 ``jacobi_eigh``: batched cyclic-Jacobi eigh of (n, k, k) symmetric
  matrices, k <= 64 (``csrc/jacobi_eigh.cu``; plain twin:
  ``ops.linalg.jacobi_eigh_plain``). ``linalg.eigh_descending`` sends every
  small eigh on the card here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from localmd_tpu_torch.ops.linalg import JACOBI_MAX_DIM, jacobi_eigh_plain, jacobi_sweeps
from localmd_tpu_torch.ops.noise import (
    NOVERLAP,
    NPERSEG,
    _BAND_END,
    _band_dft_matrices,
    welch_scale,
    welch_sigma,
)

# the movie dtypes K1 and K2 read in their own width, by the code the CUDA
# entry points take (csrc/tf32_common.cuh's Elem); every value of each is
# exact in float32. Other dtypes raise: the loader casts them to float32
# on the card before a kernel sees them.
_DTYPE_CODES = {
    torch.float32: 0, torch.uint16: 1, torch.int16: 2, torch.uint8: 3, torch.int8: 4,
    torch.float16: 5, torch.bfloat16: 6,
}
KERNEL_DTYPES = tuple(_DTYPE_CODES)
_DTYPE_NAMES = "/".join(str(dt).removeprefix("torch.") for dt in KERNEL_DTYPES)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _library():
    from localmd_tpu_torch.ops._build import library

    return library()


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CPU or CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({dev}, {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_status(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {code}")


# ---------------------------------------------------------------------------
# K1: fused movie statistics
# ---------------------------------------------------------------------------

_TF32_MASK = -0x2000   # 0xffffe000 as an int32: sign, exponent, 10 mantissa bits


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split x = hi + lo of csrc/tf32_common.cuh, on float32: hi is
    x rounded to tf32 to nearest, ties away from zero (cvt.rna.tf32.f32's
    rounding, as an integer add and a mask); lo = x - hi, exact. The tensor
    core reads lo's top 10 mantissa bits."""
    u = x.contiguous().view(torch.int32)
    hi = ((u + 0x1000) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def k8_order(n: int) -> torch.Tensor:
    """The sample order of the kernels' K-major matrices: position i of
    each 8 holds sample 0, 2, 4, 6, 1, 3, 5, 7 -- the order in which the A
    fragments take a k8 step's samples (logical k = t is sample 2t, k =
    t + 4 sample 2t + 1). ``stored[:, i] = original[:, k8_order(n)[i]]``."""
    i = torch.arange(n)
    return (i & ~7) | ((i & 3) << 1) | ((i >> 2) & 1)


_DFT_CACHE: dict = {}
_K1_BK = 32


def _dft_constants(nperseg: int, device: torch.device):
    """K1's constants on ``device``, cached: the windowed band-DFT matrix as
    tf32 hi and lo parts, K-major (128, nperseg rounded up to 32, zero past
    nperseg) with its samples in ``k8_order``, its column sums cos1/sin1
    (64,) and the density scale. The matrices are built on the CPU with the
    f32 arithmetic of ops/noise.py:55-61. Rows 0-63 are the cos columns of
    bins 0-63, rows 64-127 their sin columns."""
    key = (nperseg, str(device))
    got = _DFT_CACHE.get(key)
    if got is None:
        cos_m, sin_m, cos_1, sin_1 = _band_dft_matrices(nperseg, "cpu")
        scale = float(welch_scale(nperseg, "cpu"))
        nper_pad = -(-nperseg // _K1_BK) * _K1_BK
        w = torch.nn.functional.pad(torch.cat([cos_m, sin_m], dim=1).T, (0, nper_pad - nperseg))
        w_hi, w_lo = split_tf32(w[:, k8_order(nper_pad)])
        got = tuple(x.contiguous().to(device) for x in (w_hi, w_lo, cos_1, sin_1)) + (scale,)
        _DFT_CACHE[key] = got
    return got


def _stats_segments(t: int, compute_noise: bool, nperseg: int) -> int:
    if not compute_noise:
        return 0
    if t < nperseg:
        raise ValueError(f"need at least {nperseg} frames for the noise estimate, got {t}")
    if nperseg < 2 * (_BAND_END - 1):
        raise ValueError(f"nperseg must be >= {2 * (_BAND_END - 1)}, got {nperseg}")
    return (t - nperseg) // (nperseg - NOVERLAP) + 1


def movie_stats_plain(
    chunk2d: torch.Tensor, mean_divisor, compute_noise: bool = True, nperseg: int = NPERSEG
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1: (T, P) chunk -> (mean (P,), sigma (P,)) f32."""
    _stats_segments(chunk2d.shape[0], compute_noise, nperseg)
    x = chunk2d.to(torch.float32)
    mean = x.sum(dim=0) / mean_divisor
    if not compute_noise:
        return mean, torch.zeros_like(mean)
    return mean, welch_sigma(x.T, nperseg)


def movie_stats(
    chunk2d: torch.Tensor, mean_divisor, compute_noise: bool = True, nperseg: int = NPERSEG
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: per-pixel mean + Welch sigma of a (T, P) raw chunk in one of
    ``KERNEL_DTYPES``, one pass over the chunk in its native dtype.

    ``mean_divisor`` is the whole movie's frame count; ``nperseg`` is 256
    (scipy semantics) or T (the reference's effective single periodogram);
    ``compute_noise=False`` gives sigma = 0."""
    if chunk2d.device.type == "cpu":
        return movie_stats_plain(chunk2d, mean_divisor, compute_noise, nperseg)
    _require_cuda("movie_stats", chunk2d)
    if chunk2d.dim() != 2 or chunk2d.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"movie_stats: expected a 2-D {_DTYPE_NAMES} chunk, got "
            f"{tuple(chunk2d.shape)} {chunk2d.dtype}"
        )
    t, p = chunk2d.shape
    n_segs = _stats_segments(t, compute_noise, nperseg)
    dev = chunk2d.device
    w_hi, w_lo, cos_1, sin_1, scale = _dft_constants(nperseg, dev)
    mean = torch.empty(p, dtype=torch.float32, device=dev)
    sigma = torch.empty(p, dtype=torch.float32, device=dev)
    code = _library().lmd_movie_stats(
        _ptr(chunk2d), _DTYPE_CODES[chunk2d.dtype], t, p,
        _ptr(w_hi), _ptr(w_lo), _ptr(cos_1), _ptr(sin_1),
        nperseg, w_hi.shape[1], n_segs, float(mean_divisor), scale,
        _ptr(mean), _ptr(sigma), _stream(chunk2d),
    )
    _check_status("movie_stats", code)
    movie_stats.launches += 1
    return mean, sigma


movie_stats.launches = 0


# ---------------------------------------------------------------------------
# K2: fused V projection
# ---------------------------------------------------------------------------

_VP_BM, _VP_BK = 128, 32
# K2's r' tile widths (csrc/v_projection.cuh instantiates each): steps of
# 16 to 160, then 8, so the widest tiles pad by under 8 columns
VP_WIDTHS = (32, 48, 64, 80, 96, 112, 128, 144, 160, 168, 176)
_VP_MIN_K_CHUNK = 256
# each unit's fp32 sum runs over at most this many pixels (accuracy bound)
_VP_MAX_K_CHUNK = 4096


class Projector(NamedTuple):
    """The (d, r') projector as K2 reads it, ``(n_tiles, d_pad / 32, bn *
    32)``: per r' tile of ``bn`` columns and 32-pixel slab one block of the
    kernel's core matrices, zero padded (``lmd_projector_t``)."""

    bt: torch.Tensor
    d: int
    r: int
    bn: int
    n_tiles: int


class VpSchedule(NamedTuple):
    """How K2 covers one chunk: ``n_tiles`` r' tiles of ``bn`` columns,
    ``t_tiles`` t tiles of 128 rows, the pixel axis in ``splits`` splits of
    ``k_chunk``; ``units`` work units (t tile x r' tile x split) walked by
    ``ctas`` persistent CTAs, one an SM."""

    bn: int
    n_tiles: int
    t_tiles: int
    splits: int
    k_chunk: int
    units: int
    ctas: int


def v_projection_plain(raw2d: torch.Tensor, a_cols: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2 (loader.py:365-372): (raw.f32 @ A - c)^T."""
    return (raw2d.to(torch.float32) @ a_cols - c[None, :]).T


def _vp_tiles(r: int) -> Tuple[int, int]:
    """(bn, n_tiles): r' in n_tiles near-equal tiles, each padded to the
    narrowest of ``VP_WIDTHS`` that holds it."""
    n_tiles = -(-r // VP_WIDTHS[-1])
    per_tile = -(-r // n_tiles)
    return next(w for w in VP_WIDTHS if w >= per_tile), n_tiles


def _vp_split(d: int, tiles: int, n_sm: int) -> Tuple[int, int]:
    """(splits, k_chunk): the pixel axis in splits of k_chunk (a multiple of
    32, at least 256 and at most 4096 pixels deep) for ``tiles`` output
    tiles walked by one CTA on each of ``n_sm`` SMs: the split whose rounds
    of units, each as long as its slabs plus two for its sums' store, take
    the least time; ties go to fewer splits (less workspace)."""
    fewest = -(-d // _VP_MAX_K_CHUNK)
    most = max(fewest, -(-d // _VP_MIN_K_CHUNK))
    best = None
    for want in range(fewest, most + 1):
        per_split = -(-d // want)
        k_chunk = -(-per_split // _VP_BK) * _VP_BK
        splits = -(-d // k_chunk)
        cost = -(-(tiles * splits) // n_sm) * (k_chunk // _VP_BK + 2)
        if best is None or cost < best[0]:
            best = (cost, splits, k_chunk)
    return best[1], best[2]


@functools.lru_cache(maxsize=64)
def vp_schedule(t: int, d: int, r: int, n_sm: int) -> VpSchedule:
    """K2's schedule for a (t, d) chunk and an r'-column projector on a card
    with ``n_sm`` SMs, from the shapes alone."""
    bn, n_tiles = _vp_tiles(r)
    t_tiles = -(-t // _VP_BM)
    splits, k_chunk = _vp_split(d, n_tiles * t_tiles, n_sm)
    units = splits * n_tiles * t_tiles
    return VpSchedule(bn, n_tiles, t_tiles, splits, k_chunk, units, min(units, n_sm))


def prepare_projector(a_cols: torch.Tensor) -> Projector:
    """K2's layout of a (d, r') float32 projector on the card, made once
    for all the chunks it multiplies."""
    _require_cuda("prepare_projector", a_cols)
    if a_cols.dim() != 2 or a_cols.dtype != torch.float32:
        raise ValueError(f"prepare_projector: expected (d, r') float32, got {tuple(a_cols.shape)}")
    d, r = a_cols.shape
    bn, n_tiles = _vp_tiles(r)
    d_pad = -(-d // _VP_BK) * _VP_BK
    bt = torch.empty((n_tiles, d_pad // _VP_BK, bn * _VP_BK), dtype=torch.float32,
                     device=a_cols.device)
    code = _library().lmd_projector_t(
        _ptr(a_cols), d, r, _ptr(bt), d_pad, bn, n_tiles, _stream(a_cols)
    )
    _check_status("prepare_projector", code)
    return Projector(bt, d, r, bn, n_tiles)


def v_projection(
    raw2d: torch.Tensor, a_cols: torch.Tensor, c: torch.Tensor,
    prepared: Optional[Projector] = None,
) -> torch.Tensor:
    """K2: (t, d) raw chunk (one of ``KERNEL_DTYPES``, C-order pixels) x (d, r')
    projector -> (r', t), in one pass over the raw chunk with no f32 copy.
    ``a_cols`` rows must follow raw2d's C-order pixel flattening.
    ``prepared`` is ``prepare_projector(a_cols)`` when the caller reuses it
    across chunks; otherwise it is made here. The schedule is
    ``vp_schedule`` of the shapes and the card's SM count."""
    if raw2d.device.type == "cpu":
        return v_projection_plain(raw2d, a_cols, c)
    _require_cuda("v_projection", raw2d, a_cols, c)
    t, d = raw2d.shape
    if raw2d.dtype not in _DTYPE_CODES:
        raise ValueError(f"v_projection: raw dtype {raw2d.dtype} is not one of {_DTYPE_NAMES}")
    if a_cols.dtype != torch.float32 or c.dtype != torch.float32:
        raise ValueError("v_projection: projector and constant must be float32")
    if a_cols.dim() != 2 or a_cols.shape[0] != d or c.shape != (a_cols.shape[1],):
        raise ValueError(
            f"v_projection: shapes raw {tuple(raw2d.shape)}, A {tuple(a_cols.shape)}, "
            f"c {tuple(c.shape)} do not agree"
        )
    r = a_cols.shape[1]
    if prepared is None:
        prepared = prepare_projector(a_cols)
    elif (prepared.d, prepared.r) != (d, r) or prepared.bt.device != raw2d.device:
        raise ValueError("v_projection: the prepared projector belongs to another projector")
    dev = raw2d.device
    out = torch.empty((r, t), dtype=torch.float32, device=dev)
    sched = vp_schedule(t, d, r, torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = torch.empty((sched.splits, t, r), dtype=torch.float32, device=dev)
    code = _library().lmd_v_projection(
        _ptr(raw2d), _DTYPE_CODES[raw2d.dtype], t, d, _ptr(prepared.bt),
        prepared.bt.shape[1] * _VP_BK, r, prepared.bn, prepared.n_tiles, _ptr(c),
        sched.splits, sched.k_chunk, sched.ctas, _ptr(ws), _ptr(out), _stream(raw2d),
    )
    _check_status("v_projection", code)
    v_projection.launches += 1
    return out


v_projection.launches = 0


# ---------------------------------------------------------------------------
# K3: blocked reconstruction
# ---------------------------------------------------------------------------

def panels_f_to_c(panels: torch.Tensor, b1: int, b2: int) -> torch.Tensor:
    """Reorder (N, b1*b2, S) panel rows from F-order (i + j*b1) to C-order
    (i*b2 + j) local pixel ids (pallas_kernels.py:418)."""
    n, p, s = panels.shape
    return panels.reshape(n, b2, b1, s).transpose(1, 2).reshape(n, p, s).contiguous()


def _check_ids_and_fov(starts: np.ndarray, cosets: Sequence[np.ndarray], fov, block_shape) -> None:
    d1, d2 = fov
    b1, b2 = block_shape
    ids = np.concatenate([np.asarray(c) for c in cosets]) if len(cosets) else np.zeros(0, int)
    if sorted(ids.tolist()) != list(range(len(starts))):
        raise ValueError("cosets must hold every block id exactly once")
    if starts.size and (
        starts.min() < 0 or (starts[:, 0] + b1).max() > d1 or (starts[:, 1] + b2).max() > d2
    ):
        raise ValueError("a block lies outside the FOV")


def check_cosets(starts: np.ndarray, cosets: Sequence[np.ndarray], fov, block_shape) -> None:
    """Raise unless ``cosets`` partition the blocks into groups whose
    rectangles are pairwise disjoint and inside the FOV: a pixel then meets
    at most one block of a coset, and the order of the cosets is the order
    of every pixel's sum."""
    d1, d2 = fov
    b1, b2 = block_shape
    starts = np.asarray(starts)
    _check_ids_and_fov(starts, cosets, fov, block_shape)
    for c in cosets:
        cover = np.zeros((d1, d2), np.int32)
        for k, j in starts[np.asarray(c)]:
            cover[k : k + b1, j : j + b2] += 1
        if cover.max(initial=0) > 1:
            raise ValueError("blocks within a coset overlap")


RECON_TILE = 8   # K3's pixel tile: 8 x 8 pixels a CTA


def recon_tile_lists(starts, cosets: Sequence[np.ndarray], fov, block_shape):
    """K3's block lists, on the host: for every 8 x 8 pixel tile (row-major
    over the ceil(d1 / 8) x ceil(d2 / 8) tiles) the blocks whose rectangle
    meets it, ordered by coset (the order of ``cosets``, then the order
    within it), so every pixel sums its blocks in one fixed order. Returns
    (offsets (tiles + 1,), blocks (nnz,)) int32 in CSR form."""
    d1, d2 = fov
    b1, b2 = block_shape
    st = np.asarray(starts, dtype=np.int64).reshape(-1, 2)
    rank = np.empty(len(st), np.int64)
    order = np.concatenate([np.asarray(c, np.int64) for c in cosets]) if len(cosets) else np.zeros(0, np.int64)
    rank[order] = np.arange(len(order))
    t = RECON_TILE
    tiles_x = -(-d2 // t)
    n_tiles = -(-d1 // t) * tiles_x
    ty0, ty1 = st[:, 0] // t, (st[:, 0] + b1 - 1) // t
    tx0, tx1 = st[:, 1] // t, (st[:, 1] + b2 - 1) // t
    ntx = tx1 - tx0 + 1
    cnt = (ty1 - ty0 + 1) * ntx
    blk = np.repeat(np.arange(len(st)), cnt)
    local = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    tile = (ty0[blk] + local // ntx[blk]) * tiles_x + tx0[blk] + local % ntx[blk]
    sort = np.lexsort((rank[blk], tile))
    offsets = np.concatenate([[0], np.cumsum(np.bincount(tile, minlength=n_tiles))])
    return offsets.astype(np.int32), blk[sort].astype(np.int32)


class ReconPlan(NamedTuple):
    """K3's block geometry on the card, made once per factorization
    (``prepare_reconstruct``): the starts and the per-tile block lists."""

    starts: torch.Tensor
    tile_offsets: torch.Tensor
    tile_blocks: torch.Tensor
    n_blocks: int
    fov: Tuple[int, int]
    block_shape: Tuple[int, int]


def prepare_reconstruct(starts, cosets: Sequence[np.ndarray], fov, block_shape,
                        device) -> ReconPlan:
    """K3's plan for a block grid: checks that the host ``starts`` lie in
    the FOV and that the cosets hold every block once, builds the block
    lists (``recon_tile_lists``) and uploads them with the starts, once.
    That the blocks of a coset are disjoint is the caller's contract
    (``BlockGrid.cosets``); the plain twin checks it (``check_cosets``)."""
    if isinstance(starts, torch.Tensor) and starts.device.type != "cpu":
        raise ValueError("block_reconstruct: starts must be on the host (numpy or a CPU tensor)")
    st = np.asarray(starts, dtype=np.int32).reshape(-1, 2)
    _check_ids_and_fov(st, cosets, fov, block_shape)
    offsets, blocks = recon_tile_lists(st, cosets, fov, block_shape)
    dev = torch.device(device)
    return ReconPlan(
        torch.from_numpy(st).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(blocks).to(dev), len(st), tuple(fov), tuple(block_shape),
    )


def block_reconstruct_plain(
    panels_c: torch.Tensor,
    temporal: torch.Tensor,
    starts,
    cosets: Sequence[np.ndarray],
    fov: Tuple[int, int],
    block_shape: Tuple[int, int],
) -> torch.Tensor:
    """Plain twin of K3: batched panel product + scatter-add (the
    ``BlockSparseMatrix.matmul`` + ``unflatten_fov`` of pmd_array.py:336-338,
    in C-order rows). ``starts`` (N, 2) on any device."""
    d1, d2 = fov
    b1, b2 = block_shape
    st_host = starts.cpu().numpy() if isinstance(starts, torch.Tensor) else np.asarray(starts)
    check_cosets(st_host, cosets, fov, block_shape)
    f = temporal.shape[-1]
    contrib = panels_c @ temporal                                  # (N, p, f)
    dev = panels_c.device
    st = torch.tensor(st_host, dtype=torch.long, device=dev)
    rows = (st[:, 0, None, None] + torch.arange(b1, device=dev)[None, :, None]) * d2 + (
        st[:, 1, None, None] + torch.arange(b2, device=dev)[None, None, :]
    )
    out = torch.zeros((d1 * d2, f), dtype=torch.float32, device=dev)
    out.index_add_(0, rows.reshape(-1), contrib.reshape(-1, f))
    return out.reshape(d1, d2, f)


def block_reconstruct(
    panels_c: torch.Tensor,
    temporal: torch.Tensor,
    starts,
    cosets: Sequence[np.ndarray],
    fov: Tuple[int, int],
    block_shape: Tuple[int, int],
    prepared: Optional[ReconPlan] = None,
) -> torch.Tensor:
    """K3: ``sum_b panels_c[b] @ temporal[b]`` overlap-added into a
    (d1, d2, f) canvas at each block's start.

    panels_c (N, b1*b2, S) f32 with C-order local rows; temporal (N, S, f)
    f32; starts (N, 2) block starts on the host (numpy or a CPU tensor);
    ``cosets`` a partition of the block ids into groups of
    pairwise-disjoint blocks (``BlockGrid.cosets``), whose order fixes the
    order of every pixel's sum. ``prepared`` is ``prepare_reconstruct``'s
    plan when the caller reuses it across calls: the call then reads
    nothing back from the card and uploads nothing. One launch."""
    if panels_c.device.type == "cpu":
        return block_reconstruct_plain(panels_c, temporal, starts, cosets, fov, block_shape)
    _require_cuda("block_reconstruct", panels_c, temporal)
    d1, d2 = fov
    b1, b2 = block_shape
    n, p, s = panels_c.shape
    if panels_c.dtype != torch.float32 or temporal.dtype != torch.float32:
        raise ValueError("block_reconstruct: panels and temporal must be float32")
    if p != b1 * b2 or temporal.dim() != 3 or temporal.shape[:2] != (n, s):
        raise ValueError(
            f"block_reconstruct: panels {tuple(panels_c.shape)} / temporal "
            f"{tuple(temporal.shape)} do not match blocks {block_shape}"
        )
    if prepared is None:
        prepared = prepare_reconstruct(starts, cosets, fov, block_shape, panels_c.device)
    elif (prepared.n_blocks, prepared.fov, prepared.block_shape) != (n, (d1, d2), (b1, b2)) or (
        prepared.starts.device != panels_c.device
    ):
        raise ValueError("block_reconstruct: the prepared plan belongs to another block grid")
    f = temporal.shape[2]
    out = torch.empty((d1, d2, f), dtype=torch.float32, device=panels_c.device)
    code = _library().lmd_block_reconstruct(
        _ptr(panels_c), _ptr(temporal), _ptr(prepared.starts), _ptr(prepared.tile_offsets),
        _ptr(prepared.tile_blocks), d1, d2, b1, b2, s, f, _ptr(out), _stream(panels_c),
    )
    _check_status("block_reconstruct", code)
    block_reconstruct.launches += 1
    return out


block_reconstruct.launches = 0


# ---------------------------------------------------------------------------
# K4: batched cyclic-Jacobi eigh
# ---------------------------------------------------------------------------

def jacobi_eigh(sym: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: eigendecomposition of a batch of symmetric (n, k, k) float32
    matrices, k <= 64, by cyclic Jacobi with the JAX package's sweep count.
    Returns (vals (n, k) descending, vecs (n, k, k)), vectors as columns."""
    if sym.dim() != 3 or sym.shape[-1] != sym.shape[-2] or sym.dtype != torch.float32:
        raise ValueError(
            f"jacobi_eigh: expected (n, k, k) float32, got {tuple(sym.shape)} {sym.dtype}"
        )
    n, k, _ = sym.shape
    if not 1 <= k <= JACOBI_MAX_DIM:
        raise ValueError(f"jacobi_eigh: k = {k} is outside 1..{JACOBI_MAX_DIM}")
    if sym.device.type == "cpu":
        return jacobi_eigh_plain(sym)
    _require_cuda("jacobi_eigh", sym)
    dev = sym.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    vecs = torch.empty((n, k, k), dtype=torch.float32, device=dev)
    if n == 0:
        return vals, vecs
    code = _library().lmd_jacobi_eigh(
        _ptr(sym), n, k, jacobi_sweeps(k), _ptr(vals), _ptr(vecs), _stream(sym),
    )
    _check_status("jacobi_eigh", code)
    jacobi_eigh.launches += 1
    return vals, vecs


jacobi_eigh.launches = 0

KERNELS = (movie_stats, v_projection, block_reconstruct, jacobi_eigh)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
