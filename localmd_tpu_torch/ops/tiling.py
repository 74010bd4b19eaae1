"""FOV tiling: overlapping block grid, pyramid blend weights, patch gather,
overlap-add scatter, and explicit F/C-order flattening.

Counterpart of localmd_tpu/ops/tiling.py. torch reshapes in C order, so the
F-order pixel id ``i + j*d1`` is encoded here once as explicit transposes.
The grid itself (``BlockGrid``) is host-side numpy metadata, copied from
ops/tiling.py:92-303; its device copies (``device_constants``,
``coset_info``) are made once per grid and device and cached on it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device

# Uploads of a grid's constants to a device (``BlockGrid.device_constants``),
# one per grid and device: a warm call of a memoized grid adds none. The
# lock makes the check, the upload and the count one step: volumetric
# planes on a list of devices share the memoized grids from their threads.
UPLOADS = {"device_constants": 0}
_UPLOAD_LOCK = threading.Lock()


def _device_key(device=None) -> torch.device:
    """The cache key of ``device``: an index-less CUDA device names the
    current one, which differs between threads that set their own
    (volumetric planes on a list of devices). ``None`` is the card, as the
    JAX package's default device is its accelerator: the current CUDA
    device, through ``config.resolve_device``, which raises without CUDA
    and asks for ``device="cpu"``."""
    dev = resolve_device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _upload(array: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of one host array on ``dev``: through pinned memory to a card,
    so the copy does not wait on the stream the way a pageable one does."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if dev.type != "cuda":
        return host.to(dev, copy=True)
    return host.pin_memory().to(dev, non_blocking=True)


# ---------------------------------------------------------------------------
# F/C-order flatten helpers (single source of truth for pixel ordering)
# ---------------------------------------------------------------------------

def flatten_fov(x: torch.Tensor, order: str = "F") -> torch.Tensor:
    """(..., d1, d2, T) -> (..., d1*d2, T); F-order pixel id = i + j*d1."""
    *batch, d1, d2, t = x.shape
    if order == "F":
        x = x.transpose(-3, -2)
    return x.reshape(*batch, d1 * d2, t)


def unflatten_fov(x: torch.Tensor, d1: int, d2: int, order: str = "F") -> torch.Tensor:
    """Inverse of :func:`flatten_fov`: (..., d1*d2, T) -> (..., d1, d2, T)."""
    *batch, _, t = x.shape
    if order == "F":
        return x.reshape(*batch, d2, d1, t).transpose(-3, -2)
    return x.reshape(*batch, d1, d2, t)


def flatten_image(x: torch.Tensor, order: str = "F") -> torch.Tensor:
    """(..., d1, d2) -> (..., d1*d2) with the given pixel order."""
    *batch, d1, d2 = x.shape
    if order == "F":
        x = x.transpose(-2, -1)
    return x.reshape(*batch, d1 * d2)


def unflatten_image(x: torch.Tensor, d1: int, d2: int, order: str = "F") -> torch.Tensor:
    *batch, _ = x.shape
    if order == "F":
        return x.reshape(*batch, d2, d1).transpose(-2, -1)
    return x.reshape(*batch, d1, d2)


# ---------------------------------------------------------------------------
# Grid construction (numpy; copied from ops/tiling.py:92-134)
# ---------------------------------------------------------------------------

def _dim_starts(extent: int, block: int, overlap: int) -> List[int]:
    """Start offsets along one dim: stride (block - overlap) plus a tail block
    flush with the edge."""
    starts = list(range(0, extent - block + 1, block - overlap))
    if starts[-1] != extent - block and extent - block != 0:
        starts.append(extent - block)
    return starts


def update_block_sizes(
    blocks: Tuple[int, int], fov_shape: Tuple[int, int], min_block_value: int = 10
) -> List[int]:
    """Clamp user block sizes to the FOV."""
    if blocks[0] < min_block_value or blocks[1] < min_block_value:
        raise ValueError(
            f"Block dimensions must be at least {min_block_value}, got {blocks}"
        )
    return [min(blocks[0], fov_shape[0]), min(blocks[1], fov_shape[1])]


def check_fov_size(fov_dims: Tuple[int, int], min_allowed_value: int = 10) -> None:
    for k in fov_dims:
        if k < min_allowed_value:
            raise ValueError(
                f"FOV dimension {k} is below the minimum of {min_allowed_value}"
            )


def pyramid_weights(b1: int, b2: int, dtype=np.float32) -> np.ndarray:
    """Center-weighted blending pyramid: w[i, j] = 1 + min(i, b1-1-i, j, b2-1-j)."""
    i = np.arange(b1)[:, None]
    j = np.arange(b2)[None, :]
    ramp = np.minimum(np.minimum(i, b1 - 1 - i), np.minimum(j, b2 - 1 - j))
    return (1.0 + ramp).astype(dtype)


@dataclass(frozen=True)
class BlockGrid:
    """Static description of the overlapping patch tiling of one FOV
    (ops/tiling.py:137-303)."""

    d1: int
    d2: int
    block_sizes: Tuple[int, int]
    order: str = "F"
    starts: np.ndarray = field(init=False)        # (n_blocks, 2) int32
    rows: np.ndarray = field(init=False)          # (n_blocks, b1*b2) int32 global ids
    weights: np.ndarray = field(init=False)       # (b1, b2) pyramid weights
    cumulative_weights: np.ndarray = field(init=False)  # (d1, d2)

    def __post_init__(self):
        b1, b2 = self.block_sizes
        overlap = (int(np.ceil(b1 / 2)), int(np.ceil(b2 / 2)))
        s1 = _dim_starts(self.d1, b1, overlap[0])
        s2 = _dim_starts(self.d2, b2, overlap[1])
        starts = np.array([(k, j) for k in s1 for j in s2], dtype=np.int32)
        object.__setattr__(self, "starts", starts)

        # Global ids follow ``order``; the flatten WITHIN a block is always F
        # (panel row m holds local pixel (m % b1, m // b1)).
        m = np.arange(b1 * b2, dtype=np.int64)
        i_loc = m % b1
        j_loc = m // b1
        gi = starts[:, 0:1].astype(np.int64) + i_loc[None, :]
        gj = starts[:, 1:2].astype(np.int64) + j_loc[None, :]
        rows = gi + gj * self.d1 if self.order == "F" else gi * self.d2 + gj
        object.__setattr__(self, "rows", rows.astype(np.int32))

        w = pyramid_weights(b1, b2)
        object.__setattr__(self, "weights", w)
        cum = np.zeros((self.d1, self.d2), dtype=np.float64)
        for (k, j) in starts:
            cum[k : k + b1, j : j + b2] += w
        object.__setattr__(self, "cumulative_weights", cum.astype(np.float32))

    @property
    def n_blocks(self) -> int:
        return len(self.starts)

    @property
    def pixels_per_block(self) -> int:
        return self.block_sizes[0] * self.block_sizes[1]

    def device_constants(self, device=None):
        """The per-run constants on ``device`` (ops/tiling.py:190-210; ``None``:
        the current CUDA device, see :func:`_device_key`):
        ``(weights_flat (p,), cum_flat (d,), rows (N, p) int64, starts (N, 2)
        int32)``. ``weights_flat`` flattens the panel row layout (always F
        within a block), ``cum_flat`` follows the grid's ``order``. Uploaded
        once per grid and device and cached on the instance, so a memoized
        grid's warm calls make no copy; :func:`clear_block_grid_cache`
        frees them. Every caller gets the same tensors: read them, never
        write to them."""
        dev = _device_key(device)
        with _UPLOAD_LOCK:
            cache = getattr(self, "_device_constants", None)
            if cache is None:
                cache = {}
                object.__setattr__(self, "_device_constants", cache)
            cached = cache.get(dev)
            if cached is None:
                b1, b2 = self.block_sizes
                host = (
                    self.weights.T.reshape(b1 * b2),                   # F order
                    (self.cumulative_weights.T if self.order == "F"
                     else self.cumulative_weights).reshape(self.d1 * self.d2),
                    self.rows.astype(np.int64),
                    self.starts,
                )
                cached = cache[dev] = tuple(_upload(a, dev) for a in host)
                UPLOADS["device_constants"] += 1
        return cached

    def cosets(self):
        """Partition the blocks into groups whose rectangles are pairwise
        disjoint (ops/tiling.py:250-303).

        Along one dim starts advance by ``stride = floor(b/2)``; every
        ``k_c = ceil(b/stride)``-th start forms a uniform sub-grid of disjoint
        blocks, and a snapped tail start forms its own singleton group. The
        2-D cosets are the cross products (<= (k_c+1)^2 of them).

        Returns a cached tuple of ``(block_ids (nc1*nc2,) int32,
        (nc1, nc2, st1, st2, a1, a2))``.
        """
        cached = getattr(self, "_cosets", None)
        if cached is not None:
            return cached
        b1, b2 = self.block_sizes

        def dim_groups(extent, b):
            o = int(np.ceil(b / 2))
            s = _dim_starts(extent, b, o)
            stride = b - o
            n_reg = len(s)
            if len(s) >= 2 and s[-1] - s[-2] != stride:
                n_reg -= 1
            k_c = 1 if stride <= 0 else -(-b // stride)
            groups = []
            for r in range(min(k_c, n_reg)):
                idx = list(range(r, n_reg, k_c))
                st = max(stride * k_c, b)
                groups.append((idx, s[idx[0]], st, len(idx)))
            if n_reg != len(s):
                groups.append(([len(s) - 1], s[-1], b, 1))
            return groups, len(s)

        g1, _ = dim_groups(self.d1, b1)
        g2, n2 = dim_groups(self.d2, b2)
        out = []
        for idx1, a1, st1, nc1 in g1:
            for idx2, a2, st2, nc2 in g2:
                ids = np.array(
                    [i1 * n2 + i2 for i1 in idx1 for i2 in idx2], np.int32
                )
                out.append((ids, (nc1, nc2, st1, st2, a1, a2)))
        cached = tuple(out)
        object.__setattr__(self, "_cosets", cached)
        return cached

    def cell_geometry(self):
        """``(n1, n2, h1, h2)`` when the grid is *regular* -- even blocks,
        exact half-overlap stride, no snapped tail start -- else None
        (ops/tiling.py:220-248). Every pairwise block overlap is then a whole
        number of (h1, h2) cells, which the banded Gram and the cell-packed
        V projection (``blocksparse``) need. Host metadata, cached."""
        cached = getattr(self, "_cell_geometry", None)
        if cached is not None:
            return None if cached == "none" else cached
        b1, b2 = self.block_sizes
        geom = None
        if b1 % 2 == 0 and b2 % 2 == 0:
            h1, h2 = b1 // 2, b2 // 2
            s1 = sorted({int(s) for s in self.starts[:, 0]})
            s2 = sorted({int(s) for s in self.starts[:, 1]})
            n1, n2 = len(s1), len(s2)
            if (
                len(self.starts) == n1 * n2
                and s1 == [i * h1 for i in range(n1)]
                and s2 == [j * h2 for j in range(n2)]
                and (n1 - 1) * h1 + b1 == self.d1
                and (n2 - 1) * h2 + b2 == self.d2
            ):
                geom = (n1, n2, h1, h2)
        object.__setattr__(self, "_cell_geometry", geom if geom is not None else "none")
        return geom

    def coset_info(self, device=None):
        """The coset placement metadata of ``BlockSparseMatrix.matmul``
        (ops/tiling.py:306-332; ``device`` as in :meth:`device_constants`):
        ``(block-id tensors on device, metas, d1,
        d2, order, inv)``, ``metas`` the ``(nc1, nc2, st1, st2, a1, a2)`` of
        each coset from :meth:`cosets` and ``inv`` the map from block id to
        its row in the coset-order concatenation. The device copies are
        made once per grid and device."""
        cache = getattr(self, "_coset_info", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_coset_info", cache)
        dev = _device_key(device)
        cached = cache.get(dev)
        if cached is None:
            cs = self.cosets()
            concat = np.concatenate([ids for ids, _ in cs]).astype(np.int64)
            inv = np.empty_like(concat)
            inv[concat] = np.arange(len(concat))
            cached = (
                tuple(torch.as_tensor(ids.astype(np.int64), device=dev) for ids, _ in cs),
                tuple(meta for _, meta in cs),
                self.d1,
                self.d2,
                self.order,
                torch.as_tensor(inv, device=dev),
            )
            cache[dev] = cached
        return cached


@lru_cache(maxsize=8)
def block_grid(d1: int, d2: int, block_sizes: Tuple[int, int], order: str = "F") -> BlockGrid:
    """Memoized :class:`BlockGrid`, so repeated calls of one configuration
    reuse it (ops/tiling.py:335-345).

    A memoized grid also holds device tensors once the pipeline has run on
    it: :meth:`BlockGrid.device_constants` (at 1024^2 with 40x40 blocks, 2601
    blocks: the int64 row map 33.3 MB, the cumulative weights 4.2 MB) and
    :meth:`BlockGrid.coset_info` (one int64 id per block, ~41 KB), per
    device. The cache keeps 8 grids; call :func:`clear_block_grid_cache` to
    free that memory when sweeping many FOV or block shapes in one process."""
    return BlockGrid(d1, d2, tuple(block_sizes), order)


def clear_block_grid_cache() -> None:
    """Drop every memoized grid, and with it its cached device constants and
    coset metadata (ops/tiling.py:348-352). Safe at any time: a running
    pipeline and a live ``PMDArray`` keep their own references."""
    block_grid.cache_clear()


# ---------------------------------------------------------------------------
# Patch gather / overlap-add scatter
# ---------------------------------------------------------------------------

def extract_patches(data: torch.Tensor, starts, b1: int, b2: int) -> torch.Tensor:
    """data (d1, d2, T) + starts (n, 2) -> (n, b1, b2, T), one row gather
    over the C-order-flattened FOV.

    The rows are gathered j-major, so the result is a transposed view of a
    contiguous (n, b2, b1, T) buffer: the engine's F-order flatten within
    a block (``flatten_fov(patches)``) is then a free reshape, not a copy
    of the whole patch batch."""
    d1, d2, t = data.shape
    starts = torch.as_tensor(np.asarray(starts), device=data.device).long()
    n = starts.shape[0]
    ar1 = torch.arange(b1, device=data.device)
    ar2 = torch.arange(b2, device=data.device)
    rows = (starts[:, 0, None, None] + ar1[None, None, :]) * d2 + (
        starts[:, 1, None, None] + ar2[None, :, None]
    )                                                          # (n, b2, b1)
    flat = data.reshape(d1 * d2, t)
    return flat.index_select(0, rows.reshape(-1)).reshape(n, b2, b1, t).transpose(1, 2)


def overlap_add(panels: torch.Tensor, rows, n_pixels: int) -> torch.Tensor:
    """Scatter-add (n_blocks, p, k) panels into (n_pixels, k) by global ids."""
    k = panels.shape[-1]
    rows = torch.as_tensor(np.asarray(rows), device=panels.device).long()
    out = torch.zeros((n_pixels, k), dtype=panels.dtype, device=panels.device)
    return out.index_add_(0, rows.reshape(-1), panels.reshape(-1, k))
