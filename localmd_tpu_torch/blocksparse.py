"""Blocked-sparse spatial matrix ``U`` (counterpart of localmd_tpu/blocksparse.py).

``U`` is stored as dense per-block panels (n_blocks, p, S) -- p pixels per
block in F order within the block, S component slots zero-padded past each
block's kept rank -- plus a row map (n_blocks, p) of global pixel ids and a
dense background column block. Zero-padded slots are exact zero columns, so
they add nothing to any product and surface as zero eigenvalues that the
factorized SVD drops. Columns are compacted only at CSR export (``to_csr``).

Products and their routes:

- ``matmul`` (U @ x): per coset of pairwise-disjoint blocks, a batched
  panel matmul placed into a (d1, d2, m) canvas by reshape and permute
  (``coset_overlap_add``, blocksparse.py:75-119, 407-449); a matrix
  without the grid's placement metadata (``coset_info``) scatters with one
  ``index_add_`` per group of blocks instead. Either way each pixel gets
  one add per coset, in coset order, so the two give the same bits.
- ``rmatmul`` (U.T @ y): a row gather and a batched panel^T matmul.
- ``gram_quadratic`` (right.T U.T U right): on a regular grid with
  ``BANDED_GRAM`` on, the block-banded form (``_banded_gram_quad``,
  blocksparse.py:134-221): per-block Grams and the four neighbour-offset
  pair terms, no canvas; otherwise Z^T Z with Z = U @ right.
- The V projection's cell route (``COSET_VPROJ``, blocksparse.py:224-355):
  ``build_vproj_cells`` packs the std-folded panels and the background by
  (h1, h2) cell, and ``coset_vproj_chunk`` contracts a raw chunk against
  them in one batched product (``loader.PMDLoader.v_projection``).

``BANDED_GRAM`` and ``COSET_VPROJ`` keep the JAX package's names and
values: True or False force a route; "auto" turns it on for tensors on the
card and off on the CPU (``config.route_enabled``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import scipy.sparse
import torch
import torch.nn.functional as F

from localmd_tpu_torch.config import route_enabled
from localmd_tpu_torch.ops.tiling import flatten_fov, unflatten_fov
from localmd_tpu_torch.utils.device import TRANSIENT_FLOOR_BYTES, transient_budget_bytes

BANDED_GRAM = "auto"
COSET_VPROJ = "auto"


def _block_group_size(p: int, m: int) -> int:
    """Blocks per step so the (g, p, m) intermediate stays within 1 GiB."""
    return max(8, int(TRANSIENT_FLOOR_BYTES // (p * max(m, 1) * 4)))


def coset_order(cosets, lo: int, hi: int) -> Tuple[np.ndarray, list]:
    """(ids, bounds): the block ids in [lo, hi), minus ``lo``, in coset
    order, and each coset's [start, end) in that order."""
    parts = [ids[(ids >= lo) & (ids < hi)] - lo for ids in (np.asarray(c, np.int64) for c in cosets)]
    return np.concatenate(parts), np.cumsum([0] + [len(x) for x in parts]).tolist()


def coset_placement(cosets, coset_info, block_shape, lo: int = 0, hi: Optional[int] = None,
                    device="cpu"):
    """The ``placement`` argument of ``coset_overlap_add`` for the blocks in
    [lo, hi) taken in ``coset_order``: each coset's lattice ``meta`` with
    the lattice positions of the blocks present (None when the whole coset
    is), then the FOV, the pixel order and the block shape. ``coset_info``
    is ``BlockGrid.coset_info``; ``cosets`` its block ids on the host."""
    _, metas, d1, d2, order, _ = coset_info
    per = []
    for ids, meta in zip(cosets, metas):
        ids = np.asarray(ids, np.int64)
        keep = (ids >= lo) & (ids < (np.inf if hi is None else hi))
        pos = None if keep.all() else torch.as_tensor(np.nonzero(keep)[0], device=device)
        per.append((meta, pos))
    return tuple(per), int(d1), int(d2), order, int(block_shape[0]), int(block_shape[1])


def _coset_tile(contrib: torch.Tensor, meta, b1: int, b2: int) -> torch.Tensor:
    """One coset's (nc1*nc2, b1*b2, m) F-order panel contributions as its
    (h, w, m) image tile (blocksparse.py:75-92): the blocks of a coset sit
    on a uniform lattice of stride (st1, st2) >= (b1, b2), so this is a
    reshape and permute, with zero gaps where the stride exceeds the block
    (odd block sizes)."""
    nc1, nc2, st1, st2, _, _ = meta
    m = contrib.shape[-1]
    c = contrib.reshape(nc1, nc2, b2, b1, m).permute(0, 3, 1, 2, 4)      # (nc1, b1, nc2, b2, m)
    if st1 > b1 or st2 > b2:
        c = F.pad(c, (0, 0, 0, st2 - b2, 0, 0, 0, st1 - b1))
    c = c.reshape(nc1 * st1, nc2 * st2, m)
    return c[: (nc1 - 1) * st1 + b1, : (nc2 - 1) * st2 + b2]


def coset_overlap_add(panels: torch.Tensor, rows: torch.Tensor, x_block: torch.Tensor,
                      n_pixels: int, bounds: list, placement=None) -> torch.Tensor:
    """The (n_pixels, m) canvas of every block's ``panels[b] @ x_block[b]``
    added at ``rows[b]``, the blocks in coset order (``bounds``: each
    coset's [start, end)).

    With ``placement`` (``coset_placement``) each coset's contributions are
    placed by reshape and permute into a (d1, d2, m) canvas slice and the
    canvas is flattened in the grid's pixel order; the columns go in chunks
    that keep the canvas and one coset's buffers within the transient
    budget (blocksparse.py:407-449). A coset given only in part (a rank's
    share of the blocks) has its missing lattice places filled with zeros.
    Without ``placement``, one ``index_add_`` per group of blocks inside a
    coset. A coset's blocks are disjoint, so either way every pixel gets
    one add per coset, in coset order, from zero: the two forms give the
    same bits, and on the card the same bits on every run."""
    m = x_block.shape[-1]
    g = _block_group_size(panels.shape[1], m)
    segments = list(zip(bounds[:-1], bounds[1:]))

    def contributions(a, b, c0, c1):
        parts = [panels[s: min(s + g, b)] @ x_block[s: min(s + g, b), :, c0:c1]
                 for s in range(a, b, g)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    if placement is None:
        out = torch.zeros((n_pixels, m), dtype=torch.float32, device=x_block.device)
        for a, b in segments:
            for s in range(a, b, g):
                e = min(s + g, b)
                contrib = panels[s:e] @ x_block[s:e]                    # (g, p, m)
                out.index_add_(0, rows[s:e].reshape(-1), contrib.reshape(-1, m))
        return out
    per_coset, d1, d2, order, b1, b2 = placement
    mc = max(32, transient_budget_bytes(x_block.device) // (n_pixels * 4 * 4))
    out = None if m <= mc else torch.empty((n_pixels, m), dtype=torch.float32,
                                          device=x_block.device)
    for c0 in range(0, m, mc):
        c1 = min(c0 + mc, m)
        canvas = torch.zeros((d1, d2, c1 - c0), dtype=torch.float32, device=x_block.device)
        for (a, b), (meta, pos) in zip(segments, per_coset):
            if b == a:
                continue
            contrib = contributions(a, b, c0, c1)                       # (n_g, p, mc)
            if pos is not None:
                full = contrib.new_zeros((meta[0] * meta[1],) + tuple(contrib.shape[1:]))
                contrib = full.index_copy_(0, pos, contrib)
            tile = _coset_tile(contrib, meta, b1, b2)
            a1, a2 = meta[4], meta[5]
            canvas[a1: a1 + tile.shape[0], a2: a2 + tile.shape[1]] += tile
        flat = flatten_fov(canvas, order)
        if out is None:
            return flat
        out[:, c0:c1] = flat
    return out


def _banded_gram_quad(panels: torch.Tensor, right: torch.Tensor, bg: torch.Tensor,
                     rows: torch.Tensor, n1: int, n2: int, h1: int, h2: int) -> torch.Tensor:
    """right^T (U^T U) right on a regular grid (blocksparse.py:146-221).

    Blocks of one coset are disjoint, so U^T U is block-banded: a block
    overlaps only its <= 8 grid neighbours, each overlap a whole number of
    (h1, h2) cells. The quadratic form is the per-block Grams' term plus
    four neighbour-offset pair terms (and their transposes) plus the
    background coupling, with no (d, m) canvas. panels (g, p, S), p in F
    order within the block; right (g*S + K, m); bg (d, K); rows (g, p)."""
    g, p, s_slots = panels.shape
    m = right.shape[1]
    nb = g * s_slots
    xb = right[:nb].reshape(g, s_slots, m)
    xg = right[nb:]
    # p = i + j*b1 -> (j, i) -> (jc, jr, ic, ir)
    cells = panels.reshape(n1, n2, 2, h2, 2, h1, s_slots)
    xgrid = xb.reshape(n1, n2, s_slots, m)

    gd = panels.transpose(1, 2) @ panels                                # (g, S, S)
    quad = xb.reshape(nb, m).T @ (gd @ xb).reshape(nb, m)

    def pair_term(lhs_cells, rhs_cells, lhs_x, rhs_x):
        ni, nj = lhs_cells.shape[0], lhs_cells.shape[1]
        if ni == 0 or nj == 0:
            # a one-row or one-column grid has no neighbour at this offset
            return right.new_zeros((m, m))
        lw = lhs_cells.reshape(ni * nj, -1, s_slots)
        rw = rhs_cells.reshape(ni * nj, -1, s_slots)
        yy = (lw.transpose(1, 2) @ rw) @ rhs_x.reshape(ni * nj, s_slots, m)
        return lhs_x.reshape(ni * nj * s_slots, m).T @ yy.reshape(ni * nj * s_slots, m)

    c = cells
    cross = (
        pair_term(c[:, :-1, 1], c[:, 1:, 0], xgrid[:, :-1], xgrid[:, 1:])            # dj = +1
        + pair_term(c[:-1, :, :, :, 1], c[1:, :, :, :, 0], xgrid[:-1], xgrid[1:])    # di = +1
        + pair_term(c[:-1, :-1, 1, :, 1], c[1:, 1:, 0, :, 0],
                    xgrid[:-1, :-1], xgrid[1:, 1:])                                  # +1, +1
        + pair_term(c[:-1, 1:, 0, :, 1], c[1:, :-1, 1, :, 0],
                    xgrid[:-1, 1:], xgrid[1:, :-1])                                  # +1, -1
    )
    quad = quad + cross + cross.T
    if bg.shape[1]:
        gathered = bg[rows.reshape(-1)].reshape(g, p, -1)
        ub = (panels.transpose(1, 2) @ gathered).reshape(nb, -1)
        cb = (right[:nb].T @ ub) @ xg
        quad = quad + cb + cb.T + xg.T @ ((bg.T @ bg) @ xg)
    return 0.5 * (quad + quad.T)


def coset_vproj_eligible(u) -> bool:
    """Whether ``PMDLoader.v_projection`` takes the cell route for ``u``
    (blocksparse.py:235-245): a regular grid and ``COSET_VPROJ`` on for its
    device."""
    return (
        isinstance(u, BlockSparseMatrix)
        and u.cell_geom is not None
        and route_enabled(COSET_VPROJ, u.panels.device)
    )


def build_vproj_cells(panels: torch.Tensor, rows: torch.Tensor, fov: Tuple[int, int], order: str,
                      geom: Tuple[int, int, int, int], bg: torch.Tensor, std_flat: torch.Tensor,
                      mean_flat: torch.Tensor):
    """The cell route's operands, made once per ``u`` (blocksparse.py:248-313):
    ``m_cell`` (nc1, nc2, h1*h2, 4S + K) -- each (h1, h2) cell of the regular
    grid is covered by exactly four blocks, one per corner role (a, b);
    their std-folded panel slices and the std-folded background pixels of
    the cell stack along one axis -- and ``q = U~^T mean`` (nb*S + K,)."""
    d1, d2 = fov
    n1, n2, h1, h2 = geom
    nc1, nc2 = n1 + 1, n2 + 1
    s_slots = panels.shape[2]
    k_bg = bg.shape[1]
    pan_t = panels * (1.0 / std_flat)[rows][:, :, None]
    # p = i + j*b1 -> (jc, jr, ic, ir)
    pan6 = pan_t.reshape(n1, n2, 2, h2, 2, h1, s_slots)
    slabs = []
    for a in (0, 1):            # corner along dim 1 (i)
        for b in (0, 1):        # corner along dim 2 (j)
            part = pan6[:, :, b, :, a].transpose(2, 3).reshape(n1, n2, h1 * h2, s_slots)
            # block (g1, g2)'s corner (a, b) lies in cell (g1 + a, g2 + b)
            slabs.append(F.pad(part, (0, 0, 0, 0, b, 1 - b, a, 1 - a)))
    if k_bg:
        bg_img = unflatten_fov(bg / std_flat[:, None], d1, d2, order)
        slabs.append(bg_img.reshape(nc1, h1, nc2, h2, k_bg).transpose(1, 2)
                     .reshape(nc1, nc2, h1 * h2, k_bg))
    m_cell = torch.cat(slabs, dim=-1)
    q_blocks = (pan_t * mean_flat[rows][:, :, None]).sum(dim=1).reshape(-1)
    q_bg = bg.T @ (mean_flat / std_flat)
    return m_cell, torch.cat([q_blocks, q_bg])


# frames a cell-route product covers: every frame's V column comes from
# products of this one shape, so its bits do not depend on how the movie
# was cut into chunks or stripes (cuBLAS picks its kernel, and with it the
# order of the sums, from the shapes)
VPROJ_FRAME_TILE = 512


def coset_vproj_chunk(m_cell: torch.Tensor, q: torch.Tensor, p: torch.Tensor, raw: torch.Tensor,
                      n1: int, n2: int, h1: int, h2: int, s_slots: int,
                      layout_span=contextlib.nullcontext) -> torch.Tensor:
    """The V columns of one raw (t, d1, d2) chunk, P^T (U~^T X) - P^T q
    (blocksparse.py:316-355), ``VPROJ_FRAME_TILE`` frames at a time: the
    frames cast and laid out as (cell, pixel, t), one batched product
    against ``m_cell``, then the four corner bands added back into
    per-block rows. No patch gather and no (d, r') canvas. Each tile's
    layout copy runs inside ``layout_span()`` (the loader's
    ``vreg.layout`` span)."""
    nc1, nc2 = n1 + 1, n2 + 1
    ck = m_cell.shape[-1]
    m_t = m_cell.reshape(nc1 * nc2, h1 * h2, ck).transpose(1, 2)
    pq = (p.T @ q)[:, None]
    s = s_slots
    out = []
    for f0 in range(0, raw.shape[0], VPROJ_FRAME_TILE):
        x = raw[f0: f0 + VPROJ_FRAME_TILE]
        t = x.shape[0]
        with layout_span():
            xc = (x.to(torch.float32).reshape(t, nc1, h1, nc2, h2).permute(1, 3, 2, 4, 0)
                  .reshape(nc1 * nc2, h1 * h2, t))
        y = (m_t @ xc).reshape(nc1, nc2, ck, t)
        w = (
            y[0:n1, 0:n2, 0 * s: 1 * s]
            + y[0:n1, 1:, 1 * s: 2 * s]
            + y[1:, 0:n2, 2 * s: 3 * s]
            + y[1:, 1:, 3 * s: 4 * s]
        )
        w_full = w.reshape(n1 * n2 * s, t)
        if ck > 4 * s:
            w_full = torch.cat([w_full, y[:, :, 4 * s:].sum(dim=(0, 1))], dim=0)
        out.append(p.T @ w_full - pq)
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


@dataclass
class BlockSparseMatrix:
    """U = [block panels | dense background basis], shape (n_pixels, R).

    R = n_blocks * slots + dense_basis.shape[1]. Column j of block b lives at
    b * slots + j; background columns follow at the end.
    """

    panels: torch.Tensor          # (n_blocks, p, S) float32
    rows: torch.Tensor            # (n_blocks, p) int64 global pixel ids
    n_pixels: int
    dense_basis: torch.Tensor     # (n_pixels, K) float32 (K >= 0)
    # block geometry: what K3 needs to reconstruct frames without a scatter
    # -- host block origins, block shape and the disjoint cosets of
    # BlockGrid.cosets(). The products need only the cosets; a U made from
    # panels and rows alone, as the JAX package allows, gets the ids of
    # ``coset_info`` when it has one, else one coset a block
    starts: Optional[np.ndarray] = None       # (n_blocks, 2) int32
    block_shape: Optional[Tuple[int, int]] = None
    # the grid's placement metadata (BlockGrid.coset_info): with it and the
    # block shape ``matmul`` places each coset by reshape and permute,
    # without them one index_add_ per group of blocks (the same bits)
    coset_info: Optional[tuple] = None
    # (n1, n2, h1, h2) of a regular grid (BlockGrid.cell_geometry): the
    # banded Gram and the V projection's cell route need it; None keeps
    # the canvas Gram and K2
    cell_geom: Optional[Tuple[int, int, int, int]] = None
    cosets: Optional[tuple] = None
    _by_coset: Optional[tuple] = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.cosets is None:
            if self.coset_info is not None:
                self.cosets = tuple(ids.cpu().numpy() for ids in self.coset_info[0])
            else:
                self.cosets = tuple(np.array([b]) for b in range(self.n_blocks))

    @property
    def n_blocks(self) -> int:
        return self.panels.shape[0]

    @property
    def slots(self) -> int:
        return self.panels.shape[2]

    @property
    def n_block_cols(self) -> int:
        return self.n_blocks * self.slots

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_pixels, self.n_block_cols + self.dense_basis.shape[1])

    # -- products -------------------------------------------------------------

    def _coset_layout(self):
        """(panels, rows, perm, bounds, placement): the panels and rows with
        their blocks in coset order, the block ids in that order, each
        coset's [start, end) in it and the placement metadata (None without
        ``coset_info``). Made on the first product and kept, so every coset
        is a contiguous slice and no product gathers the panels."""
        if self._by_coset is None:
            order, bounds = coset_order(self.cosets, 0, self.n_blocks)
            if self.coset_info is not None and self.block_shape is not None:
                # the rows are not read by the placement
                perm = torch.cat(self.coset_info[0])
                rows = self.rows
                placement = coset_placement(self.cosets, self.coset_info, self.block_shape)
            else:
                perm = torch.as_tensor(order, device=self.panels.device)
                rows = self.rows.index_select(0, perm)
                placement = None
            self._by_coset = (self.panels.index_select(0, perm), rows, perm, bounds, placement)
        return self._by_coset

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """U @ x for x (R, m) -> (n_pixels, m): the blocks' part by
        ``coset_overlap_add`` (the same on every run), then the background."""
        nb = self.n_block_cols
        m = x.shape[-1]
        panels, rows, perm, bounds, placement = self._coset_layout()
        x_block = x[:nb].reshape(self.n_blocks, self.slots, m).index_select(0, perm)
        out = coset_overlap_add(panels, rows, x_block, self.n_pixels, bounds, placement)
        if self.dense_basis.shape[1]:
            out = out + self.dense_basis @ x[nb:]
        return out

    def rmatmul(self, y: torch.Tensor) -> torch.Tensor:
        """U.T @ y for y (n_pixels, m) -> (R, m): per block group, a row
        gather and a batched panel^T matmul."""
        m = y.shape[-1]
        g = _block_group_size(self.panels.shape[1], m)
        parts = []
        for s in range(0, self.n_blocks, g):
            gathered = y[self.rows[s : s + g]]                          # (g, p, m)
            parts.append(self.panels[s : s + g].transpose(-1, -2) @ gathered)
        block_part = torch.cat(parts, dim=0).reshape(self.n_block_cols, m)
        if self.dense_basis.shape[1]:
            return torch.cat([block_part, self.dense_basis.T @ y], dim=0)
        return block_part

    def gram_matmul(self, x: torch.Tensor, col_chunk: Optional[int] = None) -> torch.Tensor:
        """(U.T U) @ x without forming the Gram, optionally column-chunked."""
        m = x.shape[1]
        if col_chunk is None or m <= col_chunk:
            return self.rmatmul(self.matmul(x))
        return torch.cat(
            [self.rmatmul(self.matmul(x[:, s : s + col_chunk])) for s in range(0, m, col_chunk)],
            dim=1,
        )

    def banded_gram_ready(self, m: int) -> bool:
        """Whether ``gram_quadratic`` at ``m`` columns takes the banded form
        (blocksparse.py:532-545): a regular grid, ``BANDED_GRAM`` on for the
        panels' device, and its (g, S, m)-class intermediates and the
        background gather within the transient budget."""
        if self.cell_geom is None or not route_enabled(BANDED_GRAM, self.panels.device):
            return False
        k_bg = self.dense_basis.shape[1]
        need = 4 * (3 * self.n_block_cols * m + self.n_blocks * self.panels.shape[1] * max(k_bg, 1))
        return need <= transient_budget_bytes(self.panels.device)

    def gram_quadratic(self, right: torch.Tensor, col_chunk: Optional[int] = None) -> torch.Tensor:
        """Symmetrized right.T (U.T U) right, (m, m) (blocksparse.py:547-569):
        the banded form when ``banded_gram_ready``; else Z^T Z with
        Z = U @ right when one canvas pass fits, else the column-chunked
        gram_matmul form."""
        m = right.shape[1]
        if self.banded_gram_ready(m):
            return _banded_gram_quad(self.panels, right, self.dense_basis, self.rows,
                                     *self.cell_geom)
        if col_chunk is None or m <= col_chunk:
            z = self.matmul(right)
            g = z.T @ z
        else:
            g = right.T @ self.gram_matmul(right, col_chunk=col_chunk)
        return 0.5 * (g + g.T)

    # -- export ---------------------------------------------------------------

    def to_csr(self, counts: np.ndarray) -> Tuple[scipy.sparse.csr_matrix, np.ndarray]:
        """Compact to scipy CSR, dropping unused slots (blocksparse.py:573-616).
        Returns the (n_pixels, sum(counts) + K) matrix and the map from
        compacted column id to padded global column id."""
        counts = np.asarray(counts, dtype=np.int64)
        panels = self.panels.detach().cpu().numpy()
        rows = self.rows.detach().cpu().numpy()
        col_map = []
        data_parts, row_parts, col_parts = [], [], []
        col_cursor = 0
        for b in range(self.n_blocks):
            c = int(counts[b])
            if c == 0:
                continue
            panel = panels[b, :, :c]
            data_parts.append(panel.reshape(-1))
            row_parts.append(np.repeat(rows[b], c))
            col_parts.append(np.tile(np.arange(col_cursor, col_cursor + c), panels.shape[1]))
            col_map.extend(b * self.slots + j for j in range(c))
            col_cursor += c
        k_bg = int(self.dense_basis.shape[1])
        if data_parts:
            coo = scipy.sparse.coo_matrix(
                (
                    np.concatenate(data_parts),
                    (np.concatenate(row_parts), np.concatenate(col_parts)),
                ),
                shape=(self.n_pixels, col_cursor),
            )
        else:
            coo = scipy.sparse.coo_matrix((self.n_pixels, 0))
        if k_bg:
            bg = scipy.sparse.coo_matrix(self.dense_basis.detach().cpu().numpy())
            full = scipy.sparse.hstack([coo, bg]).tocsr()
            col_map.extend(self.n_block_cols + j for j in range(k_bg))
        else:
            full = coo.tocsr()
        return full, np.asarray(col_map, dtype=np.int64)
