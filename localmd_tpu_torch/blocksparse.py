"""Blocked-sparse spatial matrix ``U`` (counterpart of localmd_tpu/blocksparse.py,
canvas forms only).

``U`` is stored as dense per-block panels (n_blocks, p, S) -- p pixels per
block in F order within the block, S component slots zero-padded past each
block's kept rank -- plus a row map (n_blocks, p) of global pixel ids and a
dense background column block. Every product is a batched panel matmul plus
one scatter-add (``matmul``) or gather (``rmatmul``). Zero-padded slots are
exact zero columns, so they add nothing to any product and surface as zero
eigenvalues that the factorized SVD drops. Columns are compacted only at CSR
export (``to_csr``).

The JAX package's TPU-only paths (banded Gram, cell-packed V projection,
coset overlap-add) are not ported; on the CPU the JAX package takes the same
canvas forms as this module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import scipy.sparse
import torch

from localmd_tpu_torch.utils.device import TRANSIENT_FLOOR_BYTES


def _block_group_size(p: int, m: int) -> int:
    """Blocks per step so the (g, p, m) intermediate stays within 1 GiB."""
    return max(8, int(TRANSIENT_FLOOR_BYTES // (p * max(m, 1) * 4)))


def coset_order(cosets, lo: int, hi: int) -> Tuple[np.ndarray, list]:
    """(ids, bounds): the block ids in [lo, hi), minus ``lo``, in coset
    order, and each coset's [start, end) in that order."""
    parts = [ids[(ids >= lo) & (ids < hi)] - lo for ids in (np.asarray(c, np.int64) for c in cosets)]
    return np.concatenate(parts), np.cumsum([0] + [len(x) for x in parts]).tolist()


def coset_overlap_add(panels: torch.Tensor, rows: torch.Tensor, x_block: torch.Tensor,
                      n_pixels: int, bounds: list) -> torch.Tensor:
    """The (n_pixels, m) canvas of every block's ``panels[b] @ x_block[b]``
    scatter-added at ``rows[b]``, the blocks in coset order: a batched panel
    matmul and one ``index_add_`` per group of blocks inside a coset. A
    coset's blocks are disjoint, so no pixel meets two blocks of one
    ``index_add_``: the card's atomic adds land in a fixed order (coset by
    coset) and the result is the same on every run."""
    m = x_block.shape[-1]
    out = torch.zeros((n_pixels, m), dtype=torch.float32, device=x_block.device)
    g = _block_group_size(panels.shape[1], m)
    for a, b in zip(bounds[:-1], bounds[1:]):
        for s in range(a, b, g):
            e = min(s + g, b)
            contrib = panels[s:e] @ x_block[s:e]                        # (g, p, m)
            out.index_add_(0, rows[s:e].reshape(-1), contrib.reshape(-1, m))
    return out


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
    # BlockGrid.cosets()
    starts: np.ndarray            # (n_blocks, 2) int32
    block_shape: Tuple[int, int]
    cosets: tuple
    _by_coset: Optional[tuple] = field(default=None, init=False, repr=False, compare=False)

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
        """(panels, rows, perm, bounds): the panels and rows with their
        blocks in coset order, the block ids in that order and each coset's
        [start, end) in it. Made on the first product and kept, so every
        coset is a contiguous slice and no product gathers the panels."""
        if self._by_coset is None:
            order, bounds = coset_order(self.cosets, 0, self.n_blocks)
            perm = torch.as_tensor(order, device=self.panels.device)
            self._by_coset = (self.panels.index_select(0, perm), self.rows.index_select(0, perm),
                              perm, bounds)
        return self._by_coset

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """U @ x for x (R, m) -> (n_pixels, m): the blocks' part by
        ``coset_overlap_add`` (the same on every run), then the background."""
        nb = self.n_block_cols
        m = x.shape[-1]
        panels, rows, perm, bounds = self._coset_layout()
        x_block = x[:nb].reshape(self.n_blocks, self.slots, m).index_select(0, perm)
        out = coset_overlap_add(panels, rows, x_block, self.n_pixels, bounds)
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

    def gram_quadratic(self, right: torch.Tensor, col_chunk: Optional[int] = None) -> torch.Tensor:
        """Symmetrized right.T (U.T U) right, (m, m): Z^T Z with Z = U @ right
        when one canvas pass fits, else the column-chunked gram_matmul form
        (blocksparse.py:547-569)."""
        m = right.shape[1]
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
