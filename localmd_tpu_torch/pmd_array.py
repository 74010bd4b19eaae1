"""PMDArray -- lazy array view over the compressed movie ``[U R] s Vt``
(counterpart of localmd_tpu/pmd_array.py).

Slicing (``pmd[frames, rows, cols]``) follows the reference semantics
through the host CSR path (pmd_array.py:532-589): the blocked U is compacted
to scipy CSR with ``k2_keep`` dropping pruned singular-value slots. Device
frames come from ``reconstruct_frames``, which runs K3 chunk by chunk and
never builds the full-T (R s) V product.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse
import torch

from localmd_tpu_torch.blocksparse import BlockSparseMatrix
from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops.tiling import BlockGrid, unflatten_fov

RECON_CHUNK_FRAMES = 512


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PMDArray:
    def __init__(
        self,
        u: Union[scipy.sparse.spmatrix, BlockSparseMatrix],
        r,
        s,
        v,
        data_shape: Tuple[int, int, int],
        data_order: str,
        mean_img,
        std_img,
        counts: Optional[np.ndarray] = None,
        k2_keep: Optional[np.ndarray] = None,
    ):
        """
        Args:
            u: (d, K1) spatial basis: scipy sparse, or a BlockSparseMatrix
                with zero-padded slots (then ``counts`` gives kept
                components per block and U compacts lazily).
            r: (K1, K2) mixing matrix; U @ R has orthonormal columns.
            s: (K2,) singular values; v: (K2, T) temporal basis.
            data_shape: (n_frames, d1, d2); data_order: "F" or "C".
            mean_img / std_img: (d1, d2) normalization images.
            k2_keep: optional (K2,) mask of kept singular-value slots; the
                pipeline zeroes pruned values of ``s`` instead of compacting
                R and V, and host factors compact through this mask.
        """
        self.order = data_order
        self.num_frames, self.fov_dim1, self.fov_dim2 = (int(x) for x in data_shape)
        self._blocksparse: Optional[BlockSparseMatrix] = None
        self._counts = counts
        if k2_keep is not None:
            k2_keep = np.asarray(k2_keep, dtype=bool)
            if bool(k2_keep.all()):
                k2_keep = None
        self._k2_keep = k2_keep

        if isinstance(u, BlockSparseMatrix):
            if counts is None:
                raise ValueError("counts required with a BlockSparseMatrix U")
            self._blocksparse = u
            self._u_csr = None
            self._col_map = None
            self._r_padded = r
            self._r_compact = None
        else:
            self._u_csr = u.tocsr()
            self._col_map = None
            self._r_padded = None
            rc = _host(r)
            if self._k2_keep is not None:
                rc = rc[:, self._k2_keep]
            self._r_compact = rc

        self._s_src = s
        self._s_host: Optional[np.ndarray] = None
        self._v_src = v
        self._v_host: Optional[np.ndarray] = None
        self._combined_temporal_host: Optional[np.ndarray] = None
        self._mean_src = mean_img
        self._mean_host: Optional[np.ndarray] = None
        self._var_src = std_img
        self._var_host: Optional[np.ndarray] = None
        self._rs_dev = None
        self._panels_c = None
        self._recon_plan = None
        self.row_indices = np.arange(self.fov_dim1 * self.fov_dim2).reshape(
            (self.fov_dim1, self.fov_dim2), order=self.order
        )

    @classmethod
    def from_reference_state(cls, state: dict, device="cuda") -> "PMDArray":
        """Build the port's PMDArray from the numpy state of a JAX-package
        PMDArray: ``panels``, ``rows``, ``dense_basis``, ``starts``,
        ``block_shape``, ``counts``, ``r`` (padded), ``s``, ``v``,
        ``k2_keep`` (or None), ``mean_img``, ``std_img`` and optionally
        ``order`` (default "F"). The factors go to the card unless
        ``device="cpu"`` is passed; raises without CUDA."""
        dev = resolve_device(device)
        order = str(state.get("order", "F"))
        mean_img = np.asarray(state["mean_img"], dtype=np.float32)
        d1, d2 = mean_img.shape
        b1, b2 = (int(b) for b in state["block_shape"])
        starts = np.asarray(state["starts"], dtype=np.int32)
        grid = BlockGrid(d1, d2, (b1, b2), order)
        if not np.array_equal(grid.starts, starts):
            raise ValueError("starts do not match the block grid of this FOV and block shape")

        def f32(name):
            return torch.tensor(np.asarray(state[name], dtype=np.float32), device=dev)

        u = BlockSparseMatrix(
            panels=f32("panels"),
            rows=torch.as_tensor(np.asarray(state["rows"], dtype=np.int64), device=dev),
            n_pixels=d1 * d2,
            dense_basis=f32("dense_basis"),
            starts=starts,
            block_shape=(b1, b2),
            cosets=tuple(ids for ids, _ in grid.cosets()),
        )
        v = f32("v")
        return cls(
            u, f32("r"), np.asarray(state["s"], dtype=np.float32), v,
            (v.shape[1], d1, d2), order, f32("mean_img"), f32("std_img"),
            counts=np.asarray(state["counts"]), k2_keep=state.get("k2_keep"),
        )

    # -- lazy host materialization ---------------------------------------------

    def _ensure_csr(self):
        if self._u_csr is None:
            self._u_csr, self._col_map = self._blocksparse.to_csr(self._counts)
        return self._u_csr

    @property
    def u(self) -> scipy.sparse.csr_matrix:
        return self._ensure_csr()

    @property
    def r(self) -> np.ndarray:
        if self._r_compact is None:
            self._ensure_csr()
            rc = _host(self._r_padded)[self._col_map, :]
            if self._k2_keep is not None:
                rc = rc[:, self._k2_keep]
            self._r_compact = rc
        return self._r_compact

    @property
    def s(self) -> np.ndarray:
        if self._s_host is None:
            sh = _host(self._s_src)
            if self._k2_keep is not None:
                sh = sh[self._k2_keep]
            self._s_host = sh
        return self._s_host

    @property
    def v(self) -> np.ndarray:
        if self._v_host is None:
            vh = _host(self._v_src)
            if self._k2_keep is not None:
                vh = vh[self._k2_keep]
            self._v_host = vh
        return self._v_host

    @property
    def mean_img(self) -> np.ndarray:
        if self._mean_host is None:
            self._mean_host = _host(self._mean_src)
        return self._mean_host

    @property
    def var_img(self) -> np.ndarray:
        if self._var_host is None:
            self._var_host = _host(self._var_src)
        return self._var_host

    @property
    def dtype(self):
        return np.float32

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.num_frames, self.fov_dim1, self.fov_dim2)

    @property
    def ndim(self) -> int:
        return 3

    @property
    def rank(self) -> int:
        if self._k2_keep is not None:
            return int(self._k2_keep.sum())
        return int(np.shape(self._s_src)[0])

    @property
    def _combined_temporal(self) -> np.ndarray:
        """(K1_compact, T) = (R * s) V on the host, built lazily."""
        if self._combined_temporal_host is None:
            self._combined_temporal_host = (self.r * self.s[None, :]).dot(self.v)
        return self._combined_temporal_host

    # -- device reconstruction (K3) --------------------------------------------

    def reconstruct_frames(self, frame_indices) -> torch.Tensor:
        """Full-FOV frames (n, d1, d2), un-normalized (x std + mean), on the
        factors' device. Chunks of 512 frames: each computes its own
        (R s) V[:, chunk] and runs K3 -- no full-T product is cached."""
        frame_indices = np.atleast_1d(np.asarray(frame_indices))
        if self._blocksparse is None:
            out = self._getitem_host((frame_indices, slice(None), slice(None)))
            return torch.as_tensor(out.reshape((-1, self.fov_dim1, self.fov_dim2)))
        u = self._blocksparse
        dev = u.panels.device
        if self._rs_dev is None:
            s = torch.as_tensor(_host(self._s_src), dtype=torch.float32, device=dev)
            self._rs_dev = torch.as_tensor(self._r_padded, device=dev) * s[None, :]
        v = torch.as_tensor(self._v_src, device=dev)
        std = torch.as_tensor(self._var_src, device=dev)[..., None]
        mean = torch.as_tensor(self._mean_src, device=dev)[..., None]
        parts = []
        for s0 in range(0, len(frame_indices), RECON_CHUNK_FRAMES):
            sub = torch.as_tensor(frame_indices[s0 : s0 + RECON_CHUNK_FRAMES], device=dev)
            temporal = self._rs_dev @ v.index_select(1, sub)          # (R, f)
            movie = self._reconstruct_standardized(temporal) * std + mean
            parts.append(movie.permute(2, 0, 1))
        return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]

    def _reconstruct_standardized(self, temporal: torch.Tensor) -> torch.Tensor:
        """U @ temporal as a (d1, d2, f) image: K3 over the block panels
        (pmd_array.py:325-360) plus the dense background term. The C-order
        panels and, on the card, K3's block lists are made on the first
        call and kept."""
        u = self._blocksparse
        d1, d2 = self.fov_dim1, self.fov_dim2
        b1, b2 = u.block_shape
        if self._panels_c is None:
            self._panels_c = kernels.panels_f_to_c(u.panels, b1, b2)
            if self._panels_c.device.type == "cuda":
                self._recon_plan = kernels.prepare_reconstruct(
                    u.starts, u.cosets, (d1, d2), (b1, b2), self._panels_c.device
                )
        nb = u.n_block_cols
        f = temporal.shape[-1]
        t_blocks = temporal[:nb].reshape(u.n_blocks, u.slots, f).contiguous()
        img = kernels.block_reconstruct(
            self._panels_c, t_blocks, u.starts, u.cosets, (d1, d2), (b1, b2), self._recon_plan
        )
        if u.dense_basis.shape[1]:
            img = img + unflatten_fov(u.dense_basis @ temporal[nb:], d1, d2, self.order)
        return img

    # -- host slicing (reference semantics) --------------------------------------

    def _parse_int_to_list(self, elt):
        if isinstance(elt, (int, np.integer)):
            return [int(elt)]
        return elt

    def spatial_crop(self, key):
        if key[0] is None or key[1] is None:
            raise ValueError("Cannot pass None for indexing")
        key = (self._parse_int_to_list(key[0]), self._parse_int_to_list(key[1]))
        used_rows = self.row_indices[key[0], key[1]]
        mean_used = self.mean_img[key[0], key[1]]
        var_used = self.var_img[key[0], key[1]]
        u_used = self._ensure_csr()[used_rows.reshape((-1,), order=self.order)]
        return u_used, mean_used, var_used, used_rows.shape

    def temporal_crop(self, key) -> np.ndarray:
        if key is None:
            raise ValueError("Cannot use None for indexing")
        return self._combined_temporal[:, self._parse_int_to_list(key)]

    def _getitem_host(self, key) -> np.ndarray:
        if len(key) > 3:
            raise ValueError("Too many indices in __getitem__")
        k1 = key[1] if len(key) > 1 else slice(None)
        k2 = key[2] if len(key) > 2 else slice(None)
        spatial, mean_used, var_used, implied_fov = self.spatial_crop((k1, k2))
        temporal = self.temporal_crop(key[0])
        output = spatial.dot(temporal)
        output = output.reshape(implied_fov + (-1,), order=self.order) * np.expand_dims(
            var_used, axis=var_used.ndim
        ) + np.expand_dims(mean_used, axis=mean_used.ndim)
        return np.transpose(output, axes=(output.ndim - 1, *range(output.ndim - 1)))

    def __getitem__(self, key) -> np.ndarray:
        if key is None:
            raise ValueError("Cannot use None for indexing")
        if not isinstance(key, tuple):
            key = (key,)
        return self._getitem_host(key).squeeze().astype(self.dtype)

    # -- serialization ----------------------------------------------------------

    def to_npz(self, filename: str) -> None:
        from localmd_tpu_torch.serialization import save_decomposition

        save_decomposition(filename, self)

    @classmethod
    def from_npz(cls, filename: str) -> "PMDArray":
        from localmd_tpu_torch.serialization import load_decomposition

        return load_decomposition(filename)
