"""PMDArray -- lazy array view over the compressed movie ``[U R] s Vt``
(counterpart of localmd_tpu/pmd_array.py).

Slicing (``pmd[frames, rows, cols]``) follows the reference semantics. While
the device factors are live it runs on their device (``_getitem_device``,
pmd_array.py:364-499) from one plan per request (``_plan``; a box key's
comes from its slices' arithmetic): only the blocks that meet the
requested ROI are touched -- a batched ``torch.bmm`` of their panels and
temporal slices, placed by ``index_put_(accumulate=True)`` with rows and
columns outside the ROI dropped -- and the frame axis is cut into chunks
whose buffers fit the device's transient budget. Arrays built from host
factors (.npz, scipy) or closed ones slice through the host CSR path
(pmd_array.py:532-589).
``reconstruct_frames`` runs K3 chunk by chunk and never builds the full-T
(R s) V product; ``export_tiff`` streams it into a TIFF.

Where a result lives: a device slice of factors on the card, if its bytes
fit the device's transient budget, is copied straight into page-locked
host memory (one DMA at the link's rate) and returned as a numpy view of
that memory, which the array keeps alive; once the array dies, torch's
caching host allocator keeps the block for the next result of its
power-of-two size. Every other result lives in pageable host memory. Neither is copied
again on the host: ``__getitem__`` returns float32 as it comes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import scipy.sparse
import torch

from localmd_tpu_torch.blocksparse import BlockSparseMatrix
from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops.tiling import BlockGrid, unflatten_fov
from localmd_tpu_torch.utils.device import transient_budget_bytes
from localmd_tpu_torch.utils.logging import count, span

RECON_CHUNK_FRAMES = 512
_CLOSED = (
    "PMDArray was closed with materialize=False before its host factors "
    "were materialized; no data remains"
)

# Per-chunk budget of device slicing's transient buffers: the device's
# transient budget (memory / 16, 1 GiB floor) unless a number here pins it
# (tests, debugging).
_SLICE_CANVAS_BUDGET_BYTES = None


def _slice_canvas_budget(device) -> int:
    if _SLICE_CANVAS_BUDGET_BYTES is not None:
        return _SLICE_CANVAS_BUDGET_BYTES
    return transient_budget_bytes(device)


def _roi_reconstruct(panels_sub, t_sub, starts_rel, bg_rows, bg_t, b1, b2, h, w):
    """Standardized reconstruction of an (h, w) ROI from the blocks that
    meet it (pmd_array.py:57-94): a batched panel product, placed by
    ``index_put_(accumulate=True)``; entries outside the ROI go to one
    spare row that is dropped. Plus the dense background term.

    panels_sub (k, b1*b2, S) F-order panel rows; t_sub (k, S, f); starts_rel
    (k, 2) block origins relative to the ROI origin (may be negative or
    reach past it); bg_rows (h*w, K); bg_t (K, f). Returns (h, w, f)."""
    dev = panels_sub.device
    f = t_sub.shape[-1]
    contrib = torch.bmm(panels_sub, t_sub)                     # (k, p, f)
    rr = starts_rel[:, 0, None] + torch.arange(b1, device=dev)  # (k, b1)
    cc = starts_rel[:, 1, None] + torch.arange(b2, device=dev)  # (k, b2)
    # F-order panel row i + j * b1 lies at (rr[i], cc[j]): index (k, b2, b1)
    inside = ((rr >= 0) & (rr < h))[:, None, :] & ((cc >= 0) & (cc < w))[:, :, None]
    flat = torch.where(inside, rr[:, None, :] * w + cc[:, :, None], h * w)
    canvas = torch.zeros((h * w + 1, f), dtype=torch.float32, device=dev)
    canvas.index_put_((flat.reshape(-1),), contrib.reshape(-1, f), accumulate=True)
    return (canvas[: h * w] + bg_rows @ bg_t).reshape(h, w, f)


class _SlicePlan(NamedTuple):
    """One slicing request, worked out once (``PMDArray._plan``) and
    passed to each of its chunks. An empty selection keeps only ``shape``
    and ``frames``."""

    shape: tuple                               # numpy's shape of row_indices[k1, k2]
    frames: np.ndarray                         # the frame ids
    r0: int = 0                                # the ROI box: origin (r0, c0), size (h, w)
    c0: int = 0
    h: int = 0
    w: int = 0
    hit: Optional[torch.Tensor] = None         # ids of the blocks that meet the box
    starts_rel: Optional[torch.Tensor] = None  # their origins relative to (r0, c0)
    ids: Optional[torch.Tensor] = None         # the box's dense-basis rows, row-major
    rel: Optional[torch.Tensor] = None         # the selection in the box; None: the box
    mean: Optional[torch.Tensor] = None        # (*shape, 1) on the factors' device
    std: Optional[torch.Tensor] = None

    @property
    def empty(self) -> bool:
        return self.hit is None


def _box_extent(k, n: int):
    """(start, length) of an index that is an int or a step-1 slice over an
    axis of n, else None. Only for a selection numpy has made and found
    not empty: an int is then within the axis, a slice's stop past its
    start."""
    if isinstance(k, (int, np.integer)):
        return int(k) % n, 1
    if isinstance(k, slice):
        start, stop, step = k.indices(n)
        if step == 1:
            return start, stop - start
    return None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PMDArray:
    """The compressed movie ``[U R] s Vt`` as a lazy (T, d1, d2) array.

    ``slice_counters`` counts the device slicing of ``__getitem__`` (and
    ``slice_device``, for the plan's keys):

    - ``slice.box``, ``slice.gather``: requests per plan route -- a box key
      (ints and step-1 slices) sliced out of device copies, or any other
      key gathered from its bounding box (``_plan``);
    - ``slice.plan_s``: host seconds of the ``pmd.plan`` span, the key's
      selection and the plan's set-up, before any chunk is launched;
    - ``slice.pinned``: requests whose result was copied into page-locked
      host memory (factors on the card, result within the device's
      transient budget);
    - ``slice.pageable``: requests served in pageable host memory (factors
      on the CPU, a larger result, or a page-locked allocation that raised);
    - ``slice.host_bytes``: the bytes of the results delivered;
    - ``slice.to_host_s``: host seconds of the ``pmd.to_host`` span, from
      the output's allocation to the end of the wait for its copies (the
      chunks' launches and the device work still queued included).

    A page-locked result keeps its block while the caller holds the array;
    afterwards torch's caching host allocator keeps the block (the request
    rounded up to a power of two) for reuse and does not return it to the
    system. One request holds at most the device's transient budget
    (``utils.device.transient_budget_bytes``) before that rounding.
    """

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
        device=None,
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
            device: with a scipy ``u``, the device on which
                ``reconstruct_frames`` runs (the CSR factors are moved
                there on its first call); None keeps it on the host path.
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
        self._csr_device = None if device is None else resolve_device(device)
        self._csr_dev = None
        self._slice_dev = None
        self.row_indices = np.arange(self.fov_dim1 * self.fov_dim2).reshape(
            (self.fov_dim1, self.fov_dim2), order=self.order
        )
        self.slice_counters: dict = {}

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
            if self._blocksparse is None:
                raise RuntimeError(_CLOSED)
            self._u_csr, self._col_map = self._blocksparse.to_csr(self._counts)
        return self._u_csr

    @property
    def u(self) -> scipy.sparse.csr_matrix:
        return self._ensure_csr()

    @property
    def r(self) -> np.ndarray:
        if self._r_compact is None:
            self._ensure_csr()
            if self._r_padded is None:
                raise RuntimeError(_CLOSED)
            rc = _host(self._r_padded)[self._col_map, :]
            if self._k2_keep is not None:
                rc = rc[:, self._k2_keep]
            self._r_compact = rc
        return self._r_compact

    @property
    def s(self) -> np.ndarray:
        if self._s_host is None:
            if self._s_src is None:
                raise RuntimeError(_CLOSED)
            sh = _host(self._s_src)
            if self._k2_keep is not None:
                sh = sh[self._k2_keep]
            self._s_host = sh
        return self._s_host

    @property
    def v(self) -> np.ndarray:
        if self._v_host is None:
            if self._v_src is None:
                raise RuntimeError(_CLOSED)
            vh = _host(self._v_src)
            if self._k2_keep is not None:
                vh = vh[self._k2_keep]
            self._v_host = vh
        return self._v_host

    @property
    def mean_img(self) -> np.ndarray:
        if self._mean_host is None:
            if self._mean_src is None:
                raise RuntimeError(_CLOSED)
            self._mean_host = _host(self._mean_src)
        return self._mean_host

    @property
    def var_img(self) -> np.ndarray:
        if self._var_host is None:
            if self._var_src is None:
                raise RuntimeError(_CLOSED)
            self._var_host = _host(self._var_src)
        return self._var_host

    @property
    def dtype(self):
        return np.float32

    @property
    def device(self) -> torch.device:
        """Where ``reconstruct_frames`` runs and returns its frames: the
        block panels' device, a .npz array's ``device``, else the CPU (the
        host path)."""
        if self._blocksparse is not None:
            return self._blocksparse.panels.device
        return self._csr_device if self._csr_device is not None else torch.device("cpu")

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
        src = self._s_host if self._s_src is None else self._s_src
        if src is None:
            raise RuntimeError(_CLOSED)
        return int(np.shape(src)[0])

    @property
    def _combined_temporal(self) -> np.ndarray:
        """(K1_compact, T) = (R * s) V on the host, built lazily."""
        if self._combined_temporal_host is None:
            self._combined_temporal_host = (self.r * self.s[None, :]).dot(self.v)
        return self._combined_temporal_host

    def _rs(self) -> torch.Tensor:
        """(R_padded, K2) = R * s on the factors' device, made once."""
        if self._rs_dev is None:
            dev = self._blocksparse.panels.device
            s = torch.tensor(_host(self._s_src), dtype=torch.float32, device=dev)
            self._rs_dev = torch.as_tensor(self._r_padded, device=dev) * s[None, :]
        return self._rs_dev

    # -- device reconstruction (K3) --------------------------------------------

    def reconstruct_frames(self, frame_indices) -> torch.Tensor:
        """Full-FOV frames (n, d1, d2), un-normalized (x std + mean), on the
        factors' device. Chunks of 512 frames: each computes its own
        (R s) V[:, chunk] and runs K3 -- no full-T product is cached."""
        frame_indices = np.atleast_1d(np.asarray(frame_indices))
        if self._blocksparse is None:
            if self._csr_device is not None and self._v_src is not None:
                return self._reconstruct_csr(frame_indices)
            out = self._getitem_host((frame_indices, slice(None), slice(None)))
            return torch.as_tensor(out.reshape((-1, self.fov_dim1, self.fov_dim2)))
        dev = self._blocksparse.panels.device
        rs = self._rs()
        v = torch.as_tensor(self._v_src, device=dev)
        std = torch.as_tensor(self._var_src, device=dev)[..., None]
        mean = torch.as_tensor(self._mean_src, device=dev)[..., None]
        parts = []
        for s0 in range(0, len(frame_indices), RECON_CHUNK_FRAMES):
            sub = torch.as_tensor(frame_indices[s0 : s0 + RECON_CHUNK_FRAMES], device=dev)
            temporal = rs @ v.index_select(1, sub)                   # (R, f)
            movie = self._reconstruct_standardized(temporal) * std + mean
            parts.append(movie.permute(2, 0, 1).contiguous())
        return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]

    def _reconstruct_csr(self, frame_indices: np.ndarray) -> torch.Tensor:
        """``reconstruct_frames`` of an array built from a scipy U (a .npz)
        with a ``device``: the host path's U @ ((R s) V[:, frames]) x std +
        mean as a sparse CSR product there, chunk by chunk. The factors
        move to the device on the first call and are kept until ``close``."""
        dev = self._csr_device
        if self._csr_dev is None:
            u = self._ensure_csr()
            self._csr_dev = (
                torch.sparse_csr_tensor(
                    torch.as_tensor(u.indptr, dtype=torch.int64),
                    torch.as_tensor(u.indices, dtype=torch.int64),
                    torch.as_tensor(u.data, dtype=torch.float32), size=u.shape,
                ).to(dev),
                torch.as_tensor((self.r * self.s[None, :]).astype(np.float32), device=dev),
                torch.as_tensor(self.v.astype(np.float32), device=dev),
                torch.as_tensor(self.var_img.astype(np.float32), device=dev)[..., None],
                torch.as_tensor(self.mean_img.astype(np.float32), device=dev)[..., None],
            )
        u, rs, v, std, mean = self._csr_dev
        parts = []
        for s0 in range(0, len(frame_indices), RECON_CHUNK_FRAMES):
            sub = torch.as_tensor(frame_indices[s0 : s0 + RECON_CHUNK_FRAMES], device=dev)
            img = unflatten_fov(u @ (rs @ v.index_select(1, sub)), self.fov_dim1, self.fov_dim2,
                                self.order)
            parts.append((img * std + mean).permute(2, 0, 1).contiguous())
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

    # -- device slicing -----------------------------------------------------------

    def _device_temporal(self, frame_idx) -> torch.Tensor:
        """(R_padded, f) = (R * s) V[:, frame_idx], computed per call: slicing
        never builds the (R_padded, T) product (pmd_array.py:364-376)."""
        v = torch.as_tensor(self._v_src, device=self._blocksparse.panels.device)
        index = torch.as_tensor(np.asarray(frame_idx, dtype=np.int64), device=v.device)
        return self._rs() @ v.index_select(1, index)

    def _normalize_key3(self, key):
        """Split a __getitem__ key into (frames, k1, k2) with the reference's
        validation (key order [frames, dim1, dim2])."""
        if len(key) > 3:
            raise ValueError("Too many indices in __getitem__")
        frames = key[0]
        k1 = key[1] if len(key) > 1 else slice(None)
        k2 = key[2] if len(key) > 2 else slice(None)
        if frames is None or k1 is None or k2 is None:
            raise ValueError("Cannot use None for indexing")
        return frames, k1, k2

    def _pixel_coords(self, used_rows: np.ndarray):
        """(row, col) image coordinates of global flat pixel ids."""
        if self.order == "F":
            return used_rows % self.fov_dim1, used_rows // self.fov_dim1
        return used_rows // self.fov_dim2, used_rows % self.fov_dim2

    def _slice_images(self):
        """(row_indices, mean, std) on the factors' device, made once:
        a slicing plan cuts its box out of these."""
        if self._slice_dev is None:
            dev = self._blocksparse.panels.device
            self._slice_dev = (
                torch.as_tensor(np.ascontiguousarray(self.row_indices), device=dev),
                torch.as_tensor(self._mean_src, dtype=torch.float32, device=dev),
                torch.as_tensor(self._var_src, dtype=torch.float32, device=dev),
            )
        return self._slice_dev

    def _plan(self, key) -> _SlicePlan:
        """The slicing plan of a key, built once per request (the span
        ``pmd.plan``). numpy indexes ``row_indices[k1, k2]`` once, so fancy
        pairing, slices, negatives and bounds errors are its own, as on the
        host path. A box key (k1 and k2 each an int or a step-1 slice) takes
        its box from the slices' arithmetic and its dense-basis rows, mean
        and std as slices of ``_slice_images``: no per-pixel host work and
        no upload but the hit blocks' ids and origins (``slice.box``). Any
        other key finds its bounding box from its pixels' coordinates and
        gathers the selection from the box through ``rel``
        (``slice.gather``)."""
        counters = self.slice_counters
        with span(counters, "slice.plan_s", "pmd.plan"):
            frames, k1, k2 = self._normalize_key3(key)
            used_rows = self.row_indices[self._parse_int_to_list(k1), self._parse_int_to_list(k2)]
            frame_idx = np.atleast_1d(np.arange(self.num_frames)[self._parse_int_to_list(frames)])
            shape = used_rows.shape
            if used_rows.size == 0 or frame_idx.size == 0:
                return _SlicePlan(shape, frame_idx)
            u = self._blocksparse
            dev = u.panels.device
            rows_dev, mean_dev, std_dev = self._slice_images()
            box_r, box_c = _box_extent(k1, self.fov_dim1), _box_extent(k2, self.fov_dim2)
            if box_r is not None and box_c is not None:
                (r0, h), (c0, w) = box_r, box_c
                rel = None
            else:
                r, c = self._pixel_coords(np.asarray(used_rows))
                r0, c0 = int(r.min()), int(c.min())
                h, w = int(r.max()) + 1 - r0, int(c.max()) + 1 - c0
                rel = torch.as_tensor(((r - r0) * w + (c - c0)).reshape(-1), device=dev)
            count(counters, "slice.box" if rel is None else "slice.gather", 1)
            b1, b2 = u.block_shape
            st = np.asarray(u.starts, dtype=np.int64)
            hit = np.nonzero(
                (st[:, 0] < r0 + h) & (st[:, 0] + b1 > r0) & (st[:, 1] < c0 + w) & (st[:, 1] + b2 > c0)
            )[0]

            def selected(img):
                box = img[r0 : r0 + h, c0 : c0 + w]
                if rel is not None:
                    box = box.reshape(-1).index_select(0, rel)
                return box.reshape(shape)[..., None]

            return _SlicePlan(
                shape, frame_idx, r0, c0, h, w,
                hit=torch.as_tensor(hit, device=dev),
                starts_rel=torch.as_tensor(st[hit] - np.array([r0, c0]), device=dev),
                ids=rows_dev[r0 : r0 + h, c0 : c0 + w].reshape(-1),
                rel=rel, mean=selected(mean_dev), std=selected(std_dev),
            )

    def _slice_frame_bytes(self, plan: _SlicePlan) -> int:
        """Device bytes one frame of a slicing chunk allocates: the ROI
        canvas and its background product (the plan's box, however few of
        its pixels are selected; pmd_array.py:390-408), the hit blocks'
        (k, b1*b2) product -- about four canvases at 50% overlap, which a
        canvas-only budget (pmd_array.py:491-492) leaves out -- and the
        temporal column."""
        u = self._blocksparse
        b1, b2 = u.block_shape
        return 4 * (2 * plan.h * plan.w + len(plan.hit) * b1 * b2 + 2 * u.shape[1])

    def _slice_device_chunk(self, plan: _SlicePlan, frame_idx) -> torch.Tensor:
        """The plan's pixels for the frames ``frame_idx``, reconstructed on
        the factors' device and un-normalized (x std + mean), frames first:
        (f, *plan.shape)."""
        u = self._blocksparse
        temporal = self._device_temporal(frame_idx)            # (R_padded, f)
        nb = u.n_block_cols
        f = temporal.shape[1]
        b1, b2 = u.block_shape
        t_blocks = temporal[:nb].reshape(u.n_blocks, u.slots, f)
        canvas = _roi_reconstruct(
            u.panels.index_select(0, plan.hit), t_blocks.index_select(0, plan.hit),
            plan.starts_rel, u.dense_basis.index_select(0, plan.ids), temporal[nb:],
            b1, b2, plan.h, plan.w,
        ).reshape(plan.h * plan.w, f)
        if plan.rel is not None:
            canvas = canvas.index_select(0, plan.rel)
        std = canvas.reshape(plan.shape + (f,))
        return torch.movedim(std * plan.std + plan.mean, -1, 0).contiguous()

    def _getitem_device(self, key) -> np.ndarray:
        """Reference slicing semantics run on the factors' device
        (pmd_array.py:464-499): only the blocks that meet the ROI are
        touched, never the CSR export; the frame axis goes in chunks whose
        buffers fit ``_slice_canvas_budget``. Each chunk is copied into its
        frames of one host tensor of the result's shape: page-locked, with
        non-blocking copies and one wait on the stream, when the factors
        are on the card and the result fits ``transient_budget_bytes``;
        pageable otherwise (``PMDArray``'s docstring)."""
        plan = self._plan(key)
        n_f = len(plan.frames)
        shape = (n_f,) + plan.shape
        if plan.empty:
            return np.zeros(shape, dtype=np.float32)
        dev = self._blocksparse.panels.device
        per_chunk = max(1, _slice_canvas_budget(dev) // self._slice_frame_bytes(plan))
        counters = self.slice_counters
        with span(counters, "slice.to_host_s", "pmd.to_host"):
            out = None
            if dev.type == "cuda" and 4 * n_f * math.prod(plan.shape) <= transient_budget_bytes(dev):
                try:
                    out = torch.empty(shape, dtype=torch.float32, pin_memory=True)
                except RuntimeError:  # page-locked memory exhausted or refused
                    pass
            pinned = out is not None
            if not pinned:
                out = torch.empty(shape, dtype=torch.float32)
            for s in range(0, n_f, per_chunk):
                out[s : s + per_chunk].copy_(
                    self._slice_device_chunk(plan, plan.frames[s : s + per_chunk]),
                    non_blocking=pinned,
                )
            if pinned:
                torch.cuda.current_stream(dev).synchronize()
        count(counters, "slice.pinned" if pinned else "slice.pageable", 1)
        count(counters, "slice.host_bytes", out.nbytes)
        return out.numpy()

    def slice_device(self, *key) -> torch.Tensor:
        """Like ``pmd[frames, rows, cols]``, but the result stays a tensor
        on the factors' device, frames first and not squeezed
        (pmd_array.py:501-528); needs the device factors (before
        ``close()``)."""
        if self._blocksparse is None:
            raise RuntimeError(
                "slice_device needs the device factors; this PMDArray was "
                "built from host factors or already closed — use __getitem__"
            )
        plan = self._plan(key)
        if plan.empty:
            return torch.zeros((len(plan.frames),) + plan.shape,
                               device=self._blocksparse.panels.device)
        return self._slice_device_chunk(plan, plan.frames)

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
        """``pmd[frames, rows, cols]``: float32 frames first, squeezed, as
        the reference returns them. With factors on the card and a result
        within the device's transient budget, the array is a view of
        page-locked host memory that it keeps alive; once it dies, torch's
        caching host allocator keeps that block for a later result.
        Otherwise it lives in pageable memory. Either way it is the
        result's only host copy and is the caller's to write."""
        if key is None:
            raise ValueError("Cannot use None for indexing")
        if not isinstance(key, tuple):
            key = (key,)
        if self._blocksparse is not None:
            # device factors live: slice on their device, no CSR export
            return self._getitem_device(key).squeeze().astype(self.dtype, copy=False)
        return self._getitem_host(key).squeeze().astype(self.dtype, copy=False)

    # -- resource management ----------------------------------------------------

    def close(self, materialize: bool = True) -> None:
        """Release the device buffers of this array (pmd_array.py:593-647):
        the block panels, mixing matrix, V, and the port's own device
        caches (R s, the C-order panels, K3's block lists, the slicing
        images).

        With ``materialize=True`` the host factors are made first, so
        slicing keeps working through the host CSR path. With
        ``materialize=False`` nothing is copied to the host: the array is
        unusable afterwards unless its host factors were made earlier.
        Sources that are numpy arrays (npz- or scipy-built arrays) hold no
        device memory and survive."""
        if self._blocksparse is not None:
            if materialize:
                self._ensure_csr()
                _ = self.r, self.v
            self._blocksparse = None
        elif materialize and self._v_host is None and self._v_src is not None:
            _ = self.v
        if materialize:
            # per-factor guards keep close() idempotent after an earlier
            # close(materialize=False), e.g. the context manager's __exit__
            if self._s_host is not None or self._s_src is not None:
                _ = self.s
            if self._mean_host is not None or self._mean_src is not None:
                _ = self.mean_img
            if self._var_host is not None or self._var_src is not None:
                _ = self.var_img
        self._rs_dev = None
        self._panels_c = None
        self._recon_plan = None
        self._csr_dev = None
        self._slice_dev = None
        self._r_padded = None

        def _survivor(src, host):
            if host is not None:
                return host
            return src if isinstance(src, np.ndarray) else None

        self._v_src = _survivor(self._v_src, self._v_host)
        self._s_src = _survivor(self._s_src, self._s_host)
        self._mean_src = _survivor(self._mean_src, self._mean_host)
        self._var_src = _survivor(self._var_src, self._var_host)

    def __enter__(self) -> "PMDArray":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- export -----------------------------------------------------------------

    def export_tiff(self, filename: str, frames=None, chunk_frames: int = RECON_CHUNK_FRAMES,
                    dtype="float32") -> None:
        """Write the denoised (reconstructed) movie as a multipage TIFF
        (pmd_array.py:657-692): ``reconstruct_frames`` (K3) chunk by chunk
        into ``io.tiff.write_tiff_stream``, so the movie is never whole in
        host memory. An integer ``dtype`` (e.g. "uint16") rounds and clips
        to its range."""
        from localmd_tpu_torch.io.tiff import write_tiff_stream

        frame_idx = np.atleast_1d(
            np.arange(self.num_frames) if frames is None else np.asarray(frames)
        )
        out_dt = np.dtype(dtype)

        def _gen():
            for s in range(0, len(frame_idx), chunk_frames):
                chunk = self.reconstruct_frames(frame_idx[s : s + chunk_frames])
                if out_dt.kind in ("u", "i"):
                    # np.rint's round-half-to-even and np.clip, on the device
                    info = np.iinfo(out_dt)
                    chunk = torch.round(chunk).clamp_(info.min, info.max)
                yield from _host(chunk).astype(out_dt)

        write_tiff_stream(filename, _gen(), (len(frame_idx), self.fov_dim1, self.fov_dim2), out_dt)

    # -- serialization ----------------------------------------------------------

    def to_npz(self, filename: str) -> None:
        from localmd_tpu_torch.serialization import save_decomposition

        save_decomposition(filename, self)

    @classmethod
    def from_npz(cls, filename: str, device="cuda") -> "PMDArray":
        """``serialization.load_decomposition``: the card unless
        ``device="cpu"`` (or None, the host path) is passed."""
        from localmd_tpu_torch.serialization import load_decomposition

        return load_decomposition(filename, device)
