"""Factorized SVD reformat: U·V -> [U R] s Vt without densifying U
(counterpart of localmd_tpu/factorization.py).

The (m, m) quadratic form ``right.T (U.T U) right`` comes from blocked panel
products (``BlockSparseMatrix.gram_quadratic``: the banded form on a regular
grid with ``blocksparse.BANDED_GRAM`` on, else Z^T Z); zero-padded slot columns of
U give exact-zero eigenvalues that a relative cut drops. With a mesh the
quadratic form splits the block panels over its ranks
(``parallel.sharded_gram_quadratic``). A scipy sparse U is accepted too, as
in the JAX package: its products run in scipy on the host.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import scipy.sparse
import torch

from localmd_tpu_torch.blocksparse import BlockSparseMatrix
from localmd_tpu_torch.ops.linalg import eigh_descending, projected_svd, subspace_eigh
from localmd_tpu_torch.parallel.mesh import pad_to_multiple
from localmd_tpu_torch.parallel.sharded import sharded_gram_quadratic

DEFAULT_COL_CHUNK = 1024


class _ScipySparseAdapter:
    """The two products the SVD needs over a scipy sparse U
    (factorization.py:34-49), computed in scipy on the host and returned on
    the device and in the dtype of their argument."""

    def __init__(self, u):
        self._u = u.tocsr()
        self.shape = u.shape

    def gram_matmul(self, x: torch.Tensor, col_chunk=None) -> torch.Tensor:
        host = self._u.T.dot(self._u.dot(x.detach().cpu().numpy()))
        return torch.as_tensor(np.asarray(host), dtype=x.dtype, device=x.device)

    def gram_quadratic(self, right: torch.Tensor, col_chunk=None) -> torch.Tensor:
        g = right.T @ self.gram_matmul(right)
        return 0.5 * (g + g.T)


def _as_product_operator(u):
    if isinstance(u, BlockSparseMatrix):
        return u
    if scipy.sparse.issparse(u):
        return _ScipySparseAdapter(u)
    raise TypeError(f"Unsupported spatial matrix type: {type(u)}")


def _gram_quadratic_mesh(u: BlockSparseMatrix, right: torch.Tensor, mesh,
                         col_chunk: int = DEFAULT_COL_CHUNK) -> torch.Tensor:
    """right^T (U^T U) right with the block panels split over ``mesh``
    (factorization.py:59-93): the block axis, and the matching rows of
    ``right``, padded with zeros to a multiple of the mesh size (zero panels
    add nothing, so no coset takes them)."""
    world = mesh.size()
    n = u.n_blocks
    pad = pad_to_multiple(n, world) - n
    panels, rows = u.panels, u.rows
    if pad:
        panels = torch.cat([panels, panels.new_zeros((pad,) + tuple(panels.shape[1:]))])
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
        nb = u.n_block_cols
        right = torch.cat([right[:nb], right.new_zeros((pad * u.slots, right.shape[1])), right[nb:]])
    return sharded_gram_quadratic(mesh, panels, rows, u.dense_basis, right, u.n_pixels,
                                  col_chunk=col_chunk, cosets=tuple(u.cosets),
                                  coset_info=u.coset_info, block_shape=u.block_shape)


def gram_is_banded(u, v: torch.Tensor, mesh=None) -> bool:
    """Whether ``compute_lowrank_factorized_svd(u, v, mesh=mesh)`` forms its
    Gram quadratic form in the banded form (else Z^T Z, column-chunked or
    split over the mesh)."""
    m = min(u.shape[1], v.shape[1])  # the columns of its ``right``
    return mesh is None and isinstance(u, BlockSparseMatrix) and u.banded_gram_ready(m)


def eigh_plan(m: int, k: int) -> Tuple[str, int]:
    """("subspace", k_sketch) or ("full", k_sketch) for an (m, m) Gram of
    rank <= k (factorization.py:96-112)."""
    k_sketch = min(m, k + 32)
    if 4 * k_sketch <= 3 * m and m >= 512:
        return "subspace", k_sketch
    return "full", k_sketch


def compute_lowrank_factorized_svd(
    u: Union[BlockSparseMatrix, "scipy.sparse.spmatrix"],
    v: torch.Tensor,
    only_left: bool = False,
    col_chunk: int = DEFAULT_COL_CHUNK,
    mesh=None,
    expected_rank: int = None,
):
    """SVD of the low-rank product ``u @ v`` (factorization.py:115-200).

    Returns P ((R, r'), U @ P orthonormal) if ``only_left`` else (P', s, Vt)
    with (U P') s Vt = U V. With ``expected_rank`` the top ``expected_rank``
    directions are kept and rank-deficient ones zeroed on the device;
    without it the positive-eigenvalue cut runs on the host. With ``mesh``
    the Gram quadratic form is split over its ranks and every rank gets it
    whole; a scipy ``u`` takes the unsharded path (factorization.py:156)."""
    u = _as_product_operator(u)
    r_cols = u.shape[1]
    t = v.shape[1]
    # work in V's row space when U has more columns than V has frames
    right = v if r_cols > t else torch.eye(r_cols, dtype=v.dtype, device=v.device)
    if mesh is not None and isinstance(u, BlockSparseMatrix):
        quad = _gram_quadratic_mesh(u, right, mesh, col_chunk=col_chunk)
    else:
        quad = u.gram_quadratic(right, col_chunk=col_chunk)
    m = quad.shape[0]

    if expected_rank is not None:
        k = min(int(expected_rank), m)
        solver, k_sketch = eigh_plan(m, k)
        if solver == "subspace":
            eig_vals, eig_vecs = subspace_eigh(quad, k_sketch)
        else:
            eig_vals, eig_vecs = eigh_descending(quad)
        vals_k = eig_vals[:k]
        tol = torch.clamp(eig_vals[0], min=0.0) * 1e-6
        inv_sing = torch.where(
            vals_k > tol,
            1.0 / torch.sqrt(torch.clamp(vals_k, min=1e-30)),
            torch.zeros_like(vals_k),
        )
        p = right @ (eig_vecs[:, :k] * inv_sing[None, :])
    else:
        eig_vals, eig_vecs = eigh_descending(quad)
        vals_np = eig_vals.cpu().numpy()
        tol = max(float(vals_np[0]), 0.0) * 1e-6
        good = vals_np > tol
        idx = torch.as_tensor(np.nonzero(good)[0], device=quad.device)
        sing = torch.sqrt(torch.as_tensor(vals_np[good], device=quad.device))
        p = (right @ eig_vecs.index_select(1, idx)) / sing[None, :]
    if only_left:
        return p
    new_temporal = p.T @ u.gram_matmul(v, col_chunk=col_chunk)
    return projected_svd(p, new_temporal)


def final_svd_reformat(p: torch.Tensor, v: torch.Tensor, rel_tol: float = 1e-3):
    """(R, s_host, Vt, keep) from the mixing matrix and the regressed
    temporal matrix (factorization.py:203-233). R and Vt keep full width;
    pruned singular values are zeroed in the host ``s`` and ``keep`` is the
    boolean mask of kept columns."""
    r, s, vt = projected_svd(p, v)
    s_host = s.cpu().numpy()
    cutoff = rel_tol * s_host[0] if (len(s_host) and rel_tol > 0) else 0.0
    good = s_host > cutoff if cutoff > 0 else s_host != 0
    if not bool(good.all()):
        s_host = np.where(good, s_host, 0.0).astype(s_host.dtype)
    return r, s_host, vt, good


def aggregate_local_and_global_decomposition(u, v, spatial_basis, temporal_basis):
    """Append the global background basis to a scipy local factorization:
    extra columns of U, extra rows of V (factorization.py:236-249)."""
    spatial_bg_sparse = scipy.sparse.coo_matrix(np.asarray(spatial_basis))
    u_net = scipy.sparse.hstack([u, spatial_bg_sparse])
    v_net = np.concatenate([np.asarray(v), np.asarray(temporal_basis)], axis=0)
    return u_net, v_net
