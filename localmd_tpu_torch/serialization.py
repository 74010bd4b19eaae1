"""Save/load the factorization in the reference .npz convention (counterpart
of localmd_tpu/serialization.py); reads files the JAX package wrote::

    fov_shape, fov_order, U_data, U_indices, U_indptr, U_shape, U_format,
    R, s, Vt, mean_img, noise_var_img
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.pmd_array import PMDArray


def save_decomposition(filename: str, movie: PMDArray) -> None:
    u = movie.u.tocsr()
    np.savez_compressed(
        filename,
        fov_shape=np.asarray([movie.fov_dim1, movie.fov_dim2]),
        fov_order=movie.order,
        U_data=u.data,
        U_indices=u.indices,
        U_indptr=u.indptr,
        U_shape=np.asarray(u.shape),
        U_format="csr",
        R=movie.r,
        s=movie.s,
        Vt=movie.v,
        mean_img=movie.mean_img,
        noise_var_img=movie.var_img,
    )


def load_decomposition(filename: str, device="cuda") -> PMDArray:
    """The factors of a .npz as a PMDArray whose ``reconstruct_frames`` runs
    on ``device`` (a sparse CSR product there): the card unless
    ``device="cpu"`` is passed; raises without CUDA. ``device=None`` keeps
    the numpy host path. Slicing always runs on the host."""
    if device is not None:
        device = resolve_device(device)
    data = np.load(filename, allow_pickle=True)
    fmt = str(np.asarray(data["U_format"]))
    if fmt.lower() != "csr":
        raise ValueError(f"Unsupported sparse format: {fmt}")
    u = scipy.sparse.csr_matrix(
        (data["U_data"], data["U_indices"], data["U_indptr"]),
        shape=tuple(data["U_shape"]),
    )
    v = data["Vt"]
    fov_shape = tuple(int(x) for x in data["fov_shape"])
    return PMDArray(
        u,
        data["R"],
        data["s"],
        v,
        (v.shape[1], fov_shape[0], fov_shape[1]),
        str(np.asarray(data["fov_order"])),
        data["mean_img"],
        data["noise_var_img"],
        device=device,
    )
