"""Multi-plane (volumetric) PMD: each z-plane decomposed on its own
(counterpart of localmd_tpu/volumetric.py:24-193).

``volumetric_decomposition`` runs the planes one after another on one
device, or, with ``devices=``, concurrently: one host thread per device,
each thread's planes pinned to its device. Returns a
:class:`VolumetricPMD`, a (T, Z, d1, d2) array-like view.
"""

from __future__ import annotations

import concurrent.futures
from typing import List

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.dataset import ZStackArray, as_dataset
from localmd_tpu_torch.parallel.multihost import validate_multihost_mesh
from localmd_tpu_torch.pipeline import localmd_decomposition
from localmd_tpu_torch.pmd_array import PMDArray
from localmd_tpu_torch.utils import display


class VolumetricPMD:
    """Array-like view over per-plane PMD decompositions: (T, Z, d1, d2)."""

    def __init__(self, planes: List[PMDArray]):
        if not planes:
            raise ValueError("need at least one plane")
        self.planes = planes
        s0 = planes[0].shape
        for p in planes[1:]:
            if p.shape != s0:
                raise ValueError("planes must share shape")

    @property
    def n_planes(self) -> int:
        return len(self.planes)

    @property
    def shape(self):
        t, d1, d2 = self.planes[0].shape
        return (t, self.n_planes, d1, d2)

    @property
    def ndim(self) -> int:
        return 4

    @property
    def dtype(self):
        return np.float32

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        t_key = key[0] if len(key) > 0 else slice(None)
        z_key = key[1] if len(key) > 1 else slice(None)
        rest = key[2:]
        z_indices = np.atleast_1d(np.arange(self.n_planes)[z_key])
        per_plane = []
        for z in z_indices:
            sub_key = ((t_key,) + rest)[:3]
            plane = self.planes[int(z)]
            # planes with live device factors slice on their device
            if plane._blocksparse is not None:
                per_plane.append(plane._getitem_device(sub_key))
            else:
                per_plane.append(plane._getitem_host(sub_key))
        out = np.stack(per_plane, axis=1)  # (t, z, ...)
        return out.squeeze().astype(np.float32)

    def save(self, filename_prefix: str) -> List[str]:
        paths = []
        for z, plane in enumerate(self.planes):
            path = f"{filename_prefix}_plane{z}.npz"
            plane.to_npz(path)
            paths.append(path)
        return paths

    def close(self, materialize: bool = True) -> None:
        """Release every plane's device buffers (``PMDArray.close``)."""
        for plane in self.planes:
            plane.close(materialize=materialize)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def volumetric_decomposition(
    stack,
    block_sizes,
    frame_range: int,
    devices=None,
    device="cuda",
    **kwargs,
) -> VolumetricPMD:
    """Run PMD per plane of a volumetric stack.

    - ``devices=`` (a list of torch devices): planes go round-robin onto
      the devices and run concurrently, one host thread per device, each
      thread's planes pinned to its device; a seeded run equals the
      sequential one (each plane draws from its own RandomState).
    - otherwise every plane runs on ``device`` (the card unless
      ``device="cpu"``; raises without CUDA).

    With ``checkpoint_path=``, plane z checkpoints at
    ``{checkpoint_path}_plane{z}``. With ``mesh=`` (``parallel.make_mesh``)
    the planes run one at a time, each split over the mesh's ranks
    (volumetric.py:113-123); ``devices=`` with it raises.

    Args:
        stack: ZStackArray, or a sequence of per-plane (T, d1, d2) movies.
        Remaining args as :func:`localmd_tpu_torch.localmd_decomposition`.
    """
    validate_multihost_mesh(kwargs.get("mesh"))
    if devices and kwargs.get("mesh") is not None:
        raise ValueError(
            "devices= (plane-parallel) and mesh= (block-sharded) are mutually "
            "exclusive; pick one scale-out axis"
        )
    if isinstance(stack, ZStackArray):
        planes = stack.planes
    elif isinstance(stack, (list, tuple)):
        planes = [as_dataset(p) for p in stack]
    else:
        raise TypeError("stack must be a ZStackArray or a sequence of planes")
    devs = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
    base_ckpt = kwargs.pop("checkpoint_path", None)

    def plane_kwargs(z):
        kw = dict(kwargs)
        if base_ckpt is not None:
            kw["checkpoint_path"] = f"{base_ckpt}_plane{z}"
        return kw

    results: list = [None] * len(planes)

    def run_device(k):
        # one thread per device, its planes k, k + D, ... in turn: at most
        # one pipeline (movie cache and working set) on a device at a time
        dev = devs[k]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        for z in range(k, len(planes), len(devs)):
            display(f"Decomposing plane {z + 1}/{len(planes)} on {dev}")
            results[z] = localmd_decomposition(
                planes[z], block_sizes, frame_range, device=dev, **plane_kwargs(z)
            )

    if len(devs) == 1:
        run_device(0)
    else:
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(devs)) as pool:
            for future in [pool.submit(run_device, k) for k in range(len(devs))]:
                future.result()
    return VolumetricPMD(results)
