"""Compression and reconstruction quality metrics (counterpart of
localmd_tpu/metrics.py:32-110): the compression ratio, the streamed relative
reconstruction error and the residual-to-noise ratio, the numbers users
report beside the seconds.

The movie streams in chunks: each is read once from ``as_dataset``'s
source, moved to ``device`` and cast to float32 there; the frames come from
``pmd.reconstruct_frames`` (K3 over the block panels of a pipeline result,
a sparse CSR product for a loaded .npz). Each chunk's sums are taken on the
device and accumulated in Python floats, as the JAX package's
``float(jnp.sum(...))`` does. The functions run on the card unless
``device="cpu"`` is passed, and raise without CUDA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.dataset import as_dataset, read_frames_f32
from localmd_tpu_torch.pmd_array import PMDArray


def compression_ratio(pmd: PMDArray) -> float:
    """Raw float32 movie bytes / stored factorization bytes."""
    t, d1, d2 = pmd.shape
    u = pmd.u
    stored = (
        u.data.size + u.indices.size + u.indptr.size
        + pmd.r.size + pmd.s.size + pmd.v.size
        + pmd.mean_img.size + pmd.var_img.size
    )
    return float(t * d1 * d2) / float(stored)


def _squared_errors(pmd: PMDArray, dataset, frames, chunk_frames: int, dev, centered: bool):
    """Stream the movie and the reconstruction over ``frames``: the sums of
    (rec - raw)^2, raw^2 and, with ``centered``, (raw - mean)^2."""
    err_sq = raw_sq = rawc_sq = 0.0
    mean = torch.as_tensor(np.asarray(pmd.mean_img, dtype=np.float32), device=dev) if centered else None
    for s in range(0, len(frames), chunk_frames):
        sub = frames[s : s + chunk_frames]
        raw = read_frames_f32(dataset, sub, dev)
        rec = pmd.reconstruct_frames(sub).to(device=dev, dtype=torch.float32)
        err_sq += float(torch.sum((rec - raw) ** 2))
        if centered:
            raw_sq += float(torch.sum(raw**2))
            rawc_sq += float(torch.sum((raw - mean[None]) ** 2))
    return err_sq, raw_sq, rawc_sq


def reconstruction_error(
    pmd: PMDArray,
    dataset,
    frames: Optional[range] = None,
    chunk_frames: int = 512,
    device="cuda",
) -> dict:
    """Streamed relative Frobenius error of the reconstruction against the
    raw movie over ``frames`` (default: all); the movie is never whole on
    the device.

    Returns {"rel_error", "rel_error_centered", "frames"}: ``rel_error``
    divides by ||Y||, ``rel_error_centered`` by ||Y - mean|| (the scale that
    means something when the movie has a large offset)."""
    dev = resolve_device(device)
    dataset = as_dataset(dataset)
    frames = list(range(dataset.shape[0]) if frames is None else frames)
    err_sq, raw_sq, rawc_sq = _squared_errors(pmd, dataset, frames, chunk_frames, dev, True)
    return {
        "rel_error": float(np.sqrt(err_sq / max(raw_sq, 1e-30))),
        "rel_error_centered": float(np.sqrt(err_sq / max(rawc_sq, 1e-30))),
        "frames": len(frames),
    }


def residual_noise_ratio(
    pmd: PMDArray,
    dataset,
    frames: Optional[range] = None,
    chunk_frames: int = 512,
    device="cuda",
) -> float:
    """||Y - Y_hat||^2 / (sum sigma_i^2 * T): near 1.0 when the residual is
    the estimated noise (the PMD ideal), >> 1 when signal was missed, << 1
    when noise went into the factorization. The noise power is summed in
    float64."""
    dev = resolve_device(device)
    dataset = as_dataset(dataset)
    frames = list(range(dataset.shape[0]) if frames is None else frames)
    err_sq, _, _ = _squared_errors(pmd, dataset, frames, chunk_frames, dev, False)
    noise_power = float(np.sum(np.asarray(pmd.var_img).astype(np.float64) ** 2)) * len(frames)
    return err_sq / max(noise_power, 1e-30)
