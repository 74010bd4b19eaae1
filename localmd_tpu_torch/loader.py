"""Movie loader: statistics, background basis, standardized init frames and
the streamed V regression (counterpart of localmd_tpu/loader.py for
in-memory sources).

- The statistics pass walks plain 1024-frame ranges and runs K1
  (``ops.kernels.movie_stats``) on each raw chunk in its native dtype; a
  tail shorter than ``MIN_NOISE_FRAMES`` adds to the mean only
  (loader.py:814-940, comment at 845-856).
- The V regression folds the mixing matrix and the per-pixel
  standardization into one dense projector, A~ = (U P)/std and c = A~^T mean,
  so each raw chunk is one K2 call (``ops.kernels.v_projection``;
  loader.py:1131-1158).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from localmd_tpu_torch.dataset import as_dataset
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops.linalg import truncated_random_svd
from localmd_tpu_torch.ops.noise import NPERSEG
from localmd_tpu_torch.ops.tiling import flatten_fov, flatten_image, unflatten_fov
from localmd_tpu_torch.utils import display, make_generator

MIN_NOISE_FRAMES = 256   # reference min_allowed_frames
STATS_CHUNK_FRAMES = 1024
STREAM_CHUNK_BYTES = 1 << 30  # f32 bytes of one streamed V-regression chunk


def _chunk_ranges(total: int, chunk: int, merge_tail: bool = True) -> List[Tuple[int, int]]:
    """[start, end) ranges (loader.py:60-76). With ``merge_tail`` the final
    partial chunk joins the previous one; without it the short tail stays."""
    n_chunks = math.ceil(total / chunk)
    if n_chunks <= 1:
        return [(0, total)]
    if not merge_tail:
        return [(i * chunk, min((i + 1) * chunk, total)) for i in range(n_chunks)]
    ranges = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks - 2)]
    ranges.append(((n_chunks - 2) * chunk, total))
    return ranges


def _rows_to_c(x: torch.Tensor, d1: int, d2: int, order: str) -> torch.Tensor:
    """Reorder the pixel rows of (d1*d2, k) from ``order`` to C order."""
    return unflatten_fov(x, d1, d2, order).reshape(d1 * d2, -1)


def _rows_from_c(x: torch.Tensor, d1: int, d2: int, order: str) -> torch.Tensor:
    """Reorder the pixel rows of (d1*d2, k) from C order to ``order``."""
    return flatten_fov(x.reshape(d1, d2, -1), order)


def standardize_and_filter(
    raw: torch.Tensor,
    mean_img: torch.Tensor,
    std_img: torch.Tensor,
    spatial_basis_flat: torch.Tensor,
    order: str = "F",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardize a raw (t, d1, d2) chunk and project out the background
    basis (loader.py:262-340). Returns the filtered chunk as a contiguous
    (d1, d2, t) f32 tensor and the background temporal projection (K, t).

    Works frames-major on C-order pixels, the raw chunk's own layout, with
    the (small) basis rows reordered instead: per pixel and frame the
    arithmetic is the JAX package's, and the only movie-sized transpose is
    the final one into the (d1, d2, t) layout the block stage gathers from."""
    t, d1, d2 = raw.shape
    x = raw.reshape(t, d1 * d2).to(torch.float32)
    x = (x - mean_img.reshape(-1)) / std_img.reshape(-1)
    basis_c = _rows_to_c(spatial_basis_flat, d1, d2, order)
    temporal_projection = (x @ basis_c).T                         # (K, t)
    x = x - temporal_projection.T @ basis_c.T
    return x.T.reshape(d1, d2, t).contiguous(), temporal_projection


def _fold_projector(a: torch.Tensor, std_flat: torch.Tensor, mean_flat: torch.Tensor):
    """(U P) -> (A~ = UP/std, c = A~^T mean) (loader.py:357). Divides ``a``
    in place: the (d, r') canvas is the largest buffer of the stage."""
    a_tilde = a.div_(std_flat[:, None])
    c = (a_tilde.T @ mean_flat[:, None])[:, 0]
    return a_tilde, c


class PMDLoader:
    """Owns dataset access, per-pixel statistics and the background basis."""

    def __init__(
        self,
        dataset,
        device,
        background_rank: int = 15,
        batch_size: int = 2000,
        order: str = "F",
        compute_normalizer: bool = True,
        frame_constant: int = STATS_CHUNK_FRAMES,
        seed: Optional[int] = None,
        welch_compat: str = "scipy",
        np_rng=None,
    ):
        if welch_compat not in ("scipy", "reference"):
            raise ValueError(
                f"welch_compat must be 'scipy' or 'reference', got {welch_compat!r}"
            )
        self.dataset = as_dataset(dataset)
        self.device = torch.device(device)
        self.shape = tuple(int(s) for s in self.dataset.shape)
        self.batch_size = batch_size
        self.order = order
        self.background_rank = background_rank
        self.frame_constant = frame_constant
        self.welch_compat = welch_compat
        self._compute_normalizer = compute_normalizer
        self._np_rng = np_rng if np_rng is not None else np.random
        self._generator = make_generator(seed, self.device)
        self._initialize_normalizers()
        self._initialize_background()

    @property
    def n_pixels(self) -> int:
        return self.shape[1] * self.shape[2]

    # -- raw access -----------------------------------------------------------

    def _load_raw(self, frames) -> torch.Tensor:
        """(t, d1, d2) native-dtype frames on the device: a slice for a
        contiguous range, else a gather of the sorted frame list."""
        if isinstance(frames, slice):
            return self.dataset.frames(frames, self.device)
        frames = list(frames)
        if frames == list(range(frames[0], frames[0] + len(frames))):
            return self.dataset.frames(slice(frames[0], frames[0] + len(frames)), self.device)
        return self.dataset.gather(frames, self.device)

    def _stream_chunk_frames(self) -> int:
        return max(64, min(self.batch_size, STREAM_CHUNK_BYTES // (self.n_pixels * 4)))

    # -- statistics -----------------------------------------------------------

    def _initialize_normalizers(self) -> None:
        display("Computing video statistics (mean + noise sigma)")
        t_total, d1, d2 = self.shape
        normalizer_flag = self._compute_normalizer and t_total >= MIN_NOISE_FRAMES
        ref_compat = self.welch_compat == "reference"
        mean_acc = torch.zeros((d1, d2), dtype=torch.float32, device=self.device)
        noise_acc = torch.zeros((d1, d2), dtype=torch.float32, device=self.device)
        noise_chunks = 0
        # Unmerged ranges: a tail shorter than MIN_NOISE_FRAMES adds to the
        # mean only, as the reference stats loop does.
        for a, b in _chunk_ranges(t_total, self.frame_constant, merge_tail=False):
            raw = self._load_raw(slice(a, b))
            t_c = b - a
            with_noise = normalizer_flag and t_c >= MIN_NOISE_FRAMES
            m, sig = kernels.movie_stats(
                raw.reshape(t_c, d1 * d2), t_total,
                compute_noise=with_noise, nperseg=t_c if ref_compat else NPERSEG,
            )
            if with_noise:
                noise_acc = noise_acc + sig.reshape(d1, d2)
                noise_chunks += 1
            mean_acc = mean_acc + m.reshape(d1, d2)
        self.mean_img = mean_acc
        if normalizer_flag and noise_chunks > 0:
            std = noise_acc / np.float32(noise_chunks)
            std = torch.where(std == 0, torch.ones_like(std), std)
        else:
            std = torch.ones((d1, d2), dtype=torch.float32, device=self.device)
        self.std_img = std
        display("Finished mean and noise estimation")

    # -- background -----------------------------------------------------------

    def _initialize_background(self, n_samples: int = 1000) -> None:
        """Rank-``background_rank`` rSVD of <= 1000 random standardized
        frames (loader.py:944-975); basis rows follow ``order``."""
        if self.background_rank <= 0:
            self.spatial_basis = torch.zeros(
                (self.n_pixels, 1), dtype=torch.float32, device=self.device
            )
            return
        display("Computing low-rank background basis")
        t_total = self.shape[0]
        n = min(n_samples, t_total)
        frames = np.sort(self._np_rng.choice(t_total, size=n, replace=False)).tolist()
        d1, d2 = self.shape[1], self.shape[2]
        # frames-major, C-order pixels (the raw layout): the rSVD of the
        # (d, n) matrix is row-permutation equivariant, so only the (d, K)
        # basis is reordered to ``order`` -- no movie-sized transpose
        x = self._load_raw(frames).reshape(n, d1 * d2).to(torch.float32)
        x = (x - self.mean_img.reshape(-1)) / self.std_img.reshape(-1)
        u, _, _ = truncated_random_svd(x.T, self.background_rank, generator=self._generator)
        self.spatial_basis = _rows_from_c(u, d1, d2, self.order)

    # -- standardized init frames ---------------------------------------------

    def temporal_crop_with_filter(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standardized, background-filtered init frames (d1, d2, T) and the
        background temporal basis (K, T), on the device."""
        return standardize_and_filter(
            self._load_raw(frames), self.mean_img, self.std_img, self.spatial_basis, self.order
        )

    # -- streamed temporal regression -----------------------------------------

    def v_projection(self, u, p: torch.Tensor) -> torch.Tensor:
        """V = P^T U^T standardize(movie), the second full pass: (r', T)."""
        d1, d2 = self.shape[1], self.shape[2]
        std_flat = flatten_image(self.std_img, self.order)
        mean_flat = flatten_image(self.mean_img, self.order)
        a = u.matmul(p)                                            # (d, r')
        a_tilde, c = _fold_projector(a, std_flat, mean_flat)
        # projector rows follow the pipeline's pixel order; the raw chunk
        # flattens in C order, so reorder the rows once (loader.py:1142)
        a_c = _rows_to_c(a_tilde, d1, d2, self.order).contiguous()
        del a, a_tilde
        # K2's layout of the projector, made once for every chunk
        prepared = kernels.prepare_projector(a_c) if a_c.is_cuda else None
        results = []
        for s, e in _chunk_ranges(self.shape[0], self._stream_chunk_frames()):
            raw = self._load_raw(slice(s, e))
            results.append(kernels.v_projection(raw.reshape(e - s, d1 * d2), a_c, c, prepared))
        return torch.cat(results, dim=1) if len(results) > 1 else results[0]
