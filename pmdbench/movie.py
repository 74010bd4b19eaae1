"""Synthetic imaging movies, made on the card from a seed in pieces.

A frozen copy of two recipes: the two-photon somatic movie (compact
Gaussian cells times calcium transients, plus white noise and an offset)
and the widefield movie (large diffuse sources, a smooth low-rank
background, noise and an offset). Each movie is quantised to integer
counts at ``counts_per_sigma`` counts per noise sigma, without clipping.

Every part draws from its own ``torch.Generator``, seeded from the run's
seed and the part's name (``part_seed``), and the noise of each piece of
``piece_frames`` frames from its own generator: a piece can be made again
on its own, bit for bit. Imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_PARTS = ("spatial", "traces", "bg_spatial", "bg_traces", "noise")
_TORCH_DTYPES = {"uint16": torch.uint16, "int16": torch.int16, "float32": torch.float32}


def part_seed(seed: int, part: str, index: int = 0) -> int:
    """A 63-bit seed for one part (and one piece) of a run's movie."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), _PARTS.index(part), int(index)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(seed: int, part: str, device, index: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part, index))
    return gen


def _uniform(n: int, low: float, high: float, gen: torch.Generator) -> torch.Tensor:
    return low + (high - low) * torch.rand(n, generator=gen, device=gen.device)


def gaussian_blobs(gen: torch.Generator, n: int, d1: int, d2: int, radius: float) -> torch.Tensor:
    """(d1 * d2, n) footprints, C-order pixels: centres uniform in
    [radius, d - radius), widths radius x U[0.6, 1.4)."""
    cy = _uniform(n, radius, d1 - radius, gen)
    cx = _uniform(n, radius, d2 - radius, gen)
    r = radius * _uniform(n, 0.6, 1.4, gen)
    yy = torch.arange(d1, dtype=torch.float32, device=gen.device)[:, None, None]
    xx = torch.arange(d2, dtype=torch.float32, device=gen.device)[None, :, None]
    return torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * r**2)).reshape(d1 * d2, n)


def calcium_traces(gen: torch.Generator, n: int, t: int, rate: float, tau: float) -> torch.Tensor:
    """(t, n) Bernoulli(rate) spike trains through c_k = c_{k-1} exp(-1/tau)
    + s_k, one launch per frame."""
    spikes = (torch.rand(t, n, generator=gen, device=gen.device) < rate).to(torch.float32)
    decay = math.exp(-1.0 / tau)
    traces = torch.empty_like(spikes)
    carry = torch.zeros(n, dtype=torch.float32, device=gen.device)
    for k in range(t):
        carry = torch.add(spikes[k], carry, alpha=decay, out=traces[k])
    return traces


class Movie:
    """The movie a configuration's ``movie`` entry describes, for one seed:
    ``piece(i)`` makes frames [i * piece_frames, ...) on the device as
    quantised counts."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.seed = int(seed)
        self.device = torch.device(device)
        self.shape = tuple(int(x) for x in spec["shape"])
        self.dtype = _TORCH_DTYPES[spec["dtype"]]
        self.piece_frames = int(spec["piece_frames"])
        t, d1, d2 = self.shape
        recipe = spec["recipe"]
        dev = self.device
        if recipe == "two_photon":
            self._terms = [(
                gaussian_blobs(_generator(seed, "spatial", dev), spec["n_cells"], d1, d2,
                               spec["radius"]),
                calcium_traces(_generator(seed, "traces", dev), spec["n_cells"], t,
                               spec["rate"], spec["tau"]) * spec["amplitude"],
            )]
        elif recipe == "widefield":
            radius = min(d1, d2) / spec["radius_divisor"]
            bg_radius = min(d1, d2) / spec["bg_radius_divisor"]
            self._terms = [
                (gaussian_blobs(_generator(seed, "spatial", dev), spec["n_sources"], d1, d2,
                                radius),
                 calcium_traces(_generator(seed, "traces", dev), spec["n_sources"], t,
                                spec["rate"], spec["tau"]) * spec["amplitude"]),
                (gaussian_blobs(_generator(seed, "bg_spatial", dev), spec["bg_rank"], d1, d2,
                                bg_radius),
                 calcium_traces(_generator(seed, "bg_traces", dev), spec["bg_rank"], t,
                                spec["bg_rate"], spec["bg_tau"]) * spec["bg_amplitude"]),
            ]
        else:
            raise ValueError(f"unknown movie recipe {recipe!r}")

    def footprints(self) -> torch.Tensor:
        """(d1 * d2, n) footprints of every source of the movie (cells,
        diffuse sources, background), C-order pixels."""
        return torch.cat([f for f, _ in self._terms], dim=1)

    @property
    def n_pieces(self) -> int:
        return -(-self.shape[0] // self.piece_frames)

    @property
    def nbytes(self) -> int:
        t, d1, d2 = self.shape
        return t * d1 * d2 * torch.empty((), dtype=self.dtype).element_size()

    def piece_range(self, i: int):
        a = i * self.piece_frames
        return a, min(a + self.piece_frames, self.shape[0])

    def piece(self, i: int) -> torch.Tensor:
        """Frames of piece ``i`` as (f, d1, d2) counts in the movie's dtype."""
        a, b = self.piece_range(i)
        _, d1, d2 = self.shape
        spec = self.spec
        x = torch.randn((b - a, d1 * d2), generator=_generator(self.seed, "noise", self.device, i),
                        device=self.device)
        x.mul_(spec["noise_sigma"]).add_(spec["offset"])
        for footprints, traces in self._terms:
            x.addmm_(traces[a:b], footprints.T)
        x.mul_(spec["counts_per_sigma"] / spec["noise_sigma"]).round_()
        if self.dtype != torch.float32:
            info = torch.iinfo(self.dtype)
            lo, hi = float(x.min()), float(x.max())
            if lo < info.min or hi > info.max:
                raise ValueError(f"piece {i}: counts {lo}..{hi} leave {self.dtype}'s range")
            x = x.to(self.dtype)
        return x.reshape(b - a, d1, d2)

    def frames(self, a: int, b: int) -> torch.Tensor:
        """Frames [a, b) made again from their pieces."""
        p0, p1 = a // self.piece_frames, (b - 1) // self.piece_frames
        parts = [self.piece(i) for i in range(p0, p1 + 1)]
        whole = torch.cat(parts) if len(parts) > 1 else parts[0]
        off = p0 * self.piece_frames
        return whole[a - off : b - off]

    def to_card(self) -> torch.Tensor:
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for i in range(self.n_pieces):
            a, b = self.piece_range(i)
            out[a:b] = self.piece(i)
        return out

    def to_host(self) -> np.ndarray:
        """The whole movie in pageable host memory, piece by piece through
        two pinned staging buffers (a copy from the card into pageable
        memory runs at a fraction of the link's rate)."""
        out = np.empty(self.shape, dtype=self.spec["dtype"])
        view = torch.from_numpy(out)
        if self.device.type != "cuda":
            for i in range(self.n_pieces):
                a, b = self.piece_range(i)
                view[a:b].copy_(self.piece(i))
            return out
        _, d1, d2 = self.shape
        stages = [torch.empty((self.piece_frames, d1, d2), dtype=self.dtype, pin_memory=True)
                  for _ in range(2)]
        done = [None, None]
        for i in range(self.n_pieces + 1):
            if i < self.n_pieces:
                a, b = self.piece_range(i)
                stages[i % 2][: b - a].copy_(self.piece(i), non_blocking=True)
                done[i % 2] = torch.cuda.Event()
                done[i % 2].record()
            if i:
                a, b = self.piece_range(i - 1)
                done[(i - 1) % 2].synchronize()
                view[a:b].copy_(stages[(i - 1) % 2][: b - a])
        return out
