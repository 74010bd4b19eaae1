"""The single seam every Gaussian draw of the port goes through.

torch cannot reproduce JAX's threefry streams, so tests inject the same
draws into both packages. This is the counterpart of
``localmd_tpu.ops.linalg.sketch_override`` (ops/linalg.py:40-61): inside
``sketch_override(fn)``, ``normal(shape, ...)`` returns ``fn(shape)``
(broadcast over ``batch``) instead of drawing from the generator.

Draws that go through here: the rSVD sketches (ops/linalg.py:338-343,
381-388), the background rSVD (loader.py:955), the threshold Monte-Carlo
noise and sketch (engine.py:920-926), the ``rank_prune`` matrix
(pipeline.py:1288) and the ``subspace_eigh`` sketch (ops/linalg.py:245).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

_OVERRIDE: Optional[Callable] = None


@contextlib.contextmanager
def sketch_override(fn: Callable):
    """Replace every draw of ``normal`` with ``fn(shape)`` (array-like)."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = fn
    try:
        yield
    finally:
        _OVERRIDE = prev


def random_draws_are_live() -> bool:
    """False inside ``sketch_override``: ``normal`` returns the override's
    arrays there, so a result is not a function of the generator's seed."""
    return _OVERRIDE is None


def normal(
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator],
    device,
    batch: Tuple[int, ...] = (),
) -> torch.Tensor:
    """(*batch, *shape) float32 standard normals on ``device``.

    Without an override, each batch item gets its own draw. Under
    ``sketch_override(fn)`` the result is ``fn(shape)`` broadcast over
    ``batch`` -- the JAX package's override semantics for the batched rSVD.
    """
    shape = tuple(int(s) for s in shape)
    batch = tuple(int(b) for b in batch)
    if _OVERRIDE is not None:
        draw = torch.tensor(
            np.array(_OVERRIDE(shape), dtype=np.float32), device=device
        )
        return draw.expand(batch + shape)
    return torch.randn(
        batch + shape, generator=generator, device=device, dtype=torch.float32
    )


def make_generator(seed: Optional[int], device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the counterpart of the JAX key
    tree, pipeline.py:307, 667-669); an unseeded run draws its seed from
    numpy's global RNG as the JAX package does (utils/keys.py:20-27)."""
    if seed is None:
        seed = int(np.random.randint(0, np.iinfo(np.int32).max))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def stage_seeds(seed: Optional[int], names: Tuple[str, ...]) -> dict:
    """One generator seed per pipeline stage, drawn from ``seed`` (or from
    numpy's global RNG when it is None): like the JAX package's key splits
    (pipeline.py:552, 667, 1130), each stage's draws stay the same whether
    or not an earlier stage ran or was loaded from a checkpoint."""
    if seed is None:
        seed = int(np.random.randint(0, np.iinfo(np.int32).max))
    states = np.random.SeedSequence(int(seed)).generate_state(len(names))
    return {name: int(s) for name, s in zip(names, states)}
