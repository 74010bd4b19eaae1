"""Generator helpers under the JAX package's key names (counterpart of
localmd_tpu/utils/keys.py). Where the JAX package hands out a PRNG key, the
port hands out a seeded ``torch.Generator``; the pipeline itself seeds one
generator per stage (``utils.random.stage_seeds``)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.utils.random import make_generator


def make_key_with_seed(seed: Optional[int] = None, device="cuda") -> Tuple[torch.Generator, int]:
    """(generator, seed): a generator on ``device`` (the card unless
    ``device="cpu"``; raises without CUDA) and the integer it was seeded
    with. An unseeded call draws the seed from numpy's global RNG, as the
    reference draws its keys (utils/keys.py:19-26)."""
    if seed is None:
        ii32 = np.iinfo(np.int32)
        seed = int(np.random.randint(low=ii32.min, high=ii32.max, dtype=np.int32))
    return make_generator(seed, resolve_device(device)), seed


def make_key(seed: Optional[int] = None, device="cuda") -> torch.Generator:
    """A seeded generator; ``seed`` None draws the seed from numpy's RNG."""
    return make_key_with_seed(seed, device)[0]


def split_keys(generator: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` generators on ``generator``'s device, seeded from its draws."""
    seeds = torch.randint(0, np.iinfo(np.int32).max, (n,), generator=generator,
                          device=generator.device).tolist()
    return [make_generator(s, generator.device) for s in seeds]


# the reference's name (reference decomposition.py:134-144, pmd_loader.py:33)
make_jax_random_key = make_key
