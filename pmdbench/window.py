"""Arithmetic of the measured window: rates over all of it, tails over all
requests, and a sample of answers drawn from the seed."""

from __future__ import annotations

import statistics

import numpy as np


def rate(amount: float, seconds: float) -> float:
    """``amount`` over the window's whole length."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return amount / seconds


def percentile(values, q: int) -> float:
    """The ``q``-th percentile of every value (``statistics.quantiles``,
    inclusive method)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[q - 1])


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from a
    seed, in constant memory."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self._rng = np.random.default_rng(int(seed))
        self._seen = 0

    def offer(self, item) -> None:
        self._seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self._rng.integers(0, self._seen))
        if j < self.k:
            self.items[j] = item
