"""The port's benchmark movie (bench_torch.make_movie) follows
bench.make_movie's construction: rank-16 unit-variance factors plus N(0, 1)
noise, uint16 as clip(40 x + 1000) truncated. Checked on the CPU at a small
size through its statistics; tolerances are a few standard errors."""

import numpy as np
import pytest
import torch

from bench_torch import make_movie


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("smooth", [False, True])
def test_make_movie_matches_bench_construction(dtype, smooth):
    t, d1, d2 = 1024, 24, 20
    movie, clean_fn = make_movie(dtype, d1, d2, t, smooth=smooth, device="cpu")
    assert movie.shape == (t, d1, d2) and movie.dtype == getattr(torch, dtype)
    clean = clean_fn(torch.arange(t)).double()
    scale, offset = (1.0, 0.0) if dtype == "float32" else (40.0, 1000.0)
    signal = (clean - offset) / scale
    noise = (movie.double() - clean) / scale
    # rank 16 of unit-variance factors: per-pixel signal variance ~16
    assert abs(float(signal.var()) / 16.0 - 1.0) < 0.25
    if dtype == "float32":
        assert abs(float(noise.std()) - 1.0) < 0.02
    else:
        # truncation toward zero: noise in movie units is N(0, 1) * 40 - U(0, 1)
        assert abs(float(noise.std()) * 40 - np.sqrt(40**2 + 1 / 12)) < 0.8
    # smoothed factors: neighbouring frames of the signal are correlated
    lag1 = float((signal[1:] * signal[:-1]).mean() / (signal * signal).mean())
    assert (lag1 > 0.8) if smooth else (abs(lag1) < 0.1)
    # the same seed makes the same movie
    again, _ = make_movie(dtype, d1, d2, t, smooth=smooth, device="cpu")
    assert torch.equal(movie, again)
