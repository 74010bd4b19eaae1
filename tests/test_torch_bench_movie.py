"""The port's benchmark movie (bench_torch.make_movie) follows
bench.make_movie's construction: rank-16 unit-variance factors plus N(0, 1)
noise, uint16 as clip(40 x + 1000) truncated; the other integer dtypes as
``bench_torch.MOVIE_RANGES`` gives them (int16 clip(40 x - 100), with
negative samples; uint8 clip(8 x + 128); int8 clip(8 x)), float16 and
bfloat16 as x, like float32. Checked on the CPU at a small size through its
statistics; tolerances are a few standard errors."""

import numpy as np
import pytest
import torch

from bench_torch import MOVIE_RANGES, make_movie


@pytest.mark.parametrize("dtype", ["float32", "uint16", "int16", "uint8", "int8", "float16",
                                   "bfloat16"])
@pytest.mark.parametrize("smooth", [False, True])
def test_make_movie_matches_bench_construction(dtype, smooth):
    t, d1, d2 = 1024, 24, 20
    movie, clean_fn = make_movie(dtype, d1, d2, t, smooth=smooth, device="cpu")
    assert movie.shape == (t, d1, d2) and movie.dtype == getattr(torch, dtype)
    clean = clean_fn(torch.arange(t)).double()
    scale, offset = MOVIE_RANGES[dtype][:2] if dtype in MOVIE_RANGES else (1.0, 0.0)
    signal = (clean - offset) / scale
    noise = (movie.double() - clean) / scale
    # rank 16 of unit-variance factors: per-pixel signal variance ~16
    assert abs(float(signal.var()) / 16.0 - 1.0) < 0.25
    if dtype == "float32":
        assert abs(float(noise.std()) - 1.0) < 0.02
    elif dtype == "uint16":
        # truncation toward zero: noise in movie units is N(0, 1) * 40 - U(0, 1)
        assert abs(float(noise.std()) * 40 - np.sqrt(40**2 + 1 / 12)) < 0.8
    else:
        # the dtype's rounding (truncation toward zero, or float16/bfloat16's
        # mantissa) adds well under 2% to N(0, 1)'s std; clipped samples
        # (below) are left out
        kept = torch.ones_like(noise, dtype=torch.bool)
        if dtype in MOVIE_RANGES:
            kept = (movie != MOVIE_RANGES[dtype][2]) & (movie != MOVIE_RANGES[dtype][3])
        assert abs(float(noise[kept].std()) - 1.0) < 0.02
    if dtype in MOVIE_RANGES:
        # at most 0.3% of samples at the type's ends (8 x reaches the int8
        # ends at 4 sigma of the white signal; the smoothed factors' product
        # has heavier tails)
        lo, hi = MOVIE_RANGES[dtype][2:]
        assert float(((movie == lo) | (movie == hi)).double().mean()) < 5e-3
    if dtype == "int16":
        assert float((movie < 0).double().mean()) > 0.5   # most samples below 0
    # smoothed factors: neighbouring frames of the signal are correlated
    lag1 = float((signal[1:] * signal[:-1]).mean() / (signal * signal).mean())
    assert (lag1 > 0.8) if smooth else (abs(lag1) < 0.1)
    # the same seed makes the same movie
    again, _ = make_movie(dtype, d1, d2, t, smooth=smooth, device="cpu")
    assert torch.equal(movie, again)
