"""The plain reference against independent witnesses: scipy's Welch
estimate, a direct least-squares solve and a direct reconstruction."""

import numpy as np
import pytest
import scipy.signal
import torch

from pmdbench.reference import frames, projection, stats


def test_welch_sigma_is_scipys_band_floor():
    rng = np.random.default_rng(0)
    x = rng.normal(100.0, 3.0, size=(1024, 7)) + np.sin(np.arange(1024) / 30.0)[:, None]
    _, psd = scipy.signal.welch(x, nperseg=256, noverlap=128, window="hann", detrend="constant",
                                scaling="density", axis=0)
    want = np.sqrt(psd[65:129].mean(axis=0) / 2.0)
    got = stats.welch_sigma(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # white noise of sigma 3: the band floor estimates sigma
    assert np.all(np.abs(got - 3.0) < 0.45)


def test_movie_stats_chunks_and_a_short_tail():
    rng = np.random.default_rng(1)
    t = 2 * 1024 + 300
    x = torch.as_tensor(rng.integers(3000, 5000, size=(t, 50)).astype(np.uint16))
    ms = stats.MovieStats(t, 50, "cpu", pixel_block=16)
    for a in range(0, t, 1024):
        ms.add(a, x[a : a + 1024])
    mean, noise = ms.result()
    xf = x.to(torch.float64)
    torch.testing.assert_close(mean, xf.mean(dim=0), rtol=1e-14, atol=0)
    parts = [stats.welch_sigma(xf[a : a + 1024]) for a in (0, 1024, 2048)]
    torch.testing.assert_close(noise, sum(parts) / 3, rtol=1e-14, atol=0)
    short = stats.MovieStats(1024 + 100, 50, "cpu")
    short.add(0, x[:1024])
    short.add(1024, x[1024:1124])
    torch.testing.assert_close(short.result()[1], parts[0], rtol=1e-14, atol=0)
    with pytest.raises(ValueError):
        stats.MovieStats(t, 50, "cpu").add(1024, x[1024:2048])


def test_projection_is_the_least_squares_fit_and_gaps_measure_departures():
    rng = np.random.default_rng(2)
    d1, d2, k, t = 6, 5, 4, 40
    u = rng.normal(size=(d1 * d2, 7))
    r = rng.normal(size=(7, k))
    csr = __import__("scipy.sparse", fromlist=["csr_matrix"]).csr_matrix(u)
    a_f = projection.spatial_basis(csr.indptr, csr.indices, csr.data, r, "F", d1, d2, "cpu")
    # F order counts down columns: C-order row i * d2 + j is F-order row i + j * d1
    ids_c = np.arange(d1 * d2).reshape(d1, d2)
    ids_f = np.arange(d1 * d2).reshape(d1, d2, order="F")
    np.testing.assert_allclose(a_f.numpy()[ids_c.ravel()], (u @ r)[ids_f.ravel()], rtol=1e-12)
    mean = torch.as_tensor(rng.uniform(100, 200, d1 * d2))
    std = torch.as_tensor(rng.uniform(1, 3, d1 * d2))
    y = torch.as_tensor(rng.normal(150, 5, size=(t, d1 * d2)))
    pr = projection.Projection(a_f, mean, std, t, max_bytes=3 * d1 * d2 * 8)
    pr.add(0, y[:25])
    pr.add(25, y[25:])
    best = pr.solve()
    ystd = ((y - mean) / std).numpy().T
    want = np.linalg.lstsq(a_f.numpy(), ystd, rcond=None)[0]
    np.testing.assert_allclose(best.numpy(), want, rtol=1e-9, atol=1e-12)
    assert float(projection.frame_gaps(a_f, best, best).max()) == 0.0
    bad = best.clone()
    bad[:, 3] *= 1.01
    gaps = projection.frame_gaps(a_f, best, bad)
    assert gaps[3] == pytest.approx(0.01, rel=1e-9) and float(gaps[:3].max()) == 0.0


def test_served_frames_are_mean_plus_std_times_the_product():
    rng = np.random.default_rng(3)
    d1, d2, k, t = 5, 6, 3, 12
    a = torch.as_tensor(rng.normal(size=(d1 * d2, k)))
    c = torch.as_tensor(rng.normal(size=(k, t)))
    mean = torch.as_tensor(rng.uniform(10, 20, d1 * d2))
    std = torch.as_tensor(rng.uniform(1, 2, d1 * d2))
    req = dict(kind="roi_trace", t0=4, n=5, r0=1, c0=2, h=3, w=4)
    got = frames.served(a, c, mean, std, d2, req)
    full = (mean[:, None] + std[:, None] * (a @ c)).T.reshape(t, d1, d2)
    torch.testing.assert_close(got, full[4:9, 1:4, 2:6], rtol=1e-14, atol=0)
    assert frames.gap(got.clone(), got, mean, d2, req) == 0.0
    assert frames.gap(got + 1e-3, got, mean, d2, req) > 0.0
