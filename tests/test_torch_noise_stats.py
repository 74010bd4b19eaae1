"""K1's plain twin (``ops.kernels.movie_stats`` on CPU tensors) and the
port's ``ops.noise`` against the JAX package: the XLA path and
``fused_movie_stats`` in interpret mode, on the cases of
tests/test_pallas_kernels.py:11-72. Tolerance: mean rtol 1e-5 with atol
1e-5 x max|mean| (a zero-mean pixel's mean is a cancelling sum, so a purely
relative bound is ill-posed there), sigma rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import to_np

from localmd_tpu.ops import noise as jnoise
from localmd_tpu.ops.pallas_kernels import fused_movie_stats
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops import noise as tnoise

SIGMA_TOL = dict(rtol=1e-4)


def assert_mean_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        actual, desired, rtol=1e-5, atol=1e-5 * float(np.abs(desired).max())
    )


def _port_stats(chunk, divisor, **kw):
    m, s = kernels.movie_stats(torch.from_numpy(chunk), divisor, **kw)
    return to_np(m), to_np(s)


@pytest.mark.parametrize("t,p", [(512, 700), (256, 64), (1100, 33)])
def test_scipy_mode_matches_xla_and_pallas(t, p, rng):
    chunk = rng.standard_normal((t, p)).astype(np.float32) * 2.3 + 1.0
    mean, sigma = _port_stats(chunk, 10_000)
    xla_sigma = np.asarray(jnoise.welch_noise_estimate(jnp.asarray(chunk.T)))
    np.testing.assert_allclose(sigma, xla_sigma, **SIGMA_TOL)
    assert_mean_close(mean, chunk.sum(axis=0) / 10_000)
    if t <= 512:
        pm, ps = fused_movie_stats(jnp.asarray(chunk), 10_000)
        assert_mean_close(mean, np.asarray(pm))
        np.testing.assert_allclose(sigma, np.asarray(ps), **SIGMA_TOL)


def test_uint16_input(rng):
    t, p = 384, 512
    chunk = rng.integers(0, 5000, size=(t, p), dtype=np.uint16)
    mean, sigma = _port_stats(chunk, t)
    assert_mean_close(mean, chunk.astype(np.float64).mean(axis=0))
    pm, ps = fused_movie_stats(jnp.asarray(chunk), t)
    np.testing.assert_allclose(sigma, np.asarray(ps), **SIGMA_TOL)
    xla = np.asarray(jnoise.welch_noise_estimate(jnp.asarray(chunk.T.astype(np.float32))))
    np.testing.assert_allclose(sigma, xla, **SIGMA_TOL)


@pytest.mark.parametrize("t", [256, 300, 500, 512])
def test_reference_mode_nperseg_t(t, rng):
    p = 600
    chunk = rng.standard_normal((t, p)).astype(np.float32) * 1.3
    mean, sigma = _port_stats(chunk, t, nperseg=t)
    xla = np.asarray(jnoise.welch_noise_estimate_ref_compat(jnp.asarray(chunk.T)))
    np.testing.assert_allclose(sigma, xla, **SIGMA_TOL)
    assert_mean_close(mean, chunk.astype(np.float64).mean(axis=0))
    if t in (300, 512):
        _, ps = fused_movie_stats(jnp.asarray(chunk), t, nperseg=t)
        np.testing.assert_allclose(sigma, np.asarray(ps), **SIGMA_TOL)


def test_mean_only_mode(rng):
    t, p = 100, 512
    chunk = rng.standard_normal((t, p)).astype(np.float32)
    mean, sigma = _port_stats(chunk, 100, compute_noise=False)
    pm, ps = fused_movie_stats(jnp.asarray(chunk), 100, compute_noise=False)
    assert_mean_close(mean, np.asarray(pm))
    np.testing.assert_array_equal(sigma, np.zeros(p, np.float32))


def test_fov_functions_match_jax_and_kernel(rng):
    d1, d2, t = 16, 32, 512
    movie = rng.standard_normal((t, d1, d2)).astype(np.float32)
    fov = np.moveaxis(movie, 0, -1)
    m_ref, s_ref = jnoise.get_mean_and_noise(jnp.asarray(fov), 1234)
    m_t, s_t = tnoise.get_mean_and_noise(torch.from_numpy(np.ascontiguousarray(fov)), 1234)
    assert_mean_close(to_np(m_t), np.asarray(m_ref))
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_ref), **SIGMA_TOL)
    m_rc, s_rc = jnoise.get_mean_and_noise_ref_compat(jnp.asarray(fov), 1234)
    m_trc, s_trc = tnoise.get_mean_and_noise_ref_compat(torch.from_numpy(np.ascontiguousarray(fov)), 1234)
    assert_mean_close(to_np(m_trc), np.asarray(m_rc))
    np.testing.assert_allclose(to_np(s_trc), np.asarray(s_rc), **SIGMA_TOL)
    assert_mean_close(
        to_np(tnoise.get_mean_chunk(torch.from_numpy(np.ascontiguousarray(fov)), 7)),
        np.asarray(jnoise.get_mean_chunk(jnp.asarray(fov), 7)),
    )
    # the (T, P) kernel path agrees with the (d1, d2, T) functions after a
    # C-order pixel reshape
    mean, sigma = _port_stats(movie.reshape(t, d1 * d2), 1234)
    assert_mean_close(mean.reshape(d1, d2), np.asarray(m_ref))
    np.testing.assert_allclose(sigma.reshape(d1, d2), np.asarray(s_ref), **SIGMA_TOL)


def test_band_dft_matrices_match_jax():
    for nperseg in (256, 500, 1024):
        ours = tnoise._band_dft_matrices(nperseg)
        ref = jnoise._band_dft_matrices(jnp.float32, nperseg)
        for a, b in zip(ours[:2], ref[:2]):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5, atol=2e-6)
        # column sums of nperseg terms that nearly cancel: absolute bound
        for a, b in zip(ours[2:], ref[2:]):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,nperseg,noise", [(200, 256, True), (300, 128, True)])
def test_invalid_arguments_raise(t, nperseg, noise):
    with pytest.raises(ValueError):
        kernels.movie_stats(torch.zeros(t, 8), t, compute_noise=noise, nperseg=nperseg)
