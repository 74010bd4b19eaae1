"""Port vs JAX linear algebra. Factors are compared through what they
determine (products, projectors, singular values), never raw factors,
whose signs and rotations are not unique. Tolerance: 1e-5 relative
Frobenius unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu.ops import linalg as jl
from localmd_tpu_torch.ops import linalg as tl
from localmd_tpu_torch.utils.random import sketch_override

TOL = 1e-5


def _proj(q):
    q = np.asarray(q, dtype=np.float64)
    return q @ np.swapaxes(q, -1, -2)


def _fixed(seed):
    def fn(shape):
        return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return fn


@pytest.mark.parametrize("shape", [(200, 12), (5, 64, 20), (3, 1020, 30)])
def test_cholesky_qr2_same_span_and_orthonormal(shape, rng):
    y = rng.standard_normal(shape).astype(np.float32)
    q_t = to_np(tl.cholesky_qr2(t32(y)))
    q_j = np.asarray(jl.cholesky_qr2(jnp.asarray(y)))
    eye = np.broadcast_to(np.eye(shape[-1]), q_t.shape[:-2] + (shape[-1], shape[-1]))
    # the trace ridge (k * 1e-6 of the Gram's trace) shrinks column norms by
    # up to ~k * 1e-6 in both packages
    assert np.abs(np.swapaxes(q_t, -1, -2) @ q_t - eye).max() < 1e-4
    assert rel_fro(_proj(q_t), _proj(q_j)) <= TOL


@pytest.mark.parametrize("k", [6, 30, 80])
def test_eigh_descending_matches_jax(k, rng):
    a = rng.standard_normal((4, k, k + 5)).astype(np.float32)
    sym = a @ np.swapaxes(a, -1, -2)
    vals_t, vecs_t = tl.eigh_descending(t32(sym))
    vals_j, vecs_j = jl.eigh_descending(jnp.asarray(sym))
    assert rel_fro(vals_t, vals_j) <= TOL
    assert np.all(np.diff(to_np(vals_t), axis=-1) <= 0)
    recon = to_np(vecs_t) * to_np(vals_t)[..., None, :] @ np.swapaxes(to_np(vecs_t), -1, -2)
    assert rel_fro(recon, sym) <= TOL


@pytest.mark.parametrize("fn,shape", [
    ("svd_gram_left", (3, 12, 40)),
    ("svd_gram_right", (3, 40, 12)),
    ("svd_small", (3, 12, 40)),
    ("svd_small", (3, 40, 12)),
])
def test_gram_svds_match_jax(fn, shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    u_t, s_t, vt_t = getattr(tl, fn)(t32(x))
    u_j, s_j, vt_j = getattr(jl, fn)(jnp.asarray(x))
    assert rel_fro(s_t, s_j) <= TOL
    recon_t = to_np(u_t) * to_np(s_t)[..., None, :] @ to_np(vt_t)
    assert rel_fro(recon_t, x) <= 1e-4
    recon_j = np.asarray(u_j) * np.asarray(s_j)[..., None, :] @ np.asarray(vt_j)
    assert rel_fro(recon_t, recon_j) <= 1e-4


def _low_rank(rng, shape, rank):
    *lead, d, t = shape
    a = rng.standard_normal((*lead, d, rank)).astype(np.float32)
    b = rng.standard_normal((*lead, rank, t)).astype(np.float32) * np.arange(rank, 0, -1)[:, None]
    return (a @ b + 1e-3 * rng.standard_normal(shape)).astype(np.float32)


def test_truncated_random_svd_with_injected_sketch(rng):
    x = _low_rank(rng, (300, 120), 5)
    fn = _fixed(3)
    with jl.sketch_override(lambda shape: jnp.asarray(fn(shape))):
        u_j, s_j, vt_j = jl.truncated_random_svd(jnp.asarray(x), jax.random.PRNGKey(0), 5)
    with sketch_override(fn):
        u_t, s_t, vt_t = tl.truncated_random_svd(t32(x), 5)
    assert rel_fro(s_t, s_j) <= TOL
    prod_t = to_np(u_t) * to_np(s_t)[None, :] @ to_np(vt_t)
    prod_j = np.asarray(u_j) * np.asarray(s_j)[None, :] @ np.asarray(vt_j)
    assert rel_fro(prod_t, prod_j) <= TOL


def test_batched_truncated_random_svd_with_injected_sketch(rng):
    x = _low_rank(rng, (6, 64, 50), 4)
    fn = _fixed(4)
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    with jl.sketch_override(lambda shape: jnp.asarray(fn(shape))):
        u_j, s_j, vt_j = jl.batched_truncated_random_svd(jnp.asarray(x), keys, 4)
    with sketch_override(fn):
        u_t, s_t, vt_t = tl.batched_truncated_random_svd(t32(x), 4)
    prod_t = to_np(u_t) * to_np(s_t)[..., None, :] @ to_np(vt_t)
    prod_j = np.asarray(u_j) * np.asarray(s_j)[..., None, :] @ np.asarray(vt_j)
    assert rel_fro(prod_t, prod_j) <= TOL
    # an explicit sketch gives the same result as the injected one
    sketch = torch.as_tensor(fn((50, 14))).expand(6, 50, 14)
    u_e, s_e, vt_e = tl.batched_truncated_random_svd(t32(x), 4, sketch=sketch)
    assert rel_fro(s_e, s_t) == 0.0


def test_rsvd_draws_independent_sketches_without_override(rng):
    x = t32(rng.standard_normal((2, 40, 30)).astype(np.float32))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tl.batched_truncated_random_svd(x, 3, generator=g1)[1]
    b = tl.batched_truncated_random_svd(x, 3, generator=g2)[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("m,n", [(20, 90), (90, 20)])
def test_projected_svd_matches_jax(m, n, rng):
    proj = rng.standard_normal((50, m)).astype(np.float32)
    data = rng.standard_normal((m, n)).astype(np.float32)
    r_t, s_t, vt_t = tl.projected_svd(t32(proj), t32(data))
    r_j, s_j, vt_j = jl.projected_svd(jnp.asarray(proj), jnp.asarray(data))
    assert rel_fro(s_t, s_j) <= TOL
    prod_t = to_np(r_t) * to_np(s_t)[None, :] @ to_np(vt_t)
    prod_j = np.asarray(r_j) * np.asarray(s_j)[None, :] @ np.asarray(vt_j)
    assert rel_fro(prod_t, prod_j) <= 1e-4


def test_subspace_eigh_with_injected_sketch(rng):
    m, rank, k_sketch = 600, 40, 72
    a = rng.standard_normal((m, rank)).astype(np.float32)
    sym = (a * np.linspace(3, 1, rank)) @ a.T
    jax_draw = np.asarray(
        jax.random.normal(jax.random.PRNGKey(m * 1000003 + k_sketch), (m, k_sketch))
    )
    vals_j, vecs_j = jl.subspace_eigh(jnp.asarray(sym), k_sketch)
    with sketch_override(lambda shape: jax_draw):
        vals_t, vecs_t = tl.subspace_eigh(t32(sym), k_sketch)
    assert rel_fro(to_np(vals_t)[:rank], np.asarray(vals_j)[:rank]) <= TOL
    top_t = to_np(vecs_t)[:, :rank]
    top_j = np.asarray(vecs_j)[:, :rank]
    assert rel_fro(_proj(top_t), _proj(top_j)) <= 1e-4


def _repeated_gram(rng, k=195, distinct=20):
    """A float32 (k, k) Gram with ``distinct`` eigenvalues, most repeated many
    times and the rest zero: the shape of the factorized SVD's Gram on a
    white movie."""
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    lam = np.zeros(k)
    lam[: 4 * distinct] = np.repeat(np.linspace(9.0, 1.0, distinct), 4)
    return ((q * lam) @ q.T).astype(np.float32)


def test_eigh_descending_cpu_repeated_spectrum_matches_numpy_and_jax(rng):
    """On the CPU eigh_descending is numpy's LAPACK eigh, descending; on a
    Gram with many repeated eigenvalues it agrees with the JAX package's
    eigh_descending (eigenvalues 1e-5 * lambda_max, reconstruction 1e-5)."""
    sym = _repeated_gram(rng)
    vals_t, vecs_t = tl.eigh_descending(t32(sym))
    ref_vals, ref_vecs = np.linalg.eigh(sym)
    assert vals_t.dtype == torch.float32 and vecs_t.dtype == torch.float32
    assert np.array_equal(to_np(vals_t), ref_vals[::-1]) and np.array_equal(to_np(vecs_t), ref_vecs[:, ::-1])
    vals_j, _ = jl.eigh_descending(jnp.asarray(sym))
    assert np.abs(to_np(vals_t) - np.asarray(vals_j)).max() <= 1e-5 * 9.0
    recon = to_np(vecs_t) * to_np(vals_t)[None, :] @ to_np(vecs_t).T
    assert rel_fro(recon, sym) <= TOL


def test_white_movie_decomposes_on_cpu_with_jax_ranks():
    """A white 64x64x2000 movie with 32x32 blocks and the thresholds pinned to
    (0, 0): torch's MKL eigh failed to converge on its factorized-SVD Gram
    (``_LinAlgError``); the port now runs and gives the JAX package's
    ``pipeline_ranks`` and kept rank, with one injected sketch in both."""
    import localmd_tpu.pipeline as jax_pipeline
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu.ops.linalg import sketch_override as jax_sketch_override

    movie = np.random.default_rng(0).standard_normal((2000, 64, 64)).astype(np.float32)
    kwargs = dict(frame_range=2000, max_components=20, background_rank=15, seed=0)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: (0.0, 0.0))
        mp.setattr(jax_pipeline, "threshold_heuristic", lambda *a, **k: (0.0, 0.0))
        fn = _fixed(1234)
        with sketch_override(fn):
            port = port_pipeline.localmd_decomposition(movie, (32, 32), device="cpu", **kwargs)
        with jax_sketch_override(lambda shape: jnp.asarray(fn(shape))):
            ref = jax_pipeline.localmd_decomposition(movie, (32, 32), **kwargs)
    finally:
        mp.undo()
    assert port.pipeline_ranks == ref.pipeline_ranks
    assert port.rank == ref.rank
    assert rel_fro(port[:, :, :], ref[:, :, :]) <= 1e-4
