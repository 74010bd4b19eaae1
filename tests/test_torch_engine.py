"""Port vs JAX: the window-0 block stage, the failure filter and packing, and
the threshold Monte-Carlo's rank simulation. Every random draw is injected
(the same sketch in both packages, or the JAX key tree's noise and sketches
fed to the port). Tolerance: counts exact, per-block ``acc @ v_fit`` 1e-4
relative Frobenius, roughness statistics rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu import engine as je
from localmd_tpu.ops import linalg as jl
from localmd_tpu.ops import roughness as jr
from localmd_tpu.ops.tiling import BlockGrid
from localmd_tpu_torch import engine as te
from localmd_tpu_torch.ops import roughness as tr
from localmd_tpu_torch.utils.random import sketch_override

from conftest import make_low_rank_movie


def _fixed_sketch(shape):
    return np.random.default_rng(11).standard_normal(shape).astype(np.float32)


def _init_data(rng, d1=36, d2=30, t=240):
    movie = make_low_rank_movie(3, (t, d1, d2), rng=rng, noise=0.05)
    data = np.moveaxis(movie, 0, -1)
    data = (data - data.mean(axis=-1, keepdims=True)) / data.std(axis=-1, keepdims=True)
    return np.ascontiguousarray(data.astype(np.float32))


@pytest.mark.parametrize("thresholds,t_used", [((1e9, 1e9), 0), ((1.0, 1.0), 236), ((0.6, 0.9), 0)])
def test_window0_chunk_step_matches_jax(thresholds, t_used, rng):
    data = _init_data(rng)
    b1 = b2 = 12
    grid = BlockGrid(36, 30, (b1, b2))
    max_rank, taf, saf, mcf = 4, 4, 2, 1
    t_eff = t_used or data.shape[-1]
    keys = jax.random.split(jax.random.PRNGKey(0), grid.n_blocks)
    with jl.sketch_override(lambda shape: jnp.asarray(_fixed_sketch(shape))):
        acc_j, cnt_j, v_j = je.window0_chunk_step(
            jnp.asarray(data), jnp.asarray(grid.starts), keys, b1, b2, max_rank,
            taf, saf, thresholds[0], thresholds[1], mcf, je.identity, je.identity,
            t_used,
        )
    sketch = torch.as_tensor(_fixed_sketch((t_eff // taf, max_rank + 10))).expand(
        grid.n_blocks, -1, -1
    )
    acc_t, cnt_t, v_t = te.window0_chunk_step(
        t32(data), grid.starts, sketch, b1, b2, max_rank, taf, saf,
        thresholds[0], thresholds[1], mcf, t_used=t_used,
    )
    np.testing.assert_array_equal(to_np(cnt_t), np.asarray(cnt_j))
    prod_t = to_np(acc_t) @ to_np(v_t)
    prod_j = np.asarray(acc_j) @ np.asarray(v_j)
    for b in range(grid.n_blocks):
        if np.linalg.norm(prod_j[b]) > 0:
            assert rel_fro(prod_t[b], prod_j[b]) <= 1e-4, b
        else:
            assert np.linalg.norm(prod_t[b]) == 0


@pytest.mark.parametrize("mcf", [1, 2, 3])
def test_filter_by_failures_matches_oracle_and_jax(mcf, rng):
    dec = rng.random((64, 12)) < 0.6
    ours = to_np(tr.filter_by_failures(torch.as_tensor(dec), mcf))
    oracle = np.stack([jr.filter_by_failures_np(row, mcf) for row in dec])
    np.testing.assert_array_equal(ours, oracle)
    np.testing.assert_array_equal(ours, np.asarray(jr.filter_by_failures(jnp.asarray(dec), mcf)))
    np.testing.assert_array_equal(
        np.stack([tr.filter_by_failures_np(row, mcf) for row in dec]), oracle
    )


def test_pack_components_route_matches_jax(rng):
    n, p, r, slots = 5, 20, 6, 4
    u = rng.standard_normal((n, p, r)).astype(np.float32)
    v = rng.standard_normal((n, r, 9)).astype(np.float32)
    dec = (rng.random((n, r)) < 0.7).astype(np.int32)
    acc = rng.standard_normal((n, p, slots)).astype(np.float32)
    counts = np.array([0, 1, 2, 3, 4], np.int32)
    a_j, c_j, v_j = je._pack_components_route(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(dec), jnp.asarray(acc), jnp.asarray(counts), 2
    )
    a_t, c_t, v_t = te._pack_components_route(
        t32(u), t32(v), torch.as_tensor(dec), t32(acc), torch.as_tensor(counts), 2
    )
    np.testing.assert_array_equal(to_np(c_t), np.asarray(c_j))
    np.testing.assert_allclose(to_np(a_t), np.asarray(a_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(v_t), np.asarray(v_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims,num_comps", [((16, 16, 64), 1), ((12, 20, 48), 2)])
def test_rank_simulation_batch_matches_jax_key_tree(dims, num_comps):
    d1, d2, t = dims
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    sp_j, tp_j = je._rank_simulation_batch(keys, d1, d2, t, num_comps)
    noise, sketches = [], []
    for key in keys:
        k_noise, k_svd = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_noise, (d1, d2, t))))
        sketches.append(np.asarray(jax.random.normal(k_svd, (t, num_comps + 10))))
    sp_t, tp_t = te._rank_simulation_batch(t32(np.stack(noise)), t32(np.stack(sketches)), num_comps)
    np.testing.assert_allclose(to_np(sp_t), np.asarray(sp_j), rtol=1e-4)
    np.testing.assert_allclose(to_np(tp_t), np.asarray(tp_j), rtol=1e-4)


def test_threshold_heuristic_deterministic_and_plausible():
    dims = (16, 16, 64)
    a = te.threshold_heuristic(dims, iters=64, generator=torch.Generator().manual_seed(3), device="cpu")
    b = te.threshold_heuristic(dims, iters=64, generator=torch.Generator().manual_seed(3), device="cpu")
    assert a == b
    ref = je.threshold_heuristic(dims, iters=64, key=jax.random.PRNGKey(3))
    # independent Monte-Carlo streams: the 5th percentiles agree loosely
    for ours, theirs in zip(a, ref):
        assert 0 < ours and abs(ours - theirs) / theirs < 0.2


@pytest.mark.parametrize("cache_token", [None, ("as-device", 3)])
def test_threshold_heuristic_as_device_gives_the_floats_as_tensors(cache_token):
    """``as_device=True`` returns two 0-d float32 tensors on the device, of
    the values the floats have, as JAX returns two device scalars
    (engine.py:1051-1053); a memoized result too."""
    dims = (12, 12, 40)
    kw = dict(iters=8, sim_batch=4, device="cpu", cache_token=cache_token)
    floats = te.threshold_heuristic(dims, generator=torch.Generator().manual_seed(3), **kw)
    tensors = te.threshold_heuristic(dims, generator=torch.Generator().manual_seed(3), as_device=True,
                                     **kw)
    ref = je.threshold_heuristic(dims, iters=8, sim_batch=4, key=jax.random.PRNGKey(3), as_device=True)
    for x, f, r in zip(tensors, floats, ref):
        assert isinstance(x, torch.Tensor) and x.dim() == 0 and x.dtype == torch.float32
        assert x.device == torch.device("cpu") and float(x) == f
        assert np.asarray(r).ndim == 0 and np.asarray(r).dtype == np.float32


def test_threshold_heuristic_under_override_is_one_simulation():
    dims = (10, 12, 40)
    noise = np.random.default_rng(1).standard_normal(dims).astype(np.float32)
    sketch = np.random.default_rng(2).standard_normal((40, 11)).astype(np.float32)
    with sketch_override(lambda shape: noise if tuple(shape) == dims else sketch):
        s_thr, t_thr = te.threshold_heuristic(dims, iters=8, sim_batch=4, device="cpu")
    sp, tp = te._rank_simulation_batch(t32(noise[None]), t32(sketch[None]), 1)
    assert s_thr == pytest.approx(float(sp[0, 0]), rel=1e-6)
    assert t_thr == pytest.approx(float(tp[0, 0]), rel=1e-6)


@pytest.mark.parametrize("shape", [(3, 9, 11), (2, 4, 7, 6)])
def test_roughness_stats_match_jax(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tr.spatial_roughness_stat(t32(x))),
        np.asarray(jr.spatial_roughness_stat(jnp.asarray(x))), rtol=1e-5,
    )
    np.testing.assert_allclose(
        to_np(tr.temporal_roughness_stat(t32(x))),
        np.asarray(jr.temporal_roughness_stat(jnp.asarray(x))), rtol=1e-5,
    )


def test_construct_final_fitness_decision_matches_jax(rng):
    images = rng.standard_normal((12, 10, 5)).astype(np.float32)
    images[..., :2] = np.linspace(0, 1, 12)[:, None, None]      # smooth components
    traces = rng.standard_normal((80, 5)).astype(np.float32)
    traces[:, :2] = np.sin(np.linspace(0, 3, 80))[:, None]
    for thr in [(1.0, 1.0), (0.5, 2.0), (3.0, 0.1)]:
        ours = to_np(tr.construct_final_fitness_decision(t32(images), t32(traces), *thr))
        ref = np.asarray(jr.construct_final_fitness_decision(jnp.asarray(images), jnp.asarray(traces), *thr))
        np.testing.assert_array_equal(ours, ref)
