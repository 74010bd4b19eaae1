"""The reference-name namespaces of the port against the JAX package's: each
``__all__`` equals the JAX file's, the helpers they re-export (noise,
roughness, ``PMDLoader``'s crops, ``v_projection_routine``,
``standardize_and_filter``) and the ``compat`` per-block functions agree
with the JAX functions on the same inputs (the same injected sketch in both
packages, or the JAX draws fed to the port), ``FrameDataloader`` merges the
tail, and ``make_key`` seeds a ``torch.Generator``. Tolerance: rtol 1e-5
for elementwise helpers, 1e-4 relative Frobenius for per-block U V
products; decisions and counts exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from conftest import make_low_rank_movie

from localmd_tpu.ops.linalg import sketch_override as jax_sketch_override
from localmd_tpu_torch.utils.random import sketch_override

NAMESPACES = ["decomposition", "diagnostic_plots", "evaluation", "pmd_loader", "pmdarray",
              "preprocessing_utils", "ops", "parallel"]


def _sketch(shape):
    return np.random.default_rng(77).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", NAMESPACES)
def test_namespace_all_equals_the_jax_file(name):
    ours = importlib.import_module(f"localmd_tpu_torch.{name}")
    ref = importlib.import_module(f"localmd_tpu.{name}")
    assert list(ours.__all__) == list(ref.__all__)
    for symbol in ours.__all__:
        assert getattr(ours, symbol) is not None, symbol


def test_namespaces_are_bound_on_the_package():
    import localmd_tpu_torch as localmd

    for name in NAMESPACES[:-2]:
        assert getattr(localmd, name).__name__ == f"localmd_tpu_torch.{name}"
    assert localmd.decomposition.localmd_decomposition is localmd.localmd_decomposition
    assert localmd.pmdarray.PMDArray is localmd.PMDArray


def test_keys_module_has_the_jax_names():
    from localmd_tpu.utils import keys as jax_keys
    from localmd_tpu_torch.utils import keys

    for name in ("make_key", "make_key_with_seed", "split_keys", "make_jax_random_key"):
        assert callable(getattr(keys, name)) and hasattr(jax_keys, name)


# -- helpers -------------------------------------------------------------------

def _traces(rng, shape=(3, 4, 300)):
    return (rng.standard_normal(shape) * 2.0 + 5.0).astype(np.float32)


NOISE_HELPERS = ["get_mean", "center", "center_and_noise_normalize", "standardize_block",
                 "get_noise_estimate", "center_vmap", "center_and_noise_normalize_vmap",
                 "get_noise_estimate_vmap"]


@pytest.mark.parametrize("name", NOISE_HELPERS)
def test_preprocessing_helpers_match_jax(name, rng):
    import localmd_tpu.preprocessing_utils as jp
    import localmd_tpu_torch.preprocessing_utils as tp

    x = _traces(rng)
    np.testing.assert_allclose(to_np(getattr(tp, name)(t32(x))), np.asarray(getattr(jp, name)(x)),
                               rtol=1e-5, atol=1e-5)


def test_center_and_get_noise_estimate_and_mean_and_noise_match_jax(rng):
    import localmd_tpu.preprocessing_utils as jp
    import localmd_tpu_torch.preprocessing_utils as tp

    movie = _traces(rng, (6, 5, 512))
    mean = movie.mean(axis=-1)
    np.testing.assert_allclose(to_np(tp.center_and_get_noise_estimate(t32(movie), t32(mean))),
                               np.asarray(jp.center_and_get_noise_estimate(movie, mean)), rtol=1e-5)
    for ours, ref in zip(tp.get_mean_and_noise(t32(movie), 1024), jp.get_mean_and_noise(movie, 1024)):
        np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("name,shape", [("l1_norm", (4, 7, 9)), ("trend_filter_stat", (5, 40)),
                                        ("total_variation_stat", (3, 9, 11)),
                                        ("total_variation_stat", (8, 6))])
def test_roughness_helpers_match_jax(name, shape, rng):
    import localmd_tpu.evaluation as je
    import localmd_tpu_torch.evaluation as te

    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(to_np(getattr(te, name)(t32(x))), np.asarray(getattr(je, name)(x)),
                               rtol=1e-5)


def test_evaluation_vmap_adapters_match_jax(rng):
    import localmd_tpu.evaluation as je
    import localmd_tpu_torch.evaluation as te

    imgs = rng.standard_normal((9, 8, 3)).astype(np.float32)
    imgs[..., 0] = np.linspace(0, 1, 9)[:, None]
    traces = rng.standard_normal((50, 3)).astype(np.float32)
    traces[:, 0] = np.sin(np.linspace(0, 3, 50))
    np.testing.assert_allclose(to_np(te.spatial_roughness_stat_vmap(t32(imgs))),
                               np.asarray(je.spatial_roughness_stat_vmap(imgs)), rtol=1e-5)
    np.testing.assert_allclose(to_np(te.temporal_roughness_stat_vmap(t32(traces.T))),
                               np.asarray(je.temporal_roughness_stat_vmap(traces.T)), rtol=1e-5)
    for thr in [(1e9, 1e9), (0.5, 1.0), (1.0, 0.3)]:
        np.testing.assert_array_equal(to_np(te.evaluate_fitness_vmap(t32(imgs), t32(traces), *thr)),
                                      np.asarray(je.evaluate_fitness_vmap(imgs, traces, *thr)))


@pytest.fixture(scope="module")
def loaders():
    """The JAX package's and the port's PMDLoader on one uint16 movie."""
    from localmd_tpu.loader import PMDLoader as JaxLoader
    from localmd_tpu_torch import PMDLoader

    movie = make_low_rank_movie(3, (300, 20, 18), rng=np.random.default_rng(9), noise=0.2)
    movie = np.clip(np.rint(movie * 500.0 + 300.0), 0, 65535).astype(np.uint16)
    kw = dict(background_rank=2, seed=0, np_rng=np.random.RandomState(0))
    jax_loader = JaxLoader(movie, **kw)
    kw["np_rng"] = np.random.RandomState(0)
    return movie, jax_loader, PMDLoader(movie, device="cpu", **kw)


@pytest.mark.parametrize("frames", [slice(10, 60), [3, 7, 250, 8], range(290, 300)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loader_temporal_crops_match_jax(loaders, frames, dtype):
    """The crops come in the loader's ``dtype``. The float64 pair is built
    with the float32 pair's JAX statistics (``precomputed``), so the
    standardized crops differ only by their own arithmetic."""
    from localmd_tpu.loader import PMDLoader as JaxLoader
    from localmd_tpu_torch import PMDLoader

    movie, jax_loader, port_loader = loaders
    rtol, atol = 1e-4, 1e-4
    if dtype != "float32":
        pre = {"mean_img": np.array(jax_loader.mean_img), "std_img": np.array(jax_loader.std_img),
               "spatial_basis": np.array(jax_loader.spatial_basis)}
        kw = dict(background_rank=2, seed=0, precomputed=pre, dtype=dtype)
        jax_loader = JaxLoader(movie, np_rng=np.random.RandomState(0), **kw)
        port_loader = PMDLoader(movie, np_rng=np.random.RandomState(0), device="cpu", **kw)
        rtol, atol = 1e-6, 0
    crop = port_loader.temporal_crop(frames)
    ref = jax_loader.temporal_crop(frames)
    assert ref.dtype == np.dtype(dtype) and to_np(crop).dtype == ref.dtype
    np.testing.assert_array_equal(to_np(crop), ref)
    np.testing.assert_array_equal(to_np(crop), movie[frames].astype(dtype).transpose(1, 2, 0))
    ours, ref = to_np(port_loader.temporal_crop_standardized(frames)), jax_loader.temporal_crop_standardized(frames)
    assert ref.dtype == np.dtype(dtype) and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


def test_loader_runs_on_the_card_unless_told(loaders):
    """``device`` is a keyword with the card as its default, as in every
    other entry point: without CUDA a call that names no device raises."""
    from localmd_tpu_torch import PMDLoader

    movie, _, port_loader = loaders
    assert port_loader.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PMDLoader(movie, background_rank=0)


def test_pmd_loader_standardize_and_filter_matches_jax(rng):
    import localmd_tpu.loader as jld
    import localmd_tpu.pmd_loader as jl
    import localmd_tpu_torch.loader as tld
    import localmd_tpu_torch.pmd_loader as tl

    d1, d2, t, k = 8, 7, 30, 3
    data = rng.standard_normal((d1, d2, t)).astype(np.float32) * 3 + 10
    mean = data.mean(axis=-1)
    std = (1 + rng.random((d1, d2))).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal((d1 * d2, k)))[0].astype(np.float32)
    for order in ("F", "C"):
        ours = tl.standardize_and_filter(t32(data), t32(mean), t32(std), t32(basis), order)
        ref = jl.standardize_and_filter(jnp.asarray(data), jnp.asarray(mean), jnp.asarray(std),
                                        jnp.asarray(basis), order)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4, atol=1e-4)
        # the loader's own, called with the JAX package's keywords
        kw = dict(mean_img=mean, std_img=std, spatial_basis_flat=basis, order=order)
        ours = tld.standardize_and_filter(data=t32(data), **{k: t32(v) if k != "order" else v
                                                             for k, v in kw.items()})
        ref = jld.standardize_and_filter(data=jnp.asarray(data), **{k: jnp.asarray(v) if k != "order"
                                                                     else v for k, v in kw.items()})
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("order", ["F", "C"])
def test_v_projection_routine_matches_jax(order, rng):
    import localmd_tpu.pmd_loader as jl
    import localmd_tpu_torch.pmd_loader as tl

    d1, d2, t, r, k = 6, 5, 12, 4, 3
    chunk = rng.standard_normal((d1, d2, t)).astype(np.float32)
    ut = rng.standard_normal((r, d1 * d2)).astype(np.float32)
    p = rng.standard_normal((k, r)).astype(np.float32)
    mean_r = rng.standard_normal((d1 * d2, 1)).astype(np.float32)
    std_r = (1 + rng.random((d1 * d2, 1))).astype(np.float32)
    ours = tl.v_projection_routine(order, t32(p), t32(ut), t32(chunk), t32(mean_r), t32(std_r))
    ref = jl.v_projection_routine(order, jnp.asarray(p), jnp.asarray(ut), jnp.asarray(chunk),
                                  jnp.asarray(mean_r), jnp.asarray(std_r))
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_frame_dataloader_merges_the_tail(rng):
    from localmd_tpu.pmd_loader import FrameDataloader as JaxFrames
    from localmd_tpu_torch.pmd_loader import FrameDataloader

    movie = rng.standard_normal((10, 4, 3)).astype(np.float32)
    for source in (movie, torch.from_numpy(movie)):
        dl = FrameDataloader(source, 4)
        assert isinstance(dl, torch.utils.data.Dataset)
        assert len(dl) == len(JaxFrames(movie, 4)) == 2
        assert [c.shape for c in dl] == [(4, 3, 4), (4, 3, 6)]
        np.testing.assert_array_equal(dl[-1], JaxFrames(movie, 4)[-1])
        with pytest.raises(IndexError):
            dl[2]
    batches = list(torch.utils.data.DataLoader(FrameDataloader(movie, 3), batch_size=None))
    assert [tuple(b.shape) for b in batches] == [(4, 3, 3), (4, 3, 3), (4, 3, 4)]


def test_make_key_seeds_a_generator_from_numpy_when_unseeded():
    from localmd_tpu_torch.utils.keys import make_jax_random_key, make_key_with_seed, split_keys

    a = torch.rand(4, generator=make_jax_random_key(5, device="cpu"))
    assert torch.equal(a, torch.rand(4, generator=make_jax_random_key(5, device="cpu")))
    np.random.seed(123)
    gen1, seed1 = make_key_with_seed(None, device="cpu")
    np.random.seed(123)
    gen2, seed2 = make_key_with_seed(None, device="cpu")
    assert seed1 == seed2 and torch.equal(torch.rand(3, generator=gen1), torch.rand(3, generator=gen2))
    subs = split_keys(make_jax_random_key(1, device="cpu"), 3)
    draws = [torch.rand(2, generator=g) for g in subs]
    assert len(subs) == 3 and not torch.equal(draws[0], draws[1])


# -- compat: the per-block functions ----------------------------------------------

def _block(rng, d1=16, d2=16, t=120, rank=3):
    u = rng.random((d1 * d2, rank)).astype(np.float32)
    v = rng.standard_normal((rank, t)).astype(np.float32)
    v *= np.asarray([5.0, 3.0, 2.0], np.float32)[:rank, None]
    block = (u @ v).reshape(d1, d2, t, order="F")
    return (block + 0.01 * rng.standard_normal(block.shape)).astype(np.float32)


def _jax(fn, *args, **kwargs):
    with jax_sketch_override(lambda shape: jnp.asarray(_sketch(shape))):
        return fn(*args, **kwargs)


def _port(fn, *args, **kwargs):
    with sketch_override(_sketch):
        return fn(*args, device="cpu", **kwargs)


def _flat_product(u, v):
    u = to_np(u)
    return u.reshape(-1, u.shape[-1], order="F") @ to_np(v)


@pytest.mark.parametrize("denoisers", [False, True])
def test_single_block_md_matches_jax(denoisers, rng):
    import localmd_tpu.compat as jc
    import localmd_tpu_torch.compat as tc

    from test_torch_options import jax_spatial, jax_temporal, torch_spatial, torch_temporal

    block = _block(rng)
    extra_j = (jax_spatial, jax_temporal) if denoisers else ()
    extra_t = (torch_spatial, torch_temporal) if denoisers else ()
    u_j, d_j, v_j = _jax(jc.single_block_md, jnp.asarray(block), jax.random.PRNGKey(0),
                         np.zeros(4), 4, 2, 0.9, 1.2, *extra_j)
    u_t, d_t, v_t = _port(tc.single_block_md, block, None, np.zeros(4), 4, 2, 0.9, 1.2, *extra_t)
    assert tuple(u_t.shape) == (16, 16, 4) and tuple(v_t.shape) == (4, 120)
    np.testing.assert_array_equal(to_np(d_t), np.asarray(d_j))
    assert rel_fro(_flat_product(u_t, v_t), _flat_product(u_j, v_j)) <= 1e-4


def test_single_residual_block_md_matches_jax(rng):
    import localmd_tpu.compat as jc
    import localmd_tpu_torch.compat as tc

    block = _block(rng)
    u0 = _jax(jc.single_block_md, jnp.asarray(block), jax.random.PRNGKey(0), np.zeros(2), 4, 2,
              1e9, 1e9)[0]
    u_j, d_j, v_j = _jax(jc.single_residual_block_md, jnp.asarray(block), u0,
                         jax.random.PRNGKey(1), np.zeros(2), 4, 1e9, 1e9)
    u_t, d_t, v_t = _port(tc.single_residual_block_md, block, np.asarray(u0), None, 2, 4, 1e9, 1e9)
    np.testing.assert_array_equal(to_np(d_t), np.asarray(d_j))
    assert rel_fro(_flat_product(u_t, v_t), _flat_product(u_j, v_j)) <= 1e-4
    a = np.asarray(u0).reshape(256, -1, order="F")
    assert np.abs(a.T @ to_np(u_t).reshape(256, -1, order="F")).max() < 1e-3


def test_windowed_pmd_matches_jax(rng):
    import localmd_tpu.compat as jc
    import localmd_tpu_torch.compat as tc

    block = _block(rng, t=160, rank=2)
    s_j, t_j = _jax(jc.windowed_pmd, 40, jnp.asarray(block), 4, 0.6, 1.0, 1, 4, 2,
                    key=jax.random.PRNGKey(3))
    s_t, t_t = _port(tc.windowed_pmd, 40, block, 4, 0.6, 1.0, 1, 4, 2)
    assert isinstance(s_t, np.ndarray) and s_t.shape == s_j.shape and t_t.shape == t_j.shape
    assert rel_fro(_flat_product(s_t, t_t), _flat_product(s_j, t_j)) <= 1e-4


def test_get_temporal_projector_matches_jax(rng):
    import localmd_tpu.compat as jc
    import localmd_tpu_torch.compat as tc

    basis = rng.standard_normal((8, 6, 3)).astype(np.float32)
    block = rng.standard_normal((8, 6, 40)).astype(np.float32)
    np.testing.assert_allclose(to_np(tc.get_temporal_projector(basis, block, device="cpu")),
                               np.asarray(jc.get_temporal_projector(basis, block)), rtol=1e-4,
                               atol=1e-5)


def test_rank_simulation_and_its_statistics_match_jax():
    import localmd_tpu.compat as jc
    import localmd_tpu_torch.compat as tc

    d1, d2, t = 14, 12, 90
    k1, k2 = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    noise = np.asarray(jax.random.normal(k1, (d1, d2, t)))
    sp_j, tp_j = _jax(jc.rank_simulation, d1, d2, t, np.zeros(2), k1, k2)
    with sketch_override(lambda shape: noise if tuple(shape) == (d1, d2, t) else _sketch(shape)):
        sp_t, tp_t = tc.rank_simulation(d1, d2, t, np.zeros(2), None, None, device="cpu")
    np.testing.assert_allclose(to_np(sp_t), np.asarray(sp_j), rtol=1e-4)
    np.testing.assert_allclose(to_np(tp_t), np.asarray(tp_j), rtol=1e-4)
    sp_d, tp_d = _port(tc.decomposition_no_normalize_approx, noise, None, 2)
    np.testing.assert_allclose(to_np(sp_d), np.asarray(sp_j), rtol=1e-4)
    np.testing.assert_allclose(to_np(tp_d), np.asarray(tp_j), rtol=1e-4)


@pytest.mark.parametrize("rank", [5, np.zeros(5)])
def test_truncated_random_svd_shims_match_jax(rank, rng):
    import localmd_tpu.decomposition as jd
    import localmd_tpu.pmd_loader as jl
    import localmd_tpu_torch.decomposition as td
    import localmd_tpu_torch.pmd_loader as tl

    mat = rng.standard_normal((60, 40)).astype(np.float32)
    u_j, s_j, v_j = _jax(jd.truncated_random_svd, jnp.asarray(mat), jax.random.PRNGKey(0), rank)
    u_t, s_t, v_t = _port(td.truncated_random_svd, mat, None, rank)
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), rtol=1e-4)
    assert rel_fro((to_np(u_t) * to_np(s_t)) @ to_np(v_t), (np.asarray(u_j) * np.asarray(s_j)) @ np.asarray(v_j)) <= 1e-4
    if isinstance(rank, int):
        ul_j, vl_j = _jax(jl.truncated_random_svd, jnp.asarray(mat), jax.random.PRNGKey(0), rank)
        with sketch_override(_sketch):
            ul_t, vl_t = tl.truncated_random_svd(t32(mat), None, rank)
        assert rel_fro(to_np(ul_t) @ to_np(vl_t), np.asarray(ul_j) @ np.asarray(vl_j)) <= 1e-4


def test_gram_svd_routines_and_aggregate_match_jax(rng):
    import scipy.sparse

    import localmd_tpu.decomposition as jd
    import localmd_tpu_torch.decomposition as td

    for name, shape in (("fewer_rows_svd_routine", (6, 40)), ("fewer_columns_svd_routine", (40, 6))):
        mat = rng.standard_normal(shape).astype(np.float32)
        u, s, vt = getattr(td, name)(t32(mat))
        np.testing.assert_allclose(to_np(s), np.asarray(getattr(jd, name)(jnp.asarray(mat))[1]),
                                   rtol=1e-4)
        np.testing.assert_allclose((to_np(u) * to_np(s)) @ to_np(vt), mat, atol=1e-4)
    u = scipy.sparse.random(30, 5, density=0.3, format="coo", random_state=1)
    v = rng.standard_normal((5, 20)).astype(np.float32)
    bg_s = rng.standard_normal((30, 2)).astype(np.float32)
    bg_t = rng.standard_normal((2, 20)).astype(np.float32)
    u_t, v_t = td.aggregate_local_and_global_decomposition(u, v, bg_s, bg_t)
    u_j, v_j = jd.aggregate_local_and_global_decomposition(u, v, bg_s, bg_t)
    np.testing.assert_allclose(u_t.toarray() @ v_t, u_j.toarray() @ v_j, atol=1e-5)
