"""The options of the port's ``localmd_decomposition`` that once raised, held
against the JAX package where it has the same option:

- the denoisers: the roll-average pair of tests/test_pipeline.py:1430-1435,
  written once in jnp and once in torch, through both pipelines on a
  golden-sized movie (500 x 40 x 36) with the same injected sketch and
  pinned thresholds, one window and five windows; ranks equal and the
  reconstruction within 1e-5 relative Frobenius. The per-block kernel
  with each denoiser against ``localmd_tpu.engine.single_block_md_batched``
  (per-block U V 1e-4 relative Frobenius, decisions equal);
- the checkpoint fingerprint: a changed denoiser constant, closure value,
  closure tensor or default invalidates a resume (the port of
  tests/test_pipeline.py:782-880);
- ``matmul_precision``: in force inside the call, the caller's setting back
  after it and after a raise;
- ``profile_dir``: a Chrome trace, and the unprofiled result;
- ``aot_warm``: accepted, the same result either way (1e-6 relative
  Frobenius: a CPU BLAS may differ in the last bit from run to run)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from conftest import make_low_rank_movie

import localmd_tpu.pipeline as jax_pipeline
import localmd_tpu_torch.engine as port_engine
import localmd_tpu_torch.pipeline as port_pipeline
from localmd_tpu import engine as je
from localmd_tpu.ops.linalg import sketch_override as jax_sketch_override
from localmd_tpu_torch.utils.random import sketch_override


def _sketch(shape):
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


def jax_temporal(traces):          # (r, t) light smoothing
    return (traces + jnp.roll(traces, 1, axis=-1) + jnp.roll(traces, -1, axis=-1)) / 3.0


def jax_spatial(frames):           # (r, b1, b2) light smoothing
    return (frames + jnp.roll(frames, 1, 1) + jnp.roll(frames, -1, 1)) / 3.0


def torch_temporal(traces):
    return (traces + torch.roll(traces, 1, dims=-1) + torch.roll(traces, -1, dims=-1)) / 3.0


def torch_spatial(frames):
    return (frames + torch.roll(frames, 1, 1) + torch.roll(frames, -1, 1)) / 3.0


GOLDEN_SHAPE = (500, 40, 36)
SETTINGS = dict(frame_range=500, max_components=6, background_rank=2, temporal_avg_factor=5,
                seed=0)
# multi-window: five windows of 100 frames, thresholds low enough that no
# block fills in window 0, so the residual windows (and their fallback) run
WINDOW_CASES = {"one_window": (None, (1e9, 1e9)), "five_windows": (100, (0.6, 0.9))}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_denoisers_match_the_jax_pipeline(case, monkeypatch):
    window_chunks, thresholds = WINDOW_CASES[case]
    movie = make_low_rank_movie(4, GOLDEN_SHAPE, rng=np.random.default_rng(3), noise=0.3)
    monkeypatch.setattr(jax_pipeline, "threshold_heuristic", lambda *a, **k: thresholds)
    monkeypatch.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: thresholds)
    with jax_sketch_override(lambda shape: jnp.asarray(_sketch(shape))):
        ref = jax_pipeline.localmd_decomposition(
            movie, (16, 16), window_chunks=window_chunks, spatial_denoiser=jax_spatial,
            temporal_denoiser=jax_temporal, **SETTINGS,
        )
    residual_calls = []
    residual = port_engine.single_residual_block_md_batched
    monkeypatch.setattr(port_engine, "single_residual_block_md_batched",
                        lambda *a, **k: residual_calls.append(1) or residual(*a, **k))
    with sketch_override(_sketch):
        ours = port_pipeline.localmd_decomposition(
            movie, (16, 16), window_chunks=window_chunks, spatial_denoiser=torch_spatial,
            temporal_denoiser=torch_temporal, device="cpu", **SETTINGS,
        )
    assert ours.rank == ref.rank
    assert ours.pipeline_ranks == ref.pipeline_ranks
    assert rel_fro(ours[:, :, :], ref[:, :, :]) <= 1e-5
    if window_chunks is not None:
        assert ours.pipeline_windows["n_windows"] == 5 and residual_calls


def _blocks(rng, n=6, b=12, t=120):
    movie = make_low_rank_movie(3, (t, 24, 36), rng=rng, noise=0.05)
    data = np.moveaxis(movie, 0, -1)
    data = (data - data.mean(axis=-1, keepdims=True)) / data.std(axis=-1, keepdims=True)
    return np.stack([data[i:i + b, j:j + b] for i in (0, 12) for j in (0, 12, 24)])[:n].astype(
        np.float32)


@pytest.mark.parametrize("which", ["both", "spatial", "temporal"])
def test_single_block_md_batched_with_denoisers_matches_jax(which, rng):
    blocks = _blocks(rng)
    n, max_rank, taf, saf, thr = blocks.shape[0], 4, 4, 2, (0.9, 1.2)
    jax_den = (jax_spatial if which != "temporal" else je.identity,
               jax_temporal if which != "spatial" else je.identity)
    port_den = (torch_spatial if which != "temporal" else port_engine.identity,
                torch_temporal if which != "spatial" else port_engine.identity)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    with jax_sketch_override(lambda shape: jnp.asarray(_sketch(shape))):
        u_j, d_j, v_j = je.single_block_md_batched(
            jnp.asarray(blocks), keys, max_rank, taf, saf, *thr, *jax_den)
    sketch = t32(_sketch((blocks.shape[-1] // taf, max_rank + 10))).expand(n, -1, -1)
    u_t, d_t, v_t = port_engine.single_block_md_batched(
        t32(blocks), sketch, max_rank, taf, saf, *thr, *port_den)
    np.testing.assert_array_equal(to_np(d_t), np.asarray(d_j))
    prod_t = to_np(u_t) @ to_np(v_t)
    prod_j = np.asarray(u_j) @ np.asarray(v_j)
    for b in range(n):
        assert rel_fro(prod_t[b], prod_j[b]) <= 1e-4, b


def test_identity_denoisers_are_the_default_path(rng):
    blocks = t32(_blocks(rng))
    sketch = t32(_sketch((30, 14))).expand(blocks.shape[0], -1, -1)
    args = (blocks, sketch, 4, 4, 2, 1e9, 1e9)
    default = port_engine.single_block_md_batched(*args)
    explicit = port_engine.single_block_md_batched(*args, port_engine.identity, port_engine.identity)
    for a, b in zip(default, explicit):
        assert torch.equal(a, b)


def test_a_denoiser_that_reads_a_value_raises_under_vmap(rng):
    """The contract: pure torch operations. ``.item()`` fails inside
    ``torch.func.vmap`` and nothing falls back to a loop."""
    blocks = t32(_blocks(rng))
    sketch = t32(_sketch((30, 14))).expand(blocks.shape[0], -1, -1)

    def reads_a_value(traces):
        return traces / traces.abs().max().item()

    with pytest.raises(RuntimeError):
        port_engine.single_block_md_batched(blocks, sketch, 4, 4, 2, 1e9, 1e9,
                                            port_engine.identity, reads_a_value)


def _golden_with_denoisers(background_rank, jacobi, monkeypatch):
    """The golden movie with the denoiser pair, the committed sketches and
    pinned thresholds; ``jacobi`` sends every small eigh through K4's plain
    twin, the route the card takes, instead of LAPACK."""
    import localmd_tpu_torch.ops.linalg as port_linalg
    from test_torch_golden import SKETCHES, _make_movie

    movie, t, rank = _make_movie()
    sketches = np.load(SKETCHES)
    with monkeypatch.context() as mp:
        mp.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
        if jacobi:
            mp.setattr(port_linalg, "uses_jacobi", lambda device, k: k <= port_linalg.JACOBI_MAX_DIM)
        with sketch_override(lambda shape: sketches["x".join(str(int(x)) for x in shape)]):
            pmd = port_pipeline.localmd_decomposition(
                movie, (16, 16), frame_range=t, max_components=rank,
                background_rank=background_rank, temporal_avg_factor=4,
                welch_compat="reference", seed=0, final_rank_tol=0.0,
                spatial_denoiser=torch_spatial, temporal_denoiser=torch_temporal, device="cpu",
            )
    return pmd.reconstruct_frames(np.arange(t))


def test_spatial_denoiser_branch_holds_across_eigh_routes(monkeypatch):
    """The check ``chip_smoke.py`` makes on the card (K4) against the CPU
    (LAPACK), made here with K4's twin: the golden movie without a
    background agrees to 1e-5. (With its rank-2 background removed, two of
    each block's four coarse components are noise of nearly equal singular
    values; the per-component spatial denoiser then follows the eigh's
    rotation inside that space, and the routes differ by ~2.6e-4.)"""
    lapack = _golden_with_denoisers(0, False, monkeypatch)
    twin = _golden_with_denoisers(0, True, monkeypatch)
    assert rel_fro(twin, lapack) <= 1e-5


# -- the checkpoint fingerprint -----------------------------------------------

RESUME = dict(block_sizes=(10, 10), frame_range=280, max_components=4, background_rank=1,
              temporal_avg_factor=4, sim_iters=15, seed=0, device="cpu")


def _clip_pair(kind):
    """Two denoisers of one name that differ in one way only."""
    if kind == "constant":
        def den_a(x):
            return torch.clamp(x, -100.0, 100.0)

        def den_b(x):
            return torch.clamp(x, -0.01, 0.01)

        den_b.__qualname__ = den_a.__qualname__
        assert den_a.__code__.co_code == den_b.__code__.co_code
        return den_a, den_b
    if kind == "default":
        def make(c):
            def den(x, c=c):
                return torch.clamp(x, -c, c)
            return den
        return make(100.0), make(0.01)

    def make(c):
        def den(x):
            return torch.clamp(x, -c, c)
        return den
    if kind == "closure_value":
        return make(100.0), make(0.01)
    return make(torch.tensor(100.0)), make(torch.tensor(0.01))     # closure tensor


@pytest.mark.parametrize("kind", ["constant", "default", "closure_value", "closure_tensor"])
def test_fn_token_hashes_what_the_denoiser_computes(kind):
    den_a, den_b = _clip_pair(kind)
    assert port_pipeline._fn_token(den_a) == port_pipeline._fn_token(_clip_pair(kind)[0])
    assert port_pipeline._fn_token(den_a) != port_pipeline._fn_token(den_b)
    assert port_pipeline._fn_token(None) is None


@pytest.mark.parametrize("kind", ["constant", "closure_tensor"])
def test_changed_denoiser_invalidates_the_resume(kind, tmp_path):
    movie = make_low_rank_movie(2, (280, 20, 20), rng=np.random.default_rng(0), noise=0.2)
    path = str(tmp_path / "ck")
    den_a, den_b = _clip_pair(kind)
    port = port_pipeline.localmd_decomposition
    first = port(movie, checkpoint_path=path, temporal_denoiser=den_a, **RESUME)
    resumed_b = port(movie, checkpoint_path=path, temporal_denoiser=den_b, **RESUME)
    fresh_b = port(movie, temporal_denoiser=den_b, **RESUME)
    np.testing.assert_allclose(resumed_b[7], fresh_b[7], atol=1e-5)
    assert not np.allclose(resumed_b[7], first[7], atol=1e-3)


def test_same_denoiser_resumes_from_the_block_stage(tmp_path, monkeypatch):
    movie = make_low_rank_movie(2, (280, 20, 20), rng=np.random.default_rng(0), noise=0.2)
    path = str(tmp_path / "ck")
    first = port_pipeline.localmd_decomposition(
        movie, checkpoint_path=path, spatial_denoiser=torch_spatial, **RESUME)
    calls = []
    step = port_pipeline.window0_chunk_step
    monkeypatch.setattr(port_pipeline, "window0_chunk_step",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    again = port_pipeline.localmd_decomposition(
        movie, checkpoint_path=path, spatial_denoiser=torch_spatial, **RESUME)
    assert not calls
    assert rel_fro(again[:, :, :], first[:, :, :]) <= 1e-6


# -- matmul_precision ---------------------------------------------------------

SMALL = dict(frame_range=280, max_components=4, background_rank=1, temporal_avg_factor=4,
             sim_iters=10, seed=0, device="cpu")


def _small_movie():
    return make_low_rank_movie(2, (280, 20, 20), rng=np.random.default_rng(1), noise=0.1)


def _spy_precision(monkeypatch, seen, fail=False):
    fsvd = port_pipeline.compute_lowrank_factorized_svd

    def spy(*args, **kwargs):
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32))
        if fail:
            raise RuntimeError("stop inside the call")
        return fsvd(*args, **kwargs)

    monkeypatch.setattr(port_pipeline, "compute_lowrank_factorized_svd", spy)


def _state():
    return (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("name,inside", [
    ("highest", "highest"), ("tensorfloat32", "high"), ("high", "high"),
    ("bfloat16", "medium"), ("medium", "medium"), (None, "highest"),
])
def test_matmul_precision_holds_inside_the_call_and_is_restored(name, inside, monkeypatch):
    seen = []
    _spy_precision(monkeypatch, seen)
    before = _state()
    try:
        port_pipeline.localmd_decomposition(_small_movie(), (10, 10), matmul_precision=name,
                                            **SMALL)
    finally:
        after = _state()
    assert seen == [(inside, inside != "highest")]
    assert after == before == (torch.get_float32_matmul_precision(), False, False)
    assert before[0] == "highest"


@pytest.mark.parametrize("caller", ["high", "medium"])
def test_the_callers_own_precision_comes_back_after_a_raise(caller, monkeypatch):
    import localmd_tpu_torch.config as config

    seen = []
    _spy_precision(monkeypatch, seen, fail=True)
    torch.set_float32_matmul_precision(caller)
    before = _state()
    try:
        with pytest.raises(RuntimeError, match="stop inside"):
            port_pipeline.localmd_decomposition(_small_movie(), (10, 10),
                                                matmul_precision="bfloat16", **SMALL)
        after = _state()
    finally:
        config.apply()
    assert seen == [("medium", True)]
    assert after == before
    assert _state() == ("highest", False, False)


def test_unknown_matmul_precision_raises():
    with pytest.raises(ValueError, match="matmul_precision"):
        port_pipeline.localmd_decomposition(_small_movie(), (10, 10), matmul_precision="fp8",
                                            **SMALL)
    assert _state() == ("highest", False, False)


# -- profile_dir and aot_warm -------------------------------------------------

def test_profile_dir_writes_a_chrome_trace_and_the_same_result(tmp_path):
    movie = _small_movie()
    with sketch_override(_sketch):
        plain = port_pipeline.localmd_decomposition(movie, (10, 10), **SMALL)
        trace_dir = tmp_path / "made" / "here"
        profiled = port_pipeline.localmd_decomposition(movie, (10, 10),
                                                       profile_dir=str(trace_dir), **SMALL)
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the same computation; a CPU BLAS may differ in the last bit run to run
    assert profiled.pipeline_ranks == plain.pipeline_ranks and profiled.rank == plain.rank
    assert rel_fro(profiled[:, :, :], plain[:, :, :]) <= 1e-6


def test_aot_warm_is_accepted_and_changes_nothing():
    movie = _small_movie()
    with sketch_override(_sketch):
        runs = [port_pipeline.localmd_decomposition(movie, (10, 10), aot_warm=v, **SMALL)
                for v in (True, False, "auto")]
    for other in runs[1:]:
        assert other.pipeline_ranks == runs[0].pipeline_ranks and other.rank == runs[0].rank
        assert rel_fro(other[:, :, :], runs[0][:, :, :]) <= 1e-6
