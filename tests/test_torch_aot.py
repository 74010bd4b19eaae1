"""The port's ``aot_warm`` against the JAX package's on the CPU, on movies
of 400 x 40 x 40 with the JAX tests' settings (tests/test_pipeline.py:
340-347). The port runs no stage warm (eager torch compiles nothing, and
warms on threads lengthened every cold call on an H100), so the option is
accepted and inert:

- True, False and "auto" give factors, ``pipeline_ranks`` and thresholds
  equal bit for bit (``torch.equal``) in each case (one window, four
  windows, the coset stage forced on), and ``pipeline_aot`` and
  ``pipeline_warm`` equal to the JAX pipeline's with its warms off;
- under a ``sketch_override`` every draw is the main thread's, and on a
  checkpoint resume nothing starts;
- the loader's ``stats_started_hook`` (once, after the cache is allocated,
  before the first chunk; what it raises is kept)."""

import threading

import numpy as np
import pytest
import torch

from _torch_util import to_np

from conftest import make_low_rank_movie

import localmd_tpu.engine as je
import localmd_tpu_torch.engine as te
import localmd_tpu_torch.pipeline as port_pipeline
from localmd_tpu.pipeline import localmd_decomposition as jax_decomposition
from localmd_tpu_torch.loader import PMDLoader
from localmd_tpu_torch.utils.random import sketch_override

KW = dict(block_sizes=(10, 10), frame_range=400, max_components=6, background_rank=2,
          temporal_avg_factor=5, sim_iters=20, seed=0, block_batch_size=16)
CASES = {
    "one_window": dict(window_chunks=None),
    "multi_window": dict(window_chunks=100),
    # the coset stage forced on, at the JAX test's default batch size and
    # with 12 x 12 blocks (the lattices plus a snapped tail's gathered
    # batch): at 10 x 10 the lattices' offsets (5) fall off the 2 x 2
    # pooling windows, and both packages take the gather stage
    "coset": dict(window_chunks=None, block_batch_size=256, block_sizes=(12, 12)),
}
SETTINGS = (False, True, "auto")
OFF = {"enabled": False, "used": False}


def _movie():
    return make_low_rank_movie(4, (400, 40, 40), np.random.default_rng(42), noise=0.3)


def _factors(pmd) -> dict:
    u = pmd._blocksparse
    return dict(panels=u.panels, dense=u.dense_basis, r=pmd._r_padded, s=torch.as_tensor(pmd._s_src),
                v=pmd._v_src, mean=torch.as_tensor(pmd.mean_img), var=torch.as_tensor(pmd.var_img))


def _assert_same(a, b) -> None:
    fa, fb = _factors(a), _factors(b)
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name
    assert a.pipeline_ranks == b.pipeline_ranks and a.rank == b.rank


def _run_port(movie, aot_warm, **kw):
    """One port call with the thresholds' memo empty; returns (pmd, per
    ``threshold_heuristic`` call, whether the main thread made it and what
    it returned)."""
    seen = []
    real = port_pipeline.threshold_heuristic

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((threading.current_thread() is threading.main_thread(), out))
        return out

    te._threshold_cache.clear()
    port_pipeline.threshold_heuristic = spy
    try:
        pmd = port_pipeline.localmd_decomposition(movie, aot_warm=aot_warm, device="cpu",
                                                  **{**KW, **kw})
    finally:
        port_pipeline.threshold_heuristic = real
        te._threshold_cache.clear()
    return pmd, seen


# -- the pipeline ----------------------------------------------------------------

@pytest.fixture(scope="module")
def movie():
    return _movie()


@pytest.fixture(scope="module")
def runs(movie):
    """Per case: the port with each ``aot_warm`` setting, and the JAX
    pipeline's ``pipeline_aot`` and ``pipeline_warm`` with its warms off.
    The coset case forces the coset stage on in both packages."""
    out = {}
    for name, case in CASES.items():
        te.COSET_STAGE = je.COSET_STAGE = True if name == "coset" else "auto"
        try:
            port = {aot: _run_port(movie, aot, **case) for aot in SETTINGS}
            j_off = jax_decomposition(movie, aot_warm=False, **{**KW, **case})
        finally:
            te.COSET_STAGE = je.COSET_STAGE = "auto"
        out[name] = dict(port=port, jax_aot=j_off.pipeline_aot, jax_warm=j_off.pipeline_warm)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_warm_results_equal_cold(runs, case):
    port = runs[case]["port"]
    off, thr_off = port[False]
    for aot in SETTINGS[1:]:
        pmd, thr = port[aot]
        _assert_same(pmd, off)
        # one Monte-Carlo, on the main thread, with the same thresholds
        assert thr == thr_off and len(thr) == 1 and thr[0][0]


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_aot_matches_jax(runs, case):
    r = runs[case]
    assert r["jax_aot"] == OFF
    for aot in SETTINGS:
        assert r["port"][aot][0].pipeline_aot == r["jax_aot"], aot


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_warm_matches_jax(runs, case):
    r = runs[case]
    assert r["jax_warm"] == {"completed": [], "errors": {}}
    for aot in SETTINGS:
        pmd = r["port"][aot][0]
        assert pmd.pipeline_warm == r["jax_warm"] and pmd._stage_warmer is None, aot


def test_warms_never_draw_under_a_sketch_override(movie):
    """Inside ``sketch_override`` the draws are the caller's: with
    ``aot_warm=True`` every draw is the main thread's, as many as with
    False, and the results are equal."""
    rng = np.random.default_rng(5)
    draws = []

    def fn(shape):
        draws.append(threading.current_thread() is threading.main_thread())
        return rng.standard_normal(shape).astype(np.float32)

    with sketch_override(fn):
        on, thr_on = _run_port(movie, True)
    n_on = len(draws)
    rng = np.random.default_rng(5)
    with sketch_override(fn):
        off, _ = _run_port(movie, False)
    assert all(draws) and len(draws) == 2 * n_on
    assert all(is_main for is_main, _ in thr_on)
    assert on.pipeline_warm == {"completed": [], "errors": {}} and on.pipeline_aot == OFF
    _assert_same(on, off)


def test_checkpoint_resume_starts_neither_warm(movie, tmp_path):
    """With the thresholds and the blocks loaded from a checkpoint, no
    Monte-Carlo runs and nothing is reported warmed."""
    ckpt = str(tmp_path / "ckpt")
    first, _ = _run_port(movie, False, checkpoint_path=ckpt)
    again, thr = _run_port(movie, True, checkpoint_path=ckpt)
    assert not thr
    assert again.pipeline_aot == OFF
    assert again.pipeline_warm == {"completed": [], "errors": {}}
    np.testing.assert_array_equal(to_np(first._v_src), to_np(again._v_src))


def test_loader_hook_fires_once_after_the_cache_is_allocated():
    """``stats_started_hook`` (loader.py:491-494, 836-842): once, with the
    cache planned and allocated and no chunk read yet."""
    calls = []

    def hook(loader, cache_target):
        calls.append((cache_target, loader._cache is not None and loader._cache.shape[0],
                      loader._cache_frames))

    movie = _movie()[:300]
    loader = PMDLoader(movie, "cpu", background_rank=1, cache_movie=True, stats_started_hook=hook)
    assert calls == [(300, 300, 0)]
    assert loader.stats_hook_error is None and loader._cache_frames == 300

    def raising(loader, cache_target):
        raise ValueError("hook")

    loader = PMDLoader(movie, "cpu", background_rank=1, stats_started_hook=raising)
    assert isinstance(loader.stats_hook_error, ValueError)
    plain = PMDLoader(movie, "cpu", background_rank=1)
    assert torch.equal(loader.mean_img, plain.mean_img) and torch.equal(loader.std_img, plain.std_img)


def test_aot_warm_values(movie):
    """``aot_warm`` "auto" (the default) reports what False reports."""
    auto, _ = _run_port(movie, "auto")
    off, _ = _run_port(movie, False)
    assert auto._stage_warmer is None and auto.pipeline_aot == OFF == off.pipeline_aot
    _assert_same(auto, off)
