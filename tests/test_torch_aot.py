"""The port's ``aot`` against the JAX package's on the CPU, on movies of
400 x 40 x 40 with the JAX tests' settings (tests/test_pipeline.py:340-347).
The port has no stage warm (measured on an H100: none shortened a cold
call, PERF.md), so ``aot_warm`` is accepted and inert:

- True, False and "auto" give factors, ``pipeline_ranks`` and thresholds
  equal bit for bit (``torch.equal``) and one Monte-Carlo per call in each
  case (one window, four windows, the coset stage forced on), and
  ``pipeline_aot`` and ``pipeline_warm`` equal to the JAX pipeline's with
  its warms off;
- ``normalized_init_geometry`` equals the JAX function on a sweep, and
  the pipeline takes its frame range, window length and blocks from it;
- ``StageTimer`` and ``PMDLoader.order`` against the JAX package's;
- under a ``sketch_override`` every draw is the main thread's, and on a
  checkpoint resume nothing starts;
- the loader's ``stats_started_hook`` (once, after the cache is allocated,
  before the first chunk; what it raises is kept)."""

import logging
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from _torch_util import to_np

from conftest import make_low_rank_movie

import localmd_tpu.aot as jaot
import localmd_tpu.engine as je
import localmd_tpu.loader as jloader
import localmd_tpu.utils.logging as jlogging
import localmd_tpu_torch.aot as taot
import localmd_tpu_torch.engine as te
import localmd_tpu_torch.pipeline as port_pipeline
import localmd_tpu_torch.utils.logging as tlogging
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
NONE_WARMED = {"completed": [], "errors": {}}


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
    pmd, record = _run_recorded(movie, aot_warm, **kw)
    return pmd, [(is_main, out) for is_main, _, out in record["thresholds"]]


def _in_stats_pass() -> bool:
    return any(f.name == "_initialize_normalizers" for f in traceback.extract_stack())


def _run_recorded(movie, aot_warm, **kw):
    """One port call with the thresholds' memo empty. Records each
    ``threshold_heuristic`` call (main thread?, made inside the statistics
    pass?, result) and the Monte-Carlo's simulated batches."""
    record = {"thresholds": [], "simulations": 0}
    real_thr, real_sim = port_pipeline.threshold_heuristic, te._rank_simulation_batch

    def thr_spy(*args, **kwargs):
        out = real_thr(*args, **kwargs)
        record["thresholds"].append(
            (threading.current_thread() is threading.main_thread(), _in_stats_pass(), out))
        return out

    def sim_spy(*args, **kwargs):
        record["simulations"] += 1
        return real_sim(*args, **kwargs)

    te._threshold_cache.clear()
    port_pipeline.threshold_heuristic = thr_spy
    te._rank_simulation_batch = sim_spy
    try:
        pmd = port_pipeline.localmd_decomposition(movie, aot_warm=aot_warm, device="cpu",
                                                  **{**KW, **kw})
    finally:
        port_pipeline.threshold_heuristic = real_thr
        te._rank_simulation_batch = real_sim
        te._threshold_cache.clear()
    return pmd, record


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
            port = {aot: _run_recorded(movie, aot, **case) for aot in SETTINGS}
            j_off = jax_decomposition(movie, aot_warm=False, **{**KW, **case})
        finally:
            te.COSET_STAGE = je.COSET_STAGE = "auto"
        out[name] = dict(port=port, jax_aot=j_off.pipeline_aot, jax_warm=j_off.pipeline_warm)
    return out


@pytest.mark.parametrize("aot", SETTINGS[1:])
@pytest.mark.parametrize("case", list(CASES))
def test_warm_results_equal_cold(runs, case, aot):
    """Factors ``torch.equal``, equal ranks and thresholds, and one
    Monte-Carlo (one simulated batch at these sizes) per call, its result
    the same on every setting."""
    off, rec_off = runs[case]["port"][False]
    pmd, rec = runs[case]["port"][aot]
    _assert_same(pmd, off)
    assert rec["simulations"] == rec_off["simulations"] == 1
    thresholds = {out for _, _, out in rec["thresholds"]}
    assert thresholds == {out for _, _, out in rec_off["thresholds"]} and len(thresholds) == 1
    assert [(m, s) for m, s, _ in rec["thresholds"]] == [(True, False)]


@pytest.mark.parametrize("aot", SETTINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_aot_matches_jax(runs, case, aot):
    """``pipeline_aot`` as the JAX pipeline reports it with its warms off,
    whatever the setting: the port plans no block-stage warm."""
    assert runs[case]["jax_aot"] == OFF
    assert runs[case]["port"][aot][0].pipeline_aot == runs[case]["jax_aot"]


@pytest.mark.parametrize("aot", SETTINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_warm_matches_jax(runs, case, aot):
    """``pipeline_warm`` as the JAX pipeline reports it with its warms off:
    no task queued, none ran."""
    pmd = runs[case]["port"][aot][0]
    assert runs[case]["jax_warm"] == NONE_WARMED
    assert pmd.pipeline_warm == runs[case]["jax_warm"] and pmd._stage_warmer is None


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
    loader = PMDLoader(movie, device="cpu", background_rank=1, cache_movie=True, stats_started_hook=hook)
    assert calls == [(300, 300, 0)]
    assert loader.stats_hook_error is None and loader._cache_frames == 300

    def raising(loader, cache_target):
        raise ValueError("hook")

    loader = PMDLoader(movie, device="cpu", background_rank=1, stats_started_hook=raising)
    assert isinstance(loader.stats_hook_error, ValueError)
    plain = PMDLoader(movie, device="cpu", background_rank=1)
    assert torch.equal(loader.mean_img, plain.mean_img) and torch.equal(loader.std_img, plain.std_img)


@pytest.mark.parametrize("aot", SETTINGS)
def test_aot_warm_values(movie, aot):
    """Every ``aot_warm`` value, "auto" (the default) among them, reports
    what False reports and gives its result bit for bit."""
    pmd, _ = _run_port(movie, aot)
    off, _ = _run_port(movie, False)
    assert pmd._stage_warmer is None and pmd.pipeline_aot == OFF == off.pipeline_aot
    _assert_same(pmd, off)


# -- normalized_init_geometry -------------------------------------------------

GEOMETRY_SWEEP = [
    ((400, 40, 40), 400, None, (10, 10)),
    ((400, 40, 40), 1000, None, (10, 10)),
    ((400, 40, 40), 400, 100, (12, 12)),
    ((400, 40, 40), 300, 500, (64, 64)),
    ((2048, 512, 512), 1024, None, (32, 32)),
    ((30000, 512, 512), 4096, None, (32, 32)),
    ((20000, 256, 256), 4000, 2000, (32, 32)),
    ((4096, 1024, 1024), 512, None, (40, 40)),
    ((100, 13, 300), 250, 33, (13, 200)),
]


@pytest.mark.parametrize("shape,frame_range,window_chunks,blocks", GEOMETRY_SWEEP)
def test_normalized_init_geometry_matches_jax(shape, frame_range, window_chunks, blocks):
    got = taot.normalized_init_geometry(shape, frame_range, window_chunks, blocks)
    want = jaot.normalized_init_geometry(shape, frame_range, window_chunks, blocks)
    assert tuple(int(x) for x in got) == tuple(int(x) for x in want)


@pytest.mark.parametrize("blocks", [(9, 20), (20, 5), (0, 0)])
def test_normalized_init_geometry_raises_as_jax(blocks):
    with pytest.raises(ValueError):
        jaot.normalized_init_geometry((400, 40, 40), 400, None, blocks)
    with pytest.raises(ValueError):
        taot.normalized_init_geometry((400, 40, 40), 400, None, blocks)


GEOMETRY_CASES = {**CASES, "frame_range_past_the_movie": dict(frame_range=1000, window_chunks=None)}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_pipeline_takes_its_geometry_from_normalized_init_geometry(movie, case, monkeypatch):
    """The pipeline calls ``normalized_init_geometry`` once, and samples
    its init frames and tiles its blocks with what it returned, which is
    the JAX function's on the same arguments."""
    case = {**KW, **GEOMETRY_CASES[case]}
    got, windows = [], []
    real_geometry, real_windows = port_pipeline.normalized_init_geometry, \
        port_pipeline.identify_window_chunks

    def geometry_spy(*args):
        got.append((args, real_geometry(*args)))
        return got[-1][1]

    def windows_spy(frame_range, t_total, window_chunks, rng):
        windows.append((frame_range, window_chunks))
        return real_windows(frame_range, t_total, window_chunks, rng)

    monkeypatch.setattr(port_pipeline, "normalized_init_geometry", geometry_spy)
    monkeypatch.setattr(port_pipeline, "identify_window_chunks", windows_spy)
    monkeypatch.setattr(te, "COSET_STAGE", True if case["block_sizes"] == (12, 12) else "auto")
    te._threshold_cache.clear()
    try:
        pmd = port_pipeline.localmd_decomposition(movie, aot_warm=False, device="cpu", **case)
    finally:
        te._threshold_cache.clear()
    args = (movie.shape, case["frame_range"], case["window_chunks"], case["block_sizes"])
    assert len(got) == 1 and got[0][0][1:] == args[1:]
    assert tuple(got[0][0][0]) == movie.shape
    fr, wc, b1, b2 = got[0][1]
    assert (fr, wc, b1, b2) == tuple(int(x) for x in jaot.normalized_init_geometry(*args))
    assert windows == ([] if case["frame_range"] > movie.shape[0] else [(fr, wc)])
    assert tuple(pmd._blocksparse.block_shape) == (b1, b2)


# -- the two small gaps: StageTimer, PMDLoader.order -----------------------------

def test_stage_timer_matches_jax(caplog):
    """Same fields, banners and elapsed seconds as the JAX package's."""
    out = {}
    for name, mod in (("jax", jlogging), ("port", tlogging)):
        logger = mod.get_logger()
        messages = []
        handler = logging.Handler()
        handler.emit = lambda rec, messages=messages: messages.append(rec.getMessage())
        logger.addHandler(handler)
        try:
            with mod.StageTimer("stage x") as timer:
                time.sleep(0.01)
            with mod.StageTimer("quiet", verbose=False) as quiet:
                pass
        finally:
            logger.removeHandler(handler)
        assert timer.elapsed >= 0.01 and quiet.elapsed >= 0.0
        out[name] = [m.rsplit(" in ", 1)[0] for m in messages]
    assert out["port"] == out["jax"] == ["stage x...", "stage x done"]


@pytest.mark.parametrize("order", ["F", "C"])
def test_loader_order_matches_jax(order):
    movie = _movie()[:300]
    port = PMDLoader(movie, device="cpu", background_rank=1, order=order)
    ref = jloader.PMDLoader(movie, background_rank=1, order=order)
    assert port.order == ref.order == order
    with pytest.raises(AttributeError):
        port.order = "C"
