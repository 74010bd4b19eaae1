"""The port's ``localmd_decomposition`` against the live JAX pipeline on the
same movie, with the same injected sketch and pinned thresholds: (a) order
C, (b) a uint16 movie, (c) T = 1100, whose statistics pass ends in a
76-frame tail below MIN_NOISE_FRAMES (mean only), (d) ``rank_prune`` with
odd 15x15 blocks, the rank-prune matrix taken from the JAX key tree (the
third split of ``PRNGKey(seed)``, pipeline.py:552-1288), (e) the
multi-window block stage (``window_chunks`` 100 of ``frame_range`` 400:
four windows) in float32 and uint16, with the thresholds pinned to the JAX
package's ``threshold_heuristic`` so that blocks do not fill in window 0.
(f) the call options with no other port test, on 500x40x36 movies:
``pixel_weighting`` (a seeded 0.5-2.0 map), ``max_consecutive_failures``
1 and 2 and ``frame_batch_size`` 128 under the JAX package's own
thresholds, ``rank_prune_factor`` 0.5, and ``sim_conf`` 10 with the port's
Monte-Carlo fed the JAX package's draws (its key tree's noise blocks, the
injected sketch), whose thresholds must equal the JAX package's to 1e-4.
Plus the state carried across: ``PMDArray.from_reference_state`` and .npz
files in both directions. Tolerance: reconstruction 1e-4 relative
Frobenius, std image rtol 1e-4, ``pipeline_ranks`` and kept rank equal;
identical factors reconstruct to 1e-5."""

import numpy as np
import pytest
import torch

from _torch_util import rel_fro, to_np

from conftest import make_low_rank_movie

CASES = {
    "order_c": dict(shape=(600, 60, 52), dtype="float32", order="C", frame_range=600, blocks=(20, 20)),
    "uint16": dict(shape=(600, 60, 52), dtype="uint16", order="F", frame_range=600, blocks=(20, 20)),
    "tail_1100": dict(shape=(1100, 40, 36), dtype="float32", order="F", frame_range=500, blocks=(16, 16)),
    "rank_prune": dict(shape=(700, 60, 52), dtype="float32", order="F", frame_range=500,
                       blocks=(15, 15), rank_prune=True),
    "multi_window_f32": dict(shape=(800, 48, 40), dtype="float32", order="F", frame_range=400,
                             blocks=(16, 16), window_chunks=100, noise=0.3),
    "multi_window_u16": dict(shape=(800, 48, 40), dtype="uint16", order="F", frame_range=400,
                             blocks=(16, 16), window_chunks=100, noise=0.3),
}
# the call options, each on a golden-sized noisy movie; "thresholds": "jax"
# pins the port to the JAX package's own Monte-Carlo result, "injected"
# runs the port's Monte-Carlo on the JAX package's draws
OPTION_BASE = dict(shape=(500, 40, 36), dtype="float32", order="F", frame_range=500,
                   blocks=(16, 16), noise=0.3)
CASES.update({
    "pixel_weighting": dict(OPTION_BASE, pixel_weighting=True),
    "max_failures_1": dict(OPTION_BASE, max_consecutive_failures=1, thresholds="jax"),
    "max_failures_2": dict(OPTION_BASE, max_consecutive_failures=2, thresholds="jax"),
    "frame_batch_size": dict(OPTION_BASE, frame_batch_size=128, thresholds="jax"),
    # T is not the crop's 500: the background rSVD's sketch is (T, k) for
    # T <= 1000, and _port_draws tells the rank-prune matrix by its rows
    "rank_prune_factor": dict(OPTION_BASE, shape=(600, 40, 36), rank_prune=True,
                              rank_prune_factor=0.5),
    "sim_conf": dict(OPTION_BASE, sim_conf=10.0, sim_iters=24, thresholds="injected"),
})
MULTI_WINDOW = [name for name, case in CASES.items() if "window_chunks" in case]
SETTINGS = dict(max_components=6, background_rank=2, temporal_avg_factor=5, seed=0)
OPTIONS = ("max_consecutive_failures", "frame_batch_size", "rank_prune_factor", "sim_conf",
           "sim_iters")


def _movie(case):
    movie = make_low_rank_movie(
        4, case["shape"], rng=np.random.default_rng(3), noise=case.get("noise", 1e-4)
    )
    if case["dtype"] == "uint16":
        movie = np.clip(np.rint(movie * 2000.0 + 500.0), 0, 65535).astype(np.uint16)
    return movie


def _sketch(shape):
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


def _port_draws(case):
    """The port's draws: the fixed sketch, and for ``rank_prune`` the JAX
    package's rank-prune matrix, recognized by its (crop frames, m) shape
    (so a rank-prune case's T must not equal its crop)."""
    if not case.get("rank_prune"):
        return _sketch
    import jax

    key = jax.random.PRNGKey(SETTINGS["seed"])
    for _ in range(3):
        key, sub = jax.random.split(key)
    crop = case["frame_range"] // SETTINGS["temporal_avg_factor"] * SETTINGS["temporal_avg_factor"]

    def draw(shape):
        if len(shape) == 2 and shape[0] == crop:
            return np.asarray(jax.random.normal(sub, tuple(shape)))
        return _sketch(shape)

    return draw


def _options(case):
    opts = dict(
        frame_range=case["frame_range"], order=case["order"],
        rank_prune=case.get("rank_prune", False), window_chunks=case.get("window_chunks"),
        **SETTINGS,
    )
    opts.update((k, case[k]) for k in OPTIONS if k in case)
    if case.get("pixel_weighting"):
        opts["pixel_weighting"] = np.random.default_rng(5).uniform(
            0.5, 2.0, case["shape"][1:]).astype(np.float32)
    return opts


def _jax_thresholds(case):
    """The JAX package's Monte-Carlo thresholds for the case's blocks and
    window (its own key tree: the first split of PRNGKey(seed))."""
    import jax

    from localmd_tpu.engine import threshold_heuristic

    _, sub = jax.random.split(jax.random.PRNGKey(SETTINGS["seed"]))
    dims = (*case["blocks"], case["window_chunks"])
    return tuple(float(x) for x in threshold_heuristic(dims, iters=250, key=sub))


def _run_jax(movie, case, monkeypatch, thresholds=(1e9, 1e9), seen=None):
    """``thresholds=None`` runs the JAX package's own Monte-Carlo (its cache
    emptied, so the injected sketch reaches it) and appends each call's
    arguments and thresholds to ``seen``."""
    import jax.numpy as jnp

    import localmd_tpu.engine as jax_engine
    import localmd_tpu.pipeline as jax_pipeline
    from localmd_tpu.ops.linalg import sketch_override

    if thresholds is None:
        real = jax_pipeline.threshold_heuristic

        def spy(*a, **k):
            seen.append((a, k, tuple(float(x) for x in real(*a, **k))))
            return seen[-1][2]

        monkeypatch.setattr(jax_engine, "_threshold_cache", {})
        monkeypatch.setattr(jax_pipeline, "threshold_heuristic", spy)
    else:
        monkeypatch.setattr(jax_pipeline, "threshold_heuristic", lambda *a, **k: thresholds)
    with sketch_override(lambda shape: jnp.asarray(_sketch(shape))):
        return jax_pipeline.localmd_decomposition(movie, case["blocks"], **_options(case))


def _jax_noise_blocks(call):
    """The simulated noise blocks of one JAX ``threshold_heuristic`` call, in
    its order: the first ``iters`` keys of its key tree (engine.py:920-922,
    955-957)."""
    import jax

    (dims,), kwargs, _ = call
    iters, sim_batch = kwargs["iters"], kwargs.get("sim_batch", 32)
    keys = jax.random.split(kwargs["key"], -(-iters // sim_batch) * sim_batch)[:iters]
    return np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], dims)) for k in keys])


def _inject_jax_noise(monkeypatch, call):
    """The port's Monte-Carlo draws the JAX package's noise blocks in order;
    its sketches stay the injected sketch."""
    import localmd_tpu_torch.engine as port_engine

    noise, dims, taken = _jax_noise_blocks(call), tuple(call[0][0]), [0]
    real = port_engine.normal

    def normal(shape, generator, device, batch=()):
        if tuple(shape) != dims:
            return real(shape, generator, device, batch)
        idx = (taken[0] + np.arange(batch[0])) % len(noise)   # past iters: dropped
        taken[0] += batch[0]
        return torch.as_tensor(noise[idx], device=device)

    monkeypatch.setattr(port_engine, "normal", normal)


def _run_port(movie, case, monkeypatch, thresholds=(1e9, 1e9), residual_calls=None, seen=None):
    """``thresholds=None`` runs the port's own Monte-Carlo and appends its
    thresholds to ``seen``."""
    import localmd_tpu_torch.engine as port_engine
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    if thresholds is None:
        real = port_pipeline.threshold_heuristic
        monkeypatch.setattr(port_pipeline, "threshold_heuristic",
                            lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    else:
        monkeypatch.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: thresholds)
    if residual_calls is not None:
        residual = port_engine.single_residual_block_md_batched
        monkeypatch.setattr(port_engine, "single_residual_block_md_batched",
                            lambda *a, **k: residual_calls.append(1) or residual(*a, **k))
    with sketch_override(_port_draws(case)):
        return port_pipeline.localmd_decomposition(
            movie, case["blocks"], device="cpu", **_options(case)
        )


@pytest.fixture(scope="module")
def runs():
    """Each case run once through both packages, shared by the tests."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, case in CASES.items():
            movie = _movie(case)
            thr = _jax_thresholds(case) if name in MULTI_WINDOW else (1e9, 1e9)
            calls, jax_seen, port_seen = [], [], []
            mode = case.get("thresholds")
            jax_pmd = _run_jax(movie, case, mp, None if mode else thr, jax_seen)
            if mode == "jax":
                thr = jax_seen[0][2]
            elif mode == "injected":
                _inject_jax_noise(mp, jax_seen[0])
                thr = None
            port_pmd = _run_port(movie, case, mp, thr, calls, port_seen)
            port_pmd.residual_calls = len(calls)
            port_pmd.thresholds = (jax_seen, port_seen)
            out[name] = (movie, jax_pmd, port_pmd)
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_live_jax_pipeline(name, runs):
    _, jax_pmd, port_pmd = runs[name]
    ref = jax_pmd[:, :, :]
    ours = port_pmd[:, :, :]
    assert ours.shape == ref.shape
    assert rel_fro(ours, ref) <= 1e-4
    np.testing.assert_allclose(port_pmd.var_img, jax_pmd.var_img, rtol=1e-4)
    np.testing.assert_allclose(
        port_pmd.mean_img, jax_pmd.mean_img, rtol=1e-4,
        atol=1e-5 * float(np.abs(jax_pmd.mean_img).max()),
    )
    assert port_pmd.rank == jax_pmd.rank
    assert port_pmd.pipeline_ranks == jax_pmd.pipeline_ranks


THRESHOLD_CASES = [name for name, case in CASES.items() if "thresholds" in case]


@pytest.mark.parametrize("name", THRESHOLD_CASES)
def test_option_cases_take_real_thresholds(name, runs):
    """The JAX package ran its own Monte-Carlo once with the case's
    ``sim_conf`` and ``sim_iters``; with the JAX draws injected the port's
    gives the same thresholds. The noisy movie leaves components for them to
    reject, so ``max_consecutive_failures`` decides something."""
    _, jax_pmd, port_pmd = runs[name]
    case = CASES[name]
    jax_seen, port_seen = port_pmd.thresholds
    assert len(jax_seen) == 1
    (_, kwargs, jax_thr) = jax_seen[0]
    assert kwargs["percentile_threshold"] == case.get("sim_conf", 5)
    assert kwargs["iters"] == case.get("sim_iters", 250)
    if case["thresholds"] == "injected":
        assert len(port_seen) == 1
        np.testing.assert_allclose(port_seen[0], jax_thr, rtol=1e-4)
    from localmd_tpu_torch.ops.tiling import BlockGrid

    n_blocks = BlockGrid(*case["shape"][1:], case["blocks"]).n_blocks
    assert jax_pmd.pipeline_ranks["blockwise"] < SETTINGS["max_components"] * n_blocks


def test_max_consecutive_failures_keeps_more_with_two(runs):
    ones, twos = (runs[name][2].pipeline_ranks["blockwise"]
                  for name in ("max_failures_1", "max_failures_2"))
    assert ones <= twos


@pytest.mark.parametrize("name", MULTI_WINDOW)
def test_multi_window_runs_residual_windows(name, runs):
    """The multi-window cases are not decided in window 0: residual windows
    run (at least one), and the loop stops at the last window or once every
    block is full."""
    _, _, port_pmd = runs[name]
    windows = port_pmd.pipeline_windows
    assert windows["n_windows"] == 4
    assert port_pmd.residual_calls >= 1
    assert port_pmd.residual_calls == sum(r - 1 for r in windows["run_per_batch"])
    if max(windows["run_per_batch"]) < windows["n_windows"]:     # stopped early
        assert port_pmd.pipeline_ranks["blockwise"] == SETTINGS["max_components"] * 20


@pytest.mark.parametrize("name", list(CASES))
def test_reconstruct_frames_matches_slicing(name, runs):
    movie, _, port_pmd = runs[name]
    frames = [0, 5, movie.shape[0] - 1]
    dev = to_np(port_pmd.reconstruct_frames(frames))
    host = port_pmd[frames, :, :]
    np.testing.assert_allclose(dev, host, rtol=1e-4, atol=1e-4 * float(np.abs(host).max()))
    assert set(port_pmd.pipeline_timings) == {
        "stats_and_background", "thresholds", "block_decomposition",
        "factorized_svd", "v_regression", "final_reformat",
    }


def test_stats_tail_below_min_noise_frames_is_mean_only(runs):
    """T = 1100: the 76-frame tail adds to the mean but not to sigma."""
    from localmd_tpu_torch.loader import MIN_NOISE_FRAMES, _chunk_ranges

    movie, jax_pmd, port_pmd = runs["tail_1100"]
    assert _chunk_ranges(1100, 1024, merge_tail=False)[-1] == (1024, 1100)
    assert 1100 - 1024 < MIN_NOISE_FRAMES
    np.testing.assert_allclose(
        port_pmd.mean_img, movie.mean(axis=0, dtype=np.float64), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(port_pmd.var_img, jax_pmd.var_img, rtol=1e-4)


def _reference_state(pmd):
    u = pmd._blocksparse
    return dict(
        panels=np.asarray(u.panels), rows=np.asarray(u.rows),
        dense_basis=np.asarray(u.dense_basis), starts=np.asarray(u.starts),
        block_shape=u.block_shape, counts=np.asarray(pmd._counts),
        r=np.asarray(pmd._r_padded), s=np.asarray(pmd._s_src), v=np.asarray(pmd._v_src),
        k2_keep=pmd._k2_keep, mean_img=pmd.mean_img, std_img=pmd.var_img, order=pmd.order,
    )


@pytest.mark.parametrize("name", ["order_c", "uint16"])
def test_from_reference_state_reconstructs_identical_factors(name, runs):
    from localmd_tpu_torch import PMDArray

    _, jax_pmd, _ = runs[name]
    port = PMDArray.from_reference_state(_reference_state(jax_pmd), device="cpu")
    ref = np.asarray(jax_pmd.reconstruct_frames(np.arange(jax_pmd.shape[0])))
    assert rel_fro(to_np(port.reconstruct_frames(np.arange(port.shape[0]))), ref) <= 1e-5
    assert rel_fro(port[:, :, :], jax_pmd[:, :, :]) <= 1e-5
    assert rel_fro(port[10:20, 3:40, 5], jax_pmd[10:20, 3:40, 5]) <= 1e-5
    assert port.rank == jax_pmd.rank


def test_npz_round_trips_between_packages(runs, tmp_path):
    from localmd_tpu import load_decomposition as jax_load
    from localmd_tpu_torch import load_decomposition as port_load

    _, jax_pmd, port_pmd = runs["order_c"]
    jax_file = str(tmp_path / "jax.npz")
    jax_pmd.to_npz(jax_file)
    from_jax = port_load(jax_file, device="cpu")
    assert rel_fro(from_jax[:, :, :], jax_pmd[:, :, :]) <= 1e-5
    port_file = str(tmp_path / "port.npz")
    port_pmd.to_npz(port_file)
    assert rel_fro(jax_load(port_file)[:, :, :], port_pmd[:, :, :]) <= 1e-5
    assert rel_fro(port_load(port_file, device="cpu")[:, :, :], port_pmd[:, :, :]) <= 1e-5


@pytest.mark.parametrize("kwargs", [dict(mesh=object())])
def test_unsupported_options_raise(kwargs, monkeypatch):
    """A mesh that is not a 1-D DeviceMesh over every rank raises before
    any work (the statistics pass never starts)."""
    from localmd_tpu_torch import localmd_decomposition
    from localmd_tpu_torch.loader import PMDLoader

    stats = []
    monkeypatch.setattr(PMDLoader, "_run_stats_with_oom_retry", lambda self: stats.append(1))
    movie = np.zeros((300, 20, 20), np.float32)
    with pytest.raises((TypeError, ValueError)):
        localmd_decomposition(movie, (10, 10), frame_range=300, device="cpu", **kwargs)
    assert not stats


def test_tensor_input_matches_numpy_input(runs):
    movie, _, port_pmd = runs["uint16"]
    case = CASES["uint16"]
    mp = pytest.MonkeyPatch()
    try:
        again = _run_port(torch.from_numpy(movie), case, mp)
    finally:
        mp.undo()
    assert rel_fro(again[:, :, :], port_pmd[:, :, :]) <= 1e-6
