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
identical factors reconstruct to 1e-5.

The cases live in ``tests/torch_parity_cases.py`` and the JAX side runs as
``tests/golden/generate_torch_parity.py`` runs it, whose committed results
``chip_smoke.py`` phase 14 holds the card to: the JAX run here remakes
each fixture (1e-6), and the port's run here meets it at the bars above
(``tests/test_torch_card_parity.py`` does the same for the other cases)."""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_util import assert_fixture_is_current, assert_port_meets_fixture, rel_fro, to_np

import torch_parity_cases as parity

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden"))
import generate_torch_parity as generator  # noqa: E402

CASES = {name: parity.CASES[name] for name in parity.PIPELINE_CASES}
MULTI_WINDOW = [name for name in CASES if name in parity.MULTI_WINDOW]
SETTINGS = parity.SETTINGS


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


def _run_port(movie, name, monkeypatch, thresholds=(1e9, 1e9), residual_calls=None, seen=None,
              prune_matrix=None):
    """``thresholds=None`` runs the port's own Monte-Carlo and appends its
    thresholds to ``seen``; ``prune_matrix`` is a ``rank_prune`` case's
    draw from the JAX key tree."""
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
    with sketch_override(parity.draws(name, prune_matrix)):
        return port_pipeline.localmd_decomposition(
            movie, CASES[name]["blocks"], device="cpu", **parity.options(name)
        )


@pytest.fixture(scope="module")
def runs():
    """Each case run once through both packages, shared by the tests: the
    JAX package as ``tests/golden/generate_torch_parity.py`` runs it, the
    port pinned to the thresholds the JAX run took (or, for ``sim_conf``,
    running its own Monte-Carlo on the JAX package's draws)."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, case in CASES.items():
            movie = parity.movie(name)
            calls, port_seen = [], []
            jax_pmd, record = generator.run_jax(name, movie)
            thr = record["thresholds"]
            if case.get("thresholds") == "injected":
                _inject_jax_noise(mp, record["seen"][0])
                thr = None
            prune = generator.prune_matrix(name, jax_pmd.pipeline_ranks)
            port_pmd = _run_port(movie, name, mp, thr, calls, port_seen, prune)
            port_pmd.residual_calls = len(calls)
            port_pmd.thresholds = (record["seen"], port_seen)
            jax_pmd.record, jax_pmd.prune_matrix = record, prune
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


@pytest.mark.parametrize("name", list(CASES))
def test_committed_fixture_is_the_jax_result(name, runs):
    _, jax_pmd, _ = runs[name]
    assert_fixture_is_current(name, jax_pmd, jax_pmd.record["thresholds"], jax_pmd.prune_matrix)


@pytest.mark.parametrize("name", list(CASES))
def test_port_meets_committed_fixture(name, runs):
    assert_port_meets_fixture(name, runs[name][2])


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
    mp = pytest.MonkeyPatch()
    try:
        again = _run_port(torch.from_numpy(movie), "uint16", mp)
    finally:
        mp.undo()
    assert rel_fro(again[:, :, :], port_pmd[:, :, :]) <= 1e-6
