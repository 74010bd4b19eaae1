"""The machinery by which ``chip_smoke.py`` phase 15 holds the card to the
JAX package at the main path's full width (bench.py's configuration on a
512 x 512 x 2048 movie, ``tests/torch_parity_full.py``):

(a) the movie built in frame chunks is the whole-array construction of
    ``tests/torch_parity_cases.py`` and ``conftest.make_low_rank_movie``,
    bit for bit, and the case is bench.py's configuration;
(b) the fingerprint (the reconstruction through fixed Gaussian probes)
    estimates the relative Frobenius error of the whole reconstruction:
    the port against the JAX package on the committed ``regular_48``
    fixture, and a perturbation of known size;
(c) the committed fixtures under ``tests/golden/torch_parity_full/`` have
    their keys, shapes and dtypes, within their byte budget;
(d) the bars and the fp32-tie rule are phase 15's own functions,
    imported from ``chip_smoke``, and its decision seam reaches the blocks
    it names.

The slow tests carry the full width itself: the committed fixture is what
the JAX package computes now, and the port on the CPU meets it at phase
15's bars, through phase 15's own per-run check."""

import ast
import inspect
import json
import os

import numpy as np
import pytest

import torch_parity_cases as cases
import torch_parity_full as full
from _torch_util import parity_draws, parity_records, rel_fro
from chip_smoke import (
    FULL_DIR, FULL_RUNS, FULL_TIE_RTOL, FULL_TOL, PARITY_DIR, block_flips, block_spy,
    describe_flip, full_fixtures, full_width_check, full_width_misses, parity_run,
    phase_full_width,
)
from conftest import make_low_rank_movie

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET_BYTES = 10_000_000
SMALL = (300, 24, 20)


@pytest.mark.parametrize("chunk", [1, 7, 256])
@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_chunked_movie_is_the_whole_construction(dtype, chunk):
    whole = cases.make_low_rank_movie(4, SMALL, rng=np.random.default_rng(full.MOVIE_SEED),
                                      noise=full.NOISE)
    conftest_movie = make_low_rank_movie(4, SMALL, rng=np.random.default_rng(full.MOVIE_SEED),
                                         noise=full.NOISE)
    assert np.array_equal(whole, conftest_movie)
    if dtype == "uint16":
        whole = cases.to_uint16(whole)
    got = full.low_rank_movie(SMALL, dtype, chunk=chunk)
    assert got.dtype == np.dtype(dtype)
    assert np.array_equal(got, whole)


def test_uint16_case_converts_the_float32_movie_chunk_by_chunk():
    """Phase 15 makes the uint16 movie from the float32 one, 256 frames at
    a time: the conversion is elementwise, so it is the case's movie."""
    f32 = full.low_rank_movie(SMALL, "float32")
    u16 = np.concatenate([full.convert("uint16", f32[lo:lo + 256]) for lo in range(0, SMALL[0], 256)])
    assert np.array_equal(u16, full.low_rank_movie(SMALL, "uint16"))


def _bench_call():
    """bench.py's ``localmd_decomposition`` keywords and ``run_once``'s
    defaults, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    run_once = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_once")
    call = next(n for n in ast.walk(run_once) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "localmd_decomposition")
    defaults = {a.arg: ast.literal_eval(d) for a, d in
                zip(run_once.args.args[-len(run_once.args.defaults):], run_once.args.defaults)}
    keywords = {}
    for kw in call.keywords:
        if isinstance(kw.value, ast.Name):
            keywords[kw.arg] = defaults.get(kw.value.id, kw.value.id)
        else:
            keywords[kw.arg] = ast.literal_eval(kw.value)
    return keywords, defaults


def test_full_case_is_bench_configuration():
    keywords, defaults = _bench_call()
    keywords.pop("matmul_precision")
    opts = dict(full.OPTIONS)
    assert opts.pop("order") == "F"
    assert opts == keywords
    assert tuple(defaults["blocks"]) == full.BLOCKS
    for case in full.FULL_CASES.values():
        assert case["shape"] == (2048, 512, 512) and case["blocks"] == full.BLOCKS
    assert [case["dtype"] for case in full.FULL_CASES.values()] == ["float32", "uint16"]
    assert full.crop_frames() == 1020
    assert full.prune_shape({"pre_reduction": 13880}) == (1020, 336)


def test_draws_give_the_prune_matrix_by_its_shape_and_the_sketch_elsewhere():
    prune = np.arange(12, dtype=np.float32).reshape(3, 4)
    draw = full.draws(prune)
    assert draw((3, 4)) is prune
    assert np.array_equal(draw((3, 5)), cases.sketch((3, 5)))
    assert np.array_equal(draw((102, 30)), cases.sketch((102, 30)))


@pytest.mark.parametrize("max_failures", [1, 2, 3])
def test_kept_counts_follow_the_failure_filter(max_failures):
    from localmd_tpu_torch.ops.roughness import filter_by_failures_np

    rng = np.random.default_rng(max_failures)
    spatial, temporal = rng.uniform(0, 2, (200, 20)), rng.uniform(0, 3, (200, 20))
    thresholds = (1.7, 2.6)
    keep = full.keep_decisions(spatial, temporal, thresholds)
    want = [int(filter_by_failures_np(row, max_failures).sum()) for row in keep]
    assert full.kept_counts(spatial, temporal, thresholds, max_failures).tolist() == want


def test_fingerprint_is_chunk_independent_and_linear():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((1100, 12, 10)).astype(np.float32)
    whole = full.fingerprint(lambda lo, hi: y[lo:hi], y.shape)
    small = full.fingerprint(lambda lo, hi: y[lo:hi], y.shape, chunk=37)
    for key in ("psi_y", "y_omega"):
        np.testing.assert_allclose(small[key], whole[key], rtol=1e-12, atol=1e-12)
    probe = full.probes(y.shape)
    assert set(probe) == {"psi", "omega"}                   # no temporal probe up to 4096 frames
    psi, omega = probe["psi"], probe["omega"]
    flat = y.reshape(y.shape[0], -1).astype(np.float64)        # (T, pixels), C order
    np.testing.assert_allclose(whole["psi_y"], psi.T @ flat.T, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(whole["y_omega"], flat.T @ omega, rtol=1e-10, atol=1e-9)
    assert whole["psi_y"].shape == (full.PROBES, 1100) and whole["y_omega"].shape == (120,)
    with pytest.raises(ValueError):
        full.fingerprint(lambda lo, hi: y[lo:hi, :6], y.shape)


@pytest.fixture(scope="module")
def regular_48():
    """The port on the CPU on the committed ``regular_48`` case, through
    phase 14's runner, and the JAX package's stored frames."""
    from localmd_tpu_torch import load_decomposition

    pmd = parity_run("regular_48", "cpu", parity_records(), parity_draws())
    ref = load_decomposition(os.path.join(PARITY_DIR, "regular_48.npz"), device=None)
    return pmd.reconstruct_frames(np.arange(pmd.shape[0])).numpy(), ref[:, :, :]


def _fingerprint_error(got, want):
    fp = [full.fingerprint(lambda lo, hi, y=y: y[lo:hi], y.shape) for y in (got, want)]
    return full.fingerprint_errors(*fp)["psi_y"]


def test_fingerprint_estimates_the_port_error(regular_48):
    got, want = regular_48
    true = rel_fro(got, want)
    assert 0 < true < 1e-4
    assert 0.8 <= _fingerprint_error(got, want) / true <= 1.25


@pytest.mark.parametrize("size", [1e-5, 1e-3])
def test_fingerprint_estimates_a_known_perturbation(regular_48, size):
    _, want = regular_48
    noise = np.random.default_rng(2).standard_normal(want.shape)
    got = (want + size * np.linalg.norm(want) / np.linalg.norm(noise) * noise).astype(np.float32)
    true = rel_fro(got, want)
    assert abs(true / size - 1) < 0.05
    assert 0.8 <= _fingerprint_error(got, want) / true <= 1.25


def test_committed_fixtures_have_their_keys_shapes_and_budget():
    names = set(os.listdir(FULL_DIR))
    assert names == {f"{name}.npz" for name in full.FULL_CASES} | {"cases.json", "draws.npz"}
    assert sum(os.path.getsize(os.path.join(FULL_DIR, n)) for n in names) <= BUDGET_BYTES
    records, prune, refs = full_fixtures()
    assert list(records) == list(full.FULL_CASES)
    t, d1, d2 = full.SHAPE
    n_blocks = (d1 // 16 - 1) * (d2 // 16 - 1)
    for name, record in records.items():
        assert set(record) == {"pipeline_ranks", "rank", "thresholds", "seconds"}
        ranks = record["pipeline_ranks"]
        assert set(ranks) == {"blockwise", "pre_reduction", "reduced", "final"}
        assert record["rank"] == ranks["final"] == ranks["reduced"] == 336
        assert prune.shape == full.prune_shape(ranks) and prune.dtype == np.float32
        ref = refs[name]
        stats = ((n_blocks, full.OPTIONS["max_components"]), np.float32)
        want = dict(s=((record["rank"],), np.float32), mean_img=((d1, d2), np.float32),
                    var_img=((d1, d2), np.float32), psi_y=((full.PROBES, t), np.float32),
                    y_omega=((d1 * d2,), np.float32), block_counts=((n_blocks,), np.int16),
                    block_spatial=stats, block_temporal=stats)
        assert {k: (v.shape, v.dtype) for k, v in ref.items()} == want
        assert int(ref["block_counts"].sum()) == ranks["blockwise"]
        assert np.array_equal(full.kept_counts(ref["block_spatial"], ref["block_temporal"],
                                               record["thresholds"]), ref["block_counts"])
        assert np.all(np.isfinite(ref["psi_y"])) and np.all(np.diff(ref["s"]) <= 0)
    assert set(np.load(os.path.join(FULL_DIR, "draws.npz")).files) == {"prune"}
    with open(os.path.join(FULL_DIR, "cases.json")) as f:
        assert json.load(f) == records


def _record():
    return dict(pipeline_ranks=dict(blockwise=10, pre_reduction=12, reduced=4, final=4), rank=4)


def _errors(**changes):
    err = dict(psi_y=5e-6, y_omega=5e-6, s=5e-6, mean=1e-6, var=1e-6)
    err.update(changes)
    return err


@pytest.mark.parametrize("key,name", [("psi_y", "fingerprint psi_y"),
                                      ("y_omega", "fingerprint y_omega"), ("s", "s"),
                                      ("mean", "mean_img"), ("var", "var_img")])
def test_bars_flag_each_error_past_its_bound(key, name):
    record = _record()
    assert full_width_misses(_errors(**{key: 0.99e-4}), record["pipeline_ranks"], 4, record) == []
    assert full_width_misses(_errors(**{key: 1.01e-4}), record["pipeline_ranks"], 4, record) == [name]
    assert full_width_misses(_errors(**{key: float("nan")}), record["pipeline_ranks"], 4,
                             record) == [name]


def test_bars_flag_ranks_and_an_infinite_error():
    record = _record()
    ranks = dict(record["pipeline_ranks"], blockwise=11)
    assert full_width_misses(_errors(), ranks, 4, record) == ["pipeline_ranks"]
    assert full_width_misses(_errors(), record["pipeline_ranks"], 5, record) == ["kept rank"]
    assert full_width_misses(_errors(s=float("inf")), record["pipeline_ranks"], 4, record) == ["s"]


def test_phase_15_uses_these_bars_on_every_run():
    """The card and the CPU share one definition: phase 15 runs each of its
    three runs through ``full_width_check``, which calls the functions this
    file tests."""
    assert "full_width_check(" in inspect.getsource(phase_full_width)
    source = inspect.getsource(full_width_check)
    for fn in ("full_run(", "full_width_errors(", "full_width_misses(", "block_flips("):
        assert fn in source
    assert FULL_TOL == 1e-4 and FULL_TIE_RTOL == 1e-4
    assert FULL_RUNS == (("full_512_f32", "auto"), ("full_512_f32", False),
                         ("full_512_u16", "auto"))


def _stats(n=4, r=5):
    return np.full((n, r), 1.0, np.float32), np.full((n, r), 2.0, np.float32)


THRESHOLDS = (1.3797695636749268, 2.3503828048706055)


def test_a_flip_at_an_fp32_tie_is_named_a_tie():
    """Block 2's component 3: the port's temporal statistic 2.2e-5 below
    the threshold, the JAX package's 6.5e-6 above (block 479 of the uint16
    full-width case on the card)."""
    port, jax = _stats(), _stats()
    port[1][2, 3] = np.float32(THRESHOLDS[1] * (1 - 2.2e-5))
    jax[1][2, 3] = np.float32(THRESHOLDS[1] * (1 + 6.5e-6))
    port_counts, jax_counts = (full.kept_counts(*st, THRESHOLDS) for st in (port, jax))
    assert port_counts.tolist() == [5, 5, 5, 5] and jax_counts.tolist() == [5, 5, 4, 5]
    (flip,) = block_flips(port, jax, THRESHOLDS, port_counts, jax_counts)
    assert (flip["block"], flip["component"], flip["jax_keeps"], flip["tie"]) == (2, 3, False, True)
    assert set(flip["kinds"]) == {"temporal"}
    starts = np.array([[0, 0], [0, 16], [16, 0], [16, 16]])
    assert "block 2 at (16, 0): kept 5, JAX 4; component 3, temporal" in describe_flip(flip, starts)
    assert describe_flip(flip, starts).endswith("an fp32 tie")


@pytest.mark.parametrize("port_side,jax_side", [(1 - 2e-4, 1 + 1e-6), (1 - 1e-6, 1 + 2e-4),
                                                (0.9, 1.1)])
def test_a_flip_past_the_tie_tolerance_is_not_a_tie(port_side, jax_side):
    port, jax = _stats(), _stats()
    port[0][1, 0] = np.float32(THRESHOLDS[0] * port_side)
    jax[0][1, 0] = np.float32(THRESHOLDS[0] * jax_side)
    counts = [full.kept_counts(*st, THRESHOLDS) for st in (port, jax)]
    (flip,) = block_flips(port, jax, THRESHOLDS, *counts)
    assert flip["component"] == 0 and set(flip["kinds"]) == {"spatial"} and not flip["tie"]
    assert "NOT a tie" in describe_flip(flip, np.zeros((4, 2), int))


def test_counts_that_differ_without_a_differing_decision_are_not_a_tie():
    port, jax = _stats(), _stats()
    (flip,) = block_flips(port, jax, THRESHOLDS, np.array([5, 5, 5, 5]), np.array([5, 4, 5, 5]))
    assert flip["component"] is None and not flip["tie"]


def test_decision_seam_replaces_the_named_component(monkeypatch):
    """``block_spy``'s overrides reach the block and component they name
    (block order on the CPU's gathered batches): with every component kept
    (thresholds pinned high), one replaced failure ends its block there."""
    from localmd_tpu_torch.ops.tiling import block_grid

    case = cases.CASES["regular_48"]
    n_blocks = block_grid(*case["shape"][1:], case["blocks"]).n_blocks
    records = parity_records()
    with block_spy() as plain:
        parity_run("regular_48", "cpu", records, parity_draws())
    with block_spy(np.arange(n_blocks), {(2, 1): False}) as forced:
        parity_run("regular_48", "cpu", records, parity_draws())
    assert forced["forced"] == 1
    want = plain["counts"].copy()
    want[2] = 2
    assert plain["counts"][2] > 2 and np.array_equal(forced["counts"], want)


@pytest.mark.slow
def test_full_fixture_is_current():
    """Slow (about 90 s and 11 GB on a CPU): remakes
    ``full_512_f32`` from the JAX package at full width and holds the
    committed arrays to it (1e-6)."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    import generate_torch_parity_full as generate

    name = "full_512_f32"
    pmd, record = generate.run_jax(name)
    remade = generate.fixture_of(pmd, record)
    records, prune, refs = full_fixtures()
    for key in ("s", "mean_img", "var_img", "psi_y", "y_omega", "block_spatial", "block_temporal"):
        assert rel_fro(remade[key], refs[name][key]) <= 1e-6, key
    assert np.array_equal(remade["block_counts"], refs[name]["block_counts"])
    assert generate.record_of(pmd, record)["pipeline_ranks"] == records[name]["pipeline_ranks"]
    assert pmd.rank == records[name]["rank"]
    np.testing.assert_allclose(record["thresholds"], records[name]["thresholds"], rtol=1e-6)
    assert np.array_equal(record["prune"], prune)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(full.FULL_CASES))
def test_port_on_the_cpu_meets_the_full_fixture(name):
    """Slow (about 100 s and 10 GB on a CPU a run; uint16 runs twice, its
    fp32 tie given the JAX package's decision): the port at full width on
    the CPU, through phase 15's own per-run check, meets the committed JAX
    result at phase 15's bars."""
    records, prune, refs = full_fixtures()
    result = full_width_check(name, "auto", "cpu", full.movie(name), records[name], prune,
                              refs[name])
    assert result["misses"] == [], result
    assert all(flip["tie"] for flip in result["ties"])
