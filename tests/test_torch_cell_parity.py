"""The machinery by which ``chip_smoke.py`` phase 16 holds the card to the
JAX package on the other three cells ``bench_torch.py`` times, at full width
(``tests/torch_parity_cells.py``: voltage_f32, 1024_u16, northstar_u16):

(a) the chunked, threaded movie construction gives the same bytes whatever
    the thread count or the frames a caller asks for, in memory and in a
    raw file, and each case is its ``bench_torch.py`` cell;
(b) the fingerprint with its temporal probe (T > 4096) still estimates the
    relative Frobenius error of the whole reconstruction, and phase 16's
    float64 fingerprint through ``reconstruct_frames`` is the host's;
(c) the committed fixtures under ``tests/golden/torch_parity_cells/`` have
    their keys, shapes and dtypes within their 12 MB budget, and their
    statistics give their counts window by window;
(d) the JAX generator's per-window statistics give the per-window counts,
    the port's decision seam reaches the (window, block, component) it
    names, a snapped grid's coset order maps its rows to their blocks, and
    phase 16 uses phase 15's bars and tie rule;
(e) phase 16's per-run check, on the CPU, holds the port to a small
    multi-window float32 case and a small uint16 raw-file case made by the
    generator's own functions.

The slow tests run the port at full width on the CPU against the committed
fixtures through phase 16's own per-run check."""

import ast
import inspect
import json
import os
import sys

import numpy as np
import pytest

import torch_parity_cases as cases
import torch_parity_cells as cells
import torch_parity_full as full
from _torch_util import rel_fro
from chip_smoke import (
    CELL_ATTEMPTS, CELL_RUNS, CELLS_DIR, FULL_TIE_RTOL, FULL_TOL, OPEN_CELLS, block_order,
    block_spy, card_fingerprint, cell_arrays, cell_check, cell_fixtures, describe_flip,
    describe_gram_flip, eigen_cut, eigen_cut_spy, full_width_errors, full_width_misses, gram_flip,
    parity_run, phase_cells, window_flips, window_stats,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
BUDGET_BYTES = 12_000_000
CASE_BYTES = 4_000_000


def _generator():
    sys.path.insert(0, GOLDEN)
    import generate_torch_parity_cells

    return generate_torch_parity_cells


# ---------------------------------------------------------------------------
# (a) the movie and the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("threads", [1, 3, 8])
def test_movie_bytes_do_not_depend_on_threads_or_chunks(dtype, threads):
    shape = (150, 20, 18)
    whole = cells.Movie(shape, dtype, threads=1).array()
    mov = cells.Movie(shape, dtype, threads=threads)
    assert whole.dtype == np.dtype(dtype) and whole.shape == shape
    assert np.array_equal(mov.array(), whole)
    for lo, hi in ((0, 1), (5, 37), (31, 33), (32, 64), (100, 150), (149, 150), (7, 7)):
        assert np.array_equal(mov.frames(lo, hi), whole[lo:hi]), (lo, hi)
    pieces = np.concatenate([mov.frames(lo, min(150, lo + 23)) for lo in range(0, 150, 23)])
    assert np.array_equal(pieces, whole)
    with pytest.raises(IndexError):
        mov.frames(140, 151)


def test_uint16_movie_is_the_float32_movie_converted():
    shape = (70, 16, 12)
    f32 = cells.Movie(shape, "float32").array()
    assert np.array_equal(cells.Movie(shape, "uint16").array(), cases.to_uint16(f32))
    # the rank-4 signal under noise 0.3, as torch_parity_full's construction
    spatial, temporal = cells.factors(shape)
    clean = (temporal.T.astype(np.float64) @ spatial).reshape(shape)
    assert abs(np.std(f32 - clean) - cells.NOISE) < 0.01


def test_raw_file_holds_the_movie(tmp_path):
    mov = cells.Movie((90, 14, 12), "uint16", threads=2)
    path = str(tmp_path / "movie.raw")
    built, written = mov.write(path, frames_per_write=40)
    assert built >= 0 and written >= 0
    assert np.array_equal(np.fromfile(path, np.uint16).reshape(mov.shape), mov.array())
    with pytest.raises(RuntimeError, match="free"):
        cells.check_disk(str(tmp_path), 1e18)


def test_digest_sees_the_first_and_last_chunks():
    shape = (100, 8, 6)
    a, b = cells.Movie(shape), cells.Movie(shape, seed=4)
    assert cells.digest(a) == cells.digest(cells.Movie(shape, threads=1))
    assert cells.digest(a) != cells.digest(b)
    assert cells.digest(a) != cells.digest(cells.Movie(shape, "uint16"))


def _bench_cells():
    """bench_torch.py's cells as (shape, dtype, blocks, options)."""
    import bench_torch

    out = {}
    for name, (d1, d2, t, dtype, settings) in bench_torch.CELLS.items():
        settings = dict(settings)
        blocks = settings.pop("blocks", bench_torch.BLOCKS)
        out[name] = ((t, d1, d2), dtype, tuple(blocks), {**bench_torch.MAIN_CONFIG, **settings})
    for name, dtype in bench_torch.NORTHSTAR_CELLS.items():
        out[name] = (bench_torch.NORTHSTAR_SHAPE, dtype, tuple(bench_torch.NORTHSTAR_BLOCKS),
                     dict(bench_torch.NORTHSTAR_CONFIG))
    return out


def test_cases_are_the_bench_torch_cells():
    bench = _bench_cells()
    assert cells.BASE == __import__("bench_torch").MAIN_CONFIG
    for name, case in cells.CELL_CASES.items():
        assert (case["shape"], case["dtype"], case["blocks"], cells.options(name)) == bench[name], name
    # the timed cells the fixtures do not hold are phase 15's and the int16
    # reading of the north star's file
    assert set(bench) - set(cells.CELL_CASES) == {"512_f32", "northstar_i16"}
    shape, dtype, blocks, opts = bench["512_f32"]
    assert (shape, blocks) == (full.SHAPE, full.BLOCKS)
    assert {k: v for k, v in full.OPTIONS.items() if k not in ("order", "block_batch_size")} == opts
    assert [case["source"] for case in cells.CELL_CASES.values()] == ["memory", "memory", "raw"]
    assert sorted(CELL_RUNS + OPEN_CELLS) == sorted(cells.CELL_CASES)


def test_grid_and_windows_are_the_port_s():
    from localmd_tpu_torch import engine
    from localmd_tpu_torch.ops.tiling import block_grid

    want = {"voltage_f32": (225, 2, 4000), "1024_u16": (2601, 1, 510),
            "northstar_u16": (961, 1, 4090)}
    for name, case in cells.CELL_CASES.items():
        _, d1, d2 = case["shape"]
        opts = cells.options(name)
        crop = cells.crop_frames(name)
        wl = engine.effective_window_length(opts.get("window_chunks") or crop, crop,
                                            opts["temporal_avg_factor"])
        assert cells.n_blocks(name) == block_grid(d1, d2, case["blocks"]).n_blocks
        assert cells.n_windows(name) == engine.window_count(crop, wl)
        assert (cells.n_blocks(name), cells.n_windows(name), crop) == want[name]


# ---------------------------------------------------------------------------
# (b) the fingerprint
# ---------------------------------------------------------------------------

LONG = (4200, 10, 8)        # T past PHI_FROM_T: the temporal probe


def _low_rank(shape, rank, seed):
    rng = np.random.default_rng(seed)
    t, d1, d2 = shape
    return (rng.standard_normal((t, rank)) @ rng.standard_normal((rank, d1 * d2))).reshape(shape)


def test_long_fingerprint_is_psi_y_through_phi():
    y = _low_rank(LONG, 6, 0).astype(np.float32)
    fp = full.fingerprint(lambda lo, hi: y[lo:hi], LONG)
    assert set(fp) == {"psi_y_phi", "y_omega"}
    probe = cells.probes(LONG)
    flat = y.reshape(LONG[0], -1).astype(np.float64)
    np.testing.assert_allclose(fp["psi_y_phi"], probe["psi"].T @ flat.T @ probe["phi"],
                               rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(fp["y_omega"], flat.T @ probe["omega"], rtol=1e-9, atol=1e-9)
    assert fp["psi_y_phi"].shape == (full.PROBES, full.PHI_COLUMNS)
    short = full.fingerprint(lambda lo, hi: y[lo:hi], (4096, 10, 8))
    assert set(short) == {"psi_y", "y_omega"}


@pytest.mark.parametrize("kind", ["gaussian", "rank_1", "rank_8", "one_frame_block"])
@pytest.mark.parametrize("size", [1e-5, 1e-3])
def test_temporal_probe_estimates_a_known_perturbation(kind, size):
    """psi^T Y Phi estimates ||Y1 - Y2||_F / ||Y2||_F within [0.8, 1.25],
    for a white perturbation, low-rank ones, and one held in a few frames."""
    want = (_low_rank(LONG, 4, 1) + 0.3 * np.random.default_rng(2).standard_normal(LONG))
    rng = np.random.default_rng(3)
    if kind == "gaussian":
        noise = rng.standard_normal(LONG)
    elif kind == "one_frame_block":
        noise = np.zeros(LONG)
        noise[1000:1040] = rng.standard_normal((40,) + LONG[1:])
    else:
        noise = _low_rank(LONG, int(kind.split("_")[1]), 4)
    got = want + size * np.linalg.norm(want) / np.linalg.norm(noise) * noise
    true = rel_fro(got, want)
    fp = [full.fingerprint(lambda lo, hi, y=y: y[lo:hi], LONG) for y in (got, want)]
    ratio = full.fingerprint_errors(*fp)["psi_y_phi"] / true
    assert 0.8 <= ratio <= 1.25, ratio


class _Frames:
    """A stand-in PMDArray: ``reconstruct_frames`` of a fixed array, as a
    CPU tensor."""

    def __init__(self, y):
        self.y, self.shape = y, y.shape

    def reconstruct_frames(self, idx):
        import torch

        return torch.from_numpy(self.y[np.asarray(idx)])


@pytest.mark.parametrize("shape,sample,chunk", [((300, 10, 8), False, 70), (LONG, False, 70),
                                                ((300, 24, 20), True, 70),
                                                ((1100, 12, 10), False, full.FINGERPRINT_CHUNK)])
def test_card_fingerprint_is_the_host_fingerprint(monkeypatch, shape, sample, chunk):
    """Phases 15 and 16 read the fingerprint on the run's device; it is the
    host's one (``torch_parity_full.fingerprint``), whatever the chunk."""
    if sample:
        monkeypatch.setattr(full, "SAMPLE_FROM_PIXELS", 256)
        monkeypatch.setattr(full, "SAMPLE_PIXELS", 100)
    y = _low_rank(shape, 5, 6).astype(np.float32)
    probe = full.probes(shape)
    host = full.fingerprint(lambda lo, hi: y[lo:hi], shape, probe=probe)
    card = card_fingerprint(_Frames(y), probe, chunk=chunk)
    assert set(card) == set(host)
    for key in host:
        np.testing.assert_allclose(card[key], host[key], rtol=1e-10, atol=1e-8)
    assert len(card["y_omega"]) == (100 if sample else shape[1] * shape[2])


def test_pixel_sample_is_fixed_and_sorted():
    assert np.array_equal(cells.pixel_sample(512 * 512), np.arange(512 * 512))
    a = cells.pixel_sample(1024 * 1024)
    assert len(a) == full.SAMPLE_PIXELS and np.all(np.diff(a) > 0) and a[-1] < 1024 * 1024
    assert np.array_equal(a, cells.pixel_sample(1024 * 1024))


# ---------------------------------------------------------------------------
# (c) the committed fixtures
# ---------------------------------------------------------------------------

def test_committed_fixtures_have_their_keys_shapes_and_budget():
    names = set(os.listdir(CELLS_DIR))
    assert names == {f"{name}.npz" for name in cells.CELL_CASES} | {"cases.json"}
    assert sum(os.path.getsize(os.path.join(CELLS_DIR, n)) for n in names) <= BUDGET_BYTES
    records, refs = cell_fixtures()
    assert list(records) == list(cells.CELL_CASES)
    for name, record in records.items():
        assert os.path.getsize(os.path.join(CELLS_DIR, f"{name}.npz")) <= CASE_BYTES
        case, opts = cells.CELL_CASES[name], cells.options(name)
        t, d1, d2 = case["shape"]
        assert set(record) - {"spread_samples"} == {
            "pipeline_ranks", "rank", "thresholds", "prune_shape", "movie_digest", "source",
            "cached_frames", "movie_seconds", "seconds", "fingerprint_seconds", "peak_rss_gib",
            "spread", "spread_rank", "spread_seconds"}
        errors = {"psi_y", "y_omega", "s", "mean", "var", "mean_probe", "var_probe"}
        assert set(record["spread"]) == errors
        assert all(0 <= x < 1 for x in record["spread"].values()), record["spread"]
        for sample in record.get("spread_samples", ()):
            assert set(sample) == errors | {"seed", "rank", "gram_kept"}
            assert sample["seed"] != cells.SPREAD_SEED and 0 < sample["rank"] <= sample["gram_kept"]
            assert all(0 <= sample[k] < 1 for k in errors), sample
        ranks = record["pipeline_ranks"]
        assert set(ranks) == {"blockwise", "pre_reduction", "reduced", "final"}
        assert 0 < record["rank"] <= ranks["final"] <= ranks["reduced"] <= ranks["pre_reduction"]
        if opts["rank_prune"]:
            crop = cells.crop_frames(name)
            assert record["prune_shape"] == [crop, int(min(ranks["pre_reduction"], crop)
                                                       * cells.RANK_PRUNE_FACTOR)]
        else:
            assert record["prune_shape"] is None
        assert record["source"] == case["source"] and len(record["movie_digest"]) == 64
        assert record["seconds"] > 0 and record["peak_rss_gib"] > 0
        n, w, k = cells.n_blocks(name), cells.n_windows(name), opts["max_components"]
        pixels = len(cells.pixel_sample(d1 * d2))
        fp = ("psi_y_phi", (full.PROBES, full.PHI_COLUMNS)) if t > full.PHI_FROM_T else (
            "psi_y", (full.PROBES, t))
        want = {"s": ((record["rank"],), np.float32), "mean_img": ((pixels,), np.float32),
                "var_img": ((pixels,), np.float32), "image_probe": ((full.PROBES, 2), np.float32),
                fp[0]: (fp[1], np.float32), "y_omega": ((pixels,), np.float32),
                "block_counts": ((n,), np.int16), "window_counts": ((w, n), np.int16),
                "block_spatial": ((w, n, k), np.float32), "block_temporal": ((w, n, k), np.float32),
                "gram_vals": (refs[name]["gram_vals"].shape, np.float32)}
        ref = refs[name]
        assert {key: (v.shape, v.dtype) for key, v in ref.items()} == want, name
        # the factorized SVD's Gram: as many directions as the reduction
        # keeps, none of them past the blockwise rank and the background
        assert ref["gram_vals"].ndim == 1 and np.all(np.diff(ref["gram_vals"]) <= 0)
        assert eigen_cut(ref["gram_vals"])[0] <= ranks["reduced"]
        assert int(ref["block_counts"].sum()) == ranks["blockwise"]
        counts = cells.window_counts(ref["block_spatial"], ref["block_temporal"],
                                     record["thresholds"], k)
        assert np.array_equal(counts, ref["window_counts"])
        assert np.array_equal(counts[-1], ref["block_counts"])
        assert np.all(np.isfinite(ref[fp[0]])) and np.all(np.diff(ref["s"]) <= 0)
        assert np.all(ref["var_img"] > 0)
    # the residual window kept components of its own
    wc = refs["voltage_f32"]["window_counts"]
    assert np.all(wc[1] >= wc[0]) and wc[1].sum() > wc[0].sum()


# ---------------------------------------------------------------------------
# (d) decisions, windows and block order
# ---------------------------------------------------------------------------

def test_window_counts_pack_behind_earlier_windows_up_to_the_cap():
    thresholds = (1.0, 1.0)
    sp = np.full((2, 3, 5), 0.5)
    tp = np.full((2, 3, 5), 0.5)
    sp[0, 0, 2] = 2.0           # block 0 keeps 3 in window 0 (the failure kept)
    sp[1, 1, 0] = 2.0           # block 1 keeps 1 in window 1
    counts = cells.window_counts(sp, tp, thresholds, max_rank=7)
    assert counts.tolist() == [[3, 5, 5], [7, 6, 7]]
    assert cells.window_counts(sp[:1], tp[:1], thresholds, 7).tolist() == [[3, 5, 5]]


def test_split_windows_takes_each_window_s_rows_in_block_order():
    gen = _generator()
    rows = lambda lo, n: np.arange(lo, lo + n)  # noqa: E731
    calls = [("first", rows(0, 4)), ("residual", rows(100, 4)),
             ("first", rows(4, 4)), ("residual", rows(104, 4))]
    got = gen.split_windows(calls, 6, 2)
    assert got.tolist() == [[0, 1, 2, 3, 4, 5], [100, 101, 102, 103, 104, 105]]
    assert gen.split_windows(calls[::2], 6, 1).tolist() == [[0, 1, 2, 3, 4, 5]]
    with pytest.raises(RuntimeError, match="windows per batch"):
        gen.split_windows(calls[:3], 6, 2)
    with pytest.raises(RuntimeError, match="fallback"):
        gen.split_windows(calls + [("fallback", rows(0, 4))], 6, 2)


def test_window_flips_name_the_first_window_that_differs():
    thr = (1.0, 2.0)
    port_sp, port_tp = np.full((2, 4, 3), 0.5), np.full((2, 4, 3), 1.0)
    jax_sp, jax_tp = port_sp.copy(), port_tp.copy()
    # block 1: a window-0 tie on the spatial statistic; its window 1 then
    # differs too, which is not reported
    port_sp[0, 1, 1], jax_sp[0, 1, 1] = 1.0 - 2e-5, 1.0 + 3e-5
    port_sp[1, 1, 0], jax_sp[1, 1, 0] = 0.2, 1.9
    # block 3: window 1 alone, far from the threshold
    port_tp[1, 3, 1], jax_tp[1, 3, 1] = 1.0, 3.0
    port = (port_sp, port_tp)
    jax = (jax_sp, jax_tp)
    pc = cells.window_counts(*port, thr, 6)
    jc = cells.window_counts(*jax, thr, 6)
    flips = window_flips(port, jax, thr, pc, jc)
    assert [(f["window"], f["block"], f["component"], f["tie"]) for f in flips] == [
        (0, 1, 1, True), (1, 3, 1, False)]
    starts = np.zeros((4, 2), int)
    assert describe_flip(flips[0], starts).startswith("window 0, block 1 at (0, 0)")
    assert describe_flip(flips[1], starts).endswith("NOT a tie")


@pytest.mark.parametrize("gap", [0.002, 0.2])
def test_gram_flip_reports_the_directions_decided_differently(gap):
    """Where the port's factorized SVD keeps another number of Gram
    directions than the JAX package's (the voltage cell: 2012 against
    2013), both packages' eigenvalues there are reported over their cuts;
    a 0.2% gap and a 20% gap alike: the kept rank's bar judges it, no
    window around the cut excuses it."""
    jax = np.array([1e8, 5e6, 102.0, 100.0 * (1 + gap), 99.03, 50.0])     # the cut: 100
    port = jax.copy()
    port[3] = 100.0 * (1 - gap)
    flip = gram_flip(port, jax)
    assert (flip["port_kept"], flip["jax_kept"], flip["indices"].tolist()) == (3, 4, [3])
    np.testing.assert_allclose(flip["port_ratio"], [1 - gap])
    np.testing.assert_allclose(flip["jax_ratio"], [1 + gap])
    assert "tie" not in flip
    text = describe_gram_flip(flip, 6)
    assert text.startswith("factorized SVD: the port keeps 3 of 6") and "JAX 4" in text
    assert "tie" not in text
    assert gram_flip(jax, jax) is None
    short = gram_flip(jax[:3], jax)
    assert short["port_ratio"] is None and describe_gram_flip(short, 3).endswith("JAX 4")


def test_gram_spy_reads_the_factorized_svd_eigenvalues():
    """``eigen_cut_spy`` sees the factorized SVD's Gram and changes
    nothing: the kept rank is at most the directions past its cut, and a
    run under it is the run without it."""
    from _torch_util import parity_draws, parity_records

    records, draws = parity_records(), parity_draws()
    with eigen_cut_spy() as seen:
        spied = parity_run("regular_48", "cpu", records, draws)
    plain = parity_run("regular_48", "cpu", records, draws)
    kept, margin = eigen_cut(seen["vals"])
    assert seen["vals"].ndim == 1 and 0 < spied.rank <= kept and margin > 0
    np.testing.assert_array_equal(np.asarray(spied.s), np.asarray(plain.s))


@pytest.mark.parametrize("n,want", [(20, "the rest median 1.00e-03 and max 1.00e-03"),
                                    (3, "the first 12 within 1.00e-03"), (0, "and 1)")])
def test_s_by_index_compares_over_the_shorter(n, want):
    """Phases 15 and 16 print where ``s`` differs, value by value, over the
    shorter of the two (the voltage cell keeps 2012 against 2013)."""
    from chip_smoke import s_by_index

    ref = np.arange(n + 1, 0, -1.0)
    line = s_by_index(ref[:n] * 1.001, ref)
    assert line.startswith(f"s by index against JAX (relative, over {n} of {n} and {n + 1})")
    assert line.endswith(want)


def test_errors_name_each_bar_and_take_s_over_the_shorter_on_request():
    rng = np.random.default_rng(0)
    want = dict(psi_y_phi=rng.standard_normal((4, 5)), y_omega=rng.standard_normal(6),
                s=np.array([5.0, 3.0, 2.0]), mean_img=rng.uniform(1, 2, 6),
                var_img=rng.uniform(1, 2, 6), image_probe=rng.standard_normal((4, 2)))
    got = dict(want, s=np.array([5.0, 3.0, 2.0, 1.0]))
    got["psi_y_phi"] = want["psi_y_phi"] * (1 + 1e-3)
    err = cells.errors(got, want)
    assert set(err) == {"psi_y", "y_omega", "s", "mean", "var", "mean_probe", "var_probe"}
    assert err["psi_y"] == pytest.approx(1e-3) and err["y_omega"] == 0
    assert err["s"] == float("inf") and cells.errors(got, want, s_prefix=True)["s"] == 0


def test_bars_flag_the_image_probes():
    record = dict(pipeline_ranks=dict(blockwise=10, pre_reduction=12, reduced=4, final=4), rank=4)
    err = dict(psi_y=5e-6, y_omega=5e-6, s=5e-6, mean=1e-6, var=1e-6, mean_probe=1e-6,
               var_probe=1e-6)
    assert full_width_misses(err, record["pipeline_ranks"], 4, record) == []
    for key, name in (("mean_probe", "mean_img probe"), ("var_probe", "var_img probe")):
        for bad in (1.01e-4, float("nan")):
            assert full_width_misses(dict(err, **{key: bad}), record["pipeline_ranks"], 4,
                                     record) == [name]


def test_phase_16_uses_phase_15_bars_and_tie_rule():
    assert "cell_check(" in inspect.getsource(phase_cells)
    source = inspect.getsource(cell_check)
    for fn in ("pinned_run(", "cell_arrays(", "cells.errors(", "full_width_misses(",
               "window_flips(", "describe_flip(", "block_spy(", "window_stats(", "gram_flip("):
        assert fn in source, fn
    assert "block_flips(" in inspect.getsource(window_flips)
    assert "card_fingerprint(" in inspect.getsource(cell_arrays)
    assert "card_fingerprint(" in inspect.getsource(full_width_errors)
    assert FULL_TOL == 1e-4 and FULL_TIE_RTOL == 1e-4 and CELL_ATTEMPTS == 3
    # the default run holds the cells that meet the bars; the others are
    # run by name and miss them (ROADMAP Queue 3)
    assert CELL_RUNS == ("1024_u16",) and OPEN_CELLS == ("voltage_f32", "northstar_u16")
    assert set(CELL_RUNS + OPEN_CELLS) == set(cells.CELL_CASES)
    # every case held with the routes as users get them: the check sets
    # none, and the phase turns them off only for its measurement run after
    # the check, then back to "auto"
    tree = ast.parse(inspect.getsource(cell_check))
    assert not any(isinstance(n, ast.Name) and n.id == "set_routes" for n in ast.walk(tree))
    phase = inspect.getsource(phase_cells)
    calls = [n for n in ast.walk(ast.parse(phase)) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "set_routes"]
    assert sorted(ast.literal_eval(c.args[0]) is False for c in calls) == [False, True]
    assert phase.index("cell_check(") < phase.index("set_routes(False)")


def test_decision_seam_reaches_the_named_window():
    """Window 1 of the ``multi_window_f32`` parity case (four windows), one
    failing component kept: the block's count changes, window 0 and the
    other blocks are as they were, and every window's rows are one per
    block."""
    from _torch_util import parity_draws, parity_records
    from localmd_tpu_torch.ops.tiling import block_grid

    name = "multi_window_f32"
    case = cases.CASES[name]
    n = block_grid(*case["shape"][1:], case["blocks"]).n_blocks
    records, draws = parity_records(), parity_draws()
    order = np.arange(n)
    with block_spy() as plain:
        parity_run(name, "cpu", records, draws)
    windows = max(plain["windows"]) + 1
    assert windows >= 2 and -1 not in plain["windows"]
    stats = window_stats(plain, order, windows)
    assert stats is not None and stats[0].shape[:2] == (windows, n)
    thresholds = tuple(records[name]["thresholds"]) if "thresholds" in records[name] else (1e9, 1e9)
    max_rank = cases.SETTINGS["max_components"]
    counts = cells.window_counts(*stats, thresholds, max_rank)
    assert np.array_equal(counts[-1], plain["counts"])
    # a block that ends short of the cap, whose first window-1 component
    # fails: kept there, it lets a second window-1 component in
    keep = cells.keep_decisions(stats[0][1], stats[1][1], thresholds)
    b = int(np.flatnonzero((plain["counts"] < max_rank) & ~keep[:, 0])[0])
    with block_spy(order, {(1, b, 0): True}) as forced:
        parity_run(name, "cpu", records, draws)
    assert forced["forced"] == 1
    got = window_stats(forced, order, windows)
    assert np.array_equal(got[0][0], stats[0][0])       # window 0 untouched
    assert forced["counts"][b] != plain["counts"][b]
    others = np.arange(n) != b
    assert np.array_equal(forced["counts"][others], plain["counts"][others])


def test_snapped_grid_coset_rows_map_to_their_blocks():
    """A 56 x 44 FOV of 16 x 16 blocks (snapped tails both ways): the coset
    stage's rows (its lattices, then the off-lattice tail in one gathered
    batch), put in block order by ``block_order``, are the gathered stage's
    rows in block order."""
    from bench_torch import set_routes
    from chip_smoke import pinned_run
    from localmd_tpu_torch import engine
    from localmd_tpu_torch.ops.tiling import block_grid

    shape, blocks = (300, 56, 44), (16, 16)
    _, ids, remainder = engine.coset_stage_plan(shape[1], shape[2], *blocks)
    n = block_grid(shape[1], shape[2], blocks).n_blocks
    assert len(remainder) > 0 and len(ids) + len(remainder) == n
    order = block_order(True, shape, blocks)
    assert sorted(order.tolist()) == list(range(n)) and np.array_equal(order[len(ids):], remainder)
    assert np.array_equal(block_order(False, shape, blocks), np.arange(n))
    movie = cells.Movie(shape).array()
    opts = dict(frame_range=300, max_components=6, background_rank=2, temporal_avg_factor=5,
                seed=0)
    out = {}
    for coset in (True, False):
        set_routes(True if coset else False)
        try:
            with block_spy() as spied:
                pinned_run(movie, blocks, "cpu", (1.3, 2.3), cells.sketch, **opts)
        finally:
            set_routes("auto")
        stats = window_stats(spied, block_order(coset, shape, blocks))
        out[coset] = ((stats[0][0], stats[1][0]), spied["counts"])
    (coset_stats, coset_counts), (gather_stats, gather_counts) = out[True], out[False]
    for a, b in zip(coset_stats, gather_stats):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert np.array_equal(coset_counts, gather_counts)
    assert np.array_equal(cells.kept_counts(*coset_stats, (1.3, 2.3)), coset_counts)


def test_stats_f64_is_k1s_plain_twin_in_float64():
    """Phase 15's measurement of the s_0 gap: ``stats_f64`` is
    ``movie_stats_plain`` in float64, its pixels taken in slices."""
    import torch

    from chip_smoke import stats_f64
    from localmd_tpu_torch.ops.kernels import movie_stats_plain

    x = torch.from_numpy(cells.Movie((1024, 12, 10), "uint16").array().reshape(1024, -1))
    mean, sigma = stats_f64(x, 2048, True, pixels=50)
    mean32, sigma32 = movie_stats_plain(x, 2048, True)
    assert mean.dtype == sigma.dtype == torch.float64
    assert torch.equal(mean, x.double().sum(0) / 2048)
    np.testing.assert_allclose(mean.numpy(), mean32.numpy(), rtol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), sigma32.numpy(), rtol=1e-5)
    assert torch.equal(stats_f64(x, 2048, False)[1], torch.zeros(120, dtype=torch.float64))


def test_eigen_cut_counts_the_gram_directions_kept():
    from chip_smoke import eigen_cut

    vals = np.array([1e6, 10.0, 1.0002, 0.9, 1e-3, -1e-4])
    assert eigen_cut(vals) == (3, pytest.approx(2e-4, rel=1e-3))


# ---------------------------------------------------------------------------
# (e) phase 16's check on small cells
# ---------------------------------------------------------------------------

SMALL = dict(max_components=6, background_rank=2, temporal_avg_factor=5, sim_iters=24, seed=0)
SMALL_CASES = {
    # two windows of the residual stage, float32 in memory
    "small_windows": dict(shape=(1200, 48, 40), dtype="float32", blocks=(16, 16),
                          source="memory",
                          options=dict(SMALL, frame_range=400, window_chunks=200, rank_prune=False)),
    # uint16 read from a raw file, rank_prune, a snapped tail
    "small_raw_u16": dict(shape=(700, 40, 36), dtype="uint16", blocks=(16, 16), source="raw",
                          options=dict(SMALL, frame_range=300, rank_prune=True, num_workers=2)),
}


def _subspace_plan(m, k):
    return "subspace", min(m, k + 32)


def _sources(name, directory):
    """(the JAX package's source, the port's) of a small cell: its movie in
    memory, or its raw file written into ``directory``."""
    from localmd_tpu.dataset import RawBinaryArray as JaxRaw
    from localmd_tpu_torch.dataset import RawBinaryArray

    case = cells.CELL_CASES[name]
    mov = cells.movie(name)
    if case["source"] != "raw":
        movie = mov.array()
        return movie, movie
    path = os.path.join(str(directory), f"{name}.raw")
    mov.write(path)
    return (JaxRaw(path, case["shape"], dtype="<u2"),
            RawBinaryArray(path, case["shape"], case["dtype"]))


def _jax_fixture(name, source):
    """The generator's ``cases.json`` entry, arrays and run record."""
    arrays, entry, record = _generator().make_case(name, source)
    return entry, arrays, record


@pytest.fixture(scope="module")
def small_cells(tmp_path_factory):
    """The small cells' JAX results, made by the generator's own functions
    and written as ``torch_parity_cells/`` is: (directory, records,
    arrays, the generator's records)."""
    out = tmp_path_factory.mktemp("torch_parity_cells")
    records, refs, raw = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, case in SMALL_CASES.items():
            mp.setitem(cells.CELL_CASES, name, case)
            records[name], refs[name], raw[name] = _jax_fixture(name, _sources(name, out)[0])
            np.savez_compressed(out / f"{name}.npz", **refs[name])
    with open(out / "cases.json", "w") as f:
        json.dump(records, f)
    return out, records, refs, raw


@pytest.mark.parametrize("name", list(SMALL_CASES))
def test_phase_16_check_meets_the_jax_package_on_a_small_cell(monkeypatch, tmp_path, small_cells,
                                                              name):
    """The generator's own functions make the JAX package's record of a
    small cell; phase 16's ``cell_check`` holds the port on the CPU to it,
    and its counts window by window are the JAX package's."""
    _, records, refs, raw = small_cells
    monkeypatch.setitem(cells.CELL_CASES, name, SMALL_CASES[name])
    assert not raw[name]["subspace_sketches"]
    if SMALL_CASES[name]["options"].get("window_chunks"):
        assert raw[name]["window_counts"].shape[0] == 2
        assert raw[name]["window_counts"][1].sum() > raw[name]["window_counts"][0].sum()
    result = cell_check(name, "cpu", _sources(name, tmp_path)[1], records[name], refs[name])
    assert result["misses"] == [], result
    run = result["runs"][-1]
    assert run["ranks"] == records[name]["pipeline_ranks"] and run["rank"] == records[name]["rank"]
    assert max(run["err"][k] for k in ("psi_y", "y_omega", "s")) <= FULL_TOL
    assert 0 < run["eigen_cut"][0] <= records[name]["pipeline_ranks"]["reduced"]


def test_spread_samples_take_one_run_per_nudge_seed(monkeypatch, tmp_path, small_cells):
    """The generator's ``--spread``: the JAX package against its stored
    result once per seed of ``nudged_sketch``; the fixture's own seed gives
    the fixture's ``spread``, another seed other errors."""
    _, records, refs, _ = small_cells
    name = "small_raw_u16"
    monkeypatch.setitem(cells.CELL_CASES, name, SMALL_CASES[name])
    samples = _generator().spread_samples(name, _sources(name, tmp_path)[0], refs[name],
                                          [cells.SPREAD_SEED, cells.SPREAD_SEED + 1])
    assert [x["seed"] for x in samples] == [cells.SPREAD_SEED, cells.SPREAD_SEED + 1]
    assert {k: samples[0][k] for k in records[name]["spread"]} == records[name]["spread"]
    assert samples[0]["rank"] == records[name]["spread_rank"]
    assert samples[1]["psi_y"] != samples[0]["psi_y"]
    assert all(0 < x["rank"] <= x["gram_kept"] for x in samples)


def test_phase_16_check_with_the_subspace_eigh(monkeypatch, tmp_path):
    """Both packages' factorized SVD taking ``subspace_eigh``, as the
    voltage cell's does at full width (no rank prune: a 4000-wide Gram of
    rank <= 2710): the generator injects its range-capture sketch, which
    the JAX package draws from a key of its shape, and the port meets the
    result."""
    import localmd_tpu.factorization as jax_factorization
    from localmd_tpu_torch import factorization

    name = "small_windows"
    monkeypatch.setattr(jax_factorization, "eigh_plan", _subspace_plan)
    monkeypatch.setattr(factorization, "eigh_plan", _subspace_plan)
    monkeypatch.setitem(cells.CELL_CASES, name, SMALL_CASES[name])
    jax_source, port_source = _sources(name, tmp_path)
    rec, ref, raw = _jax_fixture(name, jax_source)
    assert len(raw["subspace_sketches"]) == 1
    result = cell_check(name, "cpu", port_source, rec, ref)
    assert result["misses"] == [], result


@pytest.mark.parametrize("what", ["s", "kept rank"])
def test_phase_16_bars_are_phase_15_s_whatever_the_jax_spread(small_cells, monkeypatch, tmp_path,
                                                              what):
    """The JAX package's own spread is printed, never a bar: with a spread
    of 0.5 on record, ``s`` 2e-4 off the stored one misses, and a kept rank
    one off (as a Gram cut decided differently gives) misses at once, with
    no rerun."""
    _, records, refs, _ = small_cells
    name = "small_windows"
    monkeypatch.setitem(cells.CELL_CASES, name, SMALL_CASES[name])
    record = dict(records[name], spread={k: 0.5 for k in records[name]["spread"]})
    ref = dict(refs[name])
    if what == "s":
        ref["s"] = ref["s"] * np.float32(1 + 2e-4)
    else:
        record["rank"] += 1
    result = cell_check(name, "cpu", _sources(name, tmp_path)[1], record, ref)
    assert result["misses"] == [what] and len(result["runs"]) == 1


@pytest.mark.parametrize("arg,code", [("bogus", None), ("1024_u16,nope", None),
                                      ("voltage_f32,northstar_u16", 2), ("1024_u16", 2)])
def test_cells_option_names_phase_16_s_cells(arg, code, capsys):
    """``--cells`` takes the phase's cells and no other name (an unknown
    one stops before the card is asked for); on a machine without CUDA
    a valid one goes on to exit 2."""
    import chip_smoke

    if code is None:
        with pytest.raises(SystemExit) as stop:
            chip_smoke.main(["--cells", arg])
        assert stop.value.code == 2 and "the cells are" in capsys.readouterr().err
    else:
        assert chip_smoke.main(["--phases", "16", "--cells", arg]) == code


def test_phase_16_runs_on_the_cpu_on_small_cells(monkeypatch, small_cells, capsys):
    """Phase 16 itself, on the CPU, on the small cells from their fixture
    directory: each movie made and checked against its digest, the raw
    file written and read, every case held to the bars (the card's launch
    and route checks aside: the CPU launches no kernel)."""
    import chip_smoke

    directory, _, _, _ = small_cells
    for name, case in SMALL_CASES.items():
        monkeypatch.setitem(cells.CELL_CASES, name, case)
    monkeypatch.setattr(chip_smoke, "CELLS_DIR", str(directory))
    monkeypatch.setattr(chip_smoke, "check_path", lambda *a, **k: None)
    launches = phase_cells("cpu", tuple(SMALL_CASES))
    assert set(launches) == {"movie_stats", "v_projection", "block_reconstruct", "jacobi_eigh"}
    out = capsys.readouterr().out
    assert "small_raw_u16: launches" in out and "native reader" in out
    assert "fp32 ties given the JAX package's decision" in out
    assert out.count("routes off against its first run") == len(SMALL_CASES)


# ---------------------------------------------------------------------------
# full width (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(cells.CELL_CASES))
def test_port_on_the_cpu_meets_the_cell_fixture(name, tmp_path):
    """Slow (the port at full width on the CPU: minutes and up to tens of
    GB a case; the north star writes its 15.7 GB raw file): phase 16's own
    per-run check, on the CPU, meets the committed JAX result. voltage_f32
    and northstar_u16 miss it, as on the card (``OPEN_CELLS``; ROADMAP
    Queue 3)."""
    from localmd_tpu_torch.dataset import RawBinaryArray

    records, refs = cell_fixtures()
    case = cells.CELL_CASES[name]
    mov = cells.movie(name)
    assert cells.digest(mov) == records[name]["movie_digest"]
    if case["source"] == "raw":
        path = str(tmp_path / "movie.raw")
        mov.write(path)
        source = RawBinaryArray(path, case["shape"], case["dtype"])
    else:
        source = mov.array()
    result = cell_check(name, "cpu", source, records[name], refs[name])
    assert result["misses"] == [], result
    assert all(flip["tie"] for flip in result["ties"])

