"""The voltage cell (``voltage_f32.resident``): its entries resolve by name,
its movie is float32 integer counts where the configuration says, the
reader of the residual windows' seconds, and a traced run of the cell cut
to the CPU."""

import json
import os
import shutil

import pytest
import torch

from pmdbench import catalog
from pmdbench.movie import Movie

from conftest import ROOT, run_tiny

CELL = "voltage_f32.resident"
PER_LAYER = ("stats_s.voltage", "block_s.voltage", "fsvd_s.voltage", "vreg_s.voltage",
             "k1_roofline.voltage", "idle_share.voltage", "residual_s")


def test_the_cell_resolves_to_its_config_traffic_and_limits():
    bench = catalog.load_benchmark()
    cell = catalog.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "voltage_f32", "decompose_resident", 1)
    cfg = catalog.config(bench, cell["config"])
    assert cfg["movie"]["shape"] == [60000, 256, 256] and cfg["movie"]["dtype"] == "float32"
    st = cfg["settings"]
    assert st["block_sizes"] == [32, 32] and st["background_rank"] == 15
    assert (st["frame_range"], st["window_chunks"], st["rank_prune"]) == (20000, 2000, False)
    assert set(cfg["reduced"]) == {"frames", "storage"}
    assert catalog.traffic(cell["traffic"]) == dict(catalog.traffic("decompose_resident"))
    assert set(catalog.limits(CELL)) >= {"mean_gap", "noise_gap", "vreg_gap", "source_gap"}
    e2e = [m["name"] for m in catalog.metrics_of(bench, CELL, "end_to_end")]
    assert e2e == ["decompose_mpf_per_s", "setup_s"]
    per_layer = {m["name"]: m for m in catalog.metrics_of(bench, CELL, "per_layer")}
    assert set(per_layer) == set(PER_LAYER)
    for m in per_layer.values():
        assert m["workloads"] == [CELL] and m["moves"] == "decompose_mpf_per_s"


def test_a_piece_of_the_movie_is_float32_counts():
    """The first 512 frames at full width: float32 samples that are whole
    counts, 40 a noise sigma over an offset of 2000, cells adding up to a
    few hundred counts more; no sample below eight sigmas under the offset
    or far above what 60 cells of amplitude 8 reach."""
    cfg = catalog.config(catalog.load_benchmark(), "voltage_f32")
    movie = Movie(cfg["movie"], 2**33 + 3, "cpu")
    x = movie.piece(0)
    assert x.dtype == torch.float32 and tuple(x.shape) == (512, 256, 256)
    assert bool((x == x.round()).all())
    assert 2000 - 8 * 40 < float(x.min()) and float(x.max()) < 2000 + 60 * 40
    assert abs(float(x.median()) - 2000) < 40


def test_residual_s_is_the_median_over_the_calls():
    run = dict(calls=[dict(cache={"blocks.residual_s": v}) for v in (0.3, 0.1, 0.2)])
    assert catalog.reader("residual_s")(run) == pytest.approx(0.2)
    # a program without the span, or a window the profiler did not trace
    del run["calls"][0]["cache"]["blocks.residual_s"]
    assert catalog.reader("residual_s")(run) is None


def _cut_to_the_cpu(tmp_path):
    """The cell's own files at 64x64x3000 with blocks 16 (a regular grid,
    as 256x256 with blocks 32 is), frame_range 2000 in eight 250-frame
    windows and the recipe's cell density (4 cells): (bench, root)."""
    here = tmp_path / "pmdbench"
    shutil.copytree(os.path.join(ROOT, "pmdbench"), here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = here / "configs" / "voltage_f32.json"
    cfg = json.loads(path.read_text())
    cfg["movie"].update(shape=[3000, 64, 64], piece_frames=256, n_cells=4)
    cfg["settings"].update(block_sizes=[16, 16], frame_range=2000, window_chunks=250,
                           max_components=8, sim_iters=10, num_workers=0)
    path.write_text(json.dumps(cfg))
    return catalog.load_benchmark(str(tmp_path)), str(tmp_path)


def test_a_traced_run_of_the_cell_cut_to_the_cpu(tmp_path):
    """The run completes and its line carries the cell's per-layer metrics
    that a CPU run can read (no device trace, so no roofline of the card),
    the residual windows' seconds within the block stage's, and every
    number of its check. The numbers at this size are not the card's, so
    ``correct`` is not asserted here."""
    bench, root = _cut_to_the_cpu(tmp_path)
    result = run_tiny(bench, root, CELL, traced=True)
    metrics = result["metrics"]
    assert {"stats_s.voltage", "block_s.voltage", "fsvd_s.voltage", "vreg_s.voltage",
            "residual_s"} <= set(metrics)
    assert "k1_roofline.voltage" not in metrics
    assert 0 < metrics["residual_s"]["value"] <= metrics["block_s.voltage"]["value"]
    assert set(result["checks"]) == set(catalog.limits(CELL))
