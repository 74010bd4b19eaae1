"""The hour-long int16 cell (``northstar_i16.stream``): its entries resolve
by name, its movie is int16 counts with negative samples where the
configuration says, the readers of the V regression's stream counters,
and a traced run of the cell cut to the CPU with the movie cache planned
to a prefix, as the card plans it at full size."""

import json
import os
import shutil

import pytest
import torch

from pmdbench import catalog
from pmdbench.movie import Movie

from conftest import ROOT, run_tiny

CELL = "northstar_i16.stream"
PER_LAYER = ("stats_s.i16", "fsvd_s.i16", "vreg_s.i16", "stream_roofline.i16", "k1_roofline.i16",
             "idle_share.i16", "vreg_host_read_s", "vreg_chunk_wait_s", "vreg_prefetch_lead_s")
READERS = {"vreg_host_read_s": "vreg.host_read_s", "vreg_chunk_wait_s": "vreg.chunk_wait_s",
           "vreg_prefetch_lead_s": "vreg.prefetch_lead_s"}


def test_the_cell_resolves_to_its_config_traffic_and_limits():
    bench = catalog.load_benchmark()
    cell = catalog.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "northstar_i16", "decompose_stream", 1)
    cfg = catalog.config(bench, cell["config"])
    north = catalog.config(bench, "northstar_u16")
    assert cfg["movie"]["shape"] == [108000, 512, 512] and cfg["movie"]["dtype"] == "int16"
    differ = {k for k in cfg["movie"] if cfg["movie"][k] != north["movie"][k]}
    assert differ == {"shape", "dtype", "offset"}
    assert cfg["settings"] == north["settings"]
    assert set(cfg["reduced"]) == {"storage"}
    assert set(catalog.limits(CELL)) == {"mean_gap", "noise_gap", "recon_gap", "vreg_gap",
                                         "source_gap"}
    e2e = [m["name"] for m in catalog.metrics_of(bench, CELL, "end_to_end")]
    assert e2e == ["stream_mpf_per_s", "setup_s"]
    per_layer = {m["name"]: m for m in catalog.metrics_of(bench, CELL, "per_layer")}
    assert set(per_layer) == set(PER_LAYER)
    for m in per_layer.values():
        assert m["workloads"] == [CELL] and m["moves"] == "stream_mpf_per_s"


def test_a_piece_of_the_movie_is_int16_counts_with_negative_samples():
    """The first 512 frames at full width: int16 counts, 40 a noise sigma
    over an offset of 40, so about 16% of the samples far from every cell
    are negative, and none leaves int16's range."""
    cfg = catalog.config(catalog.load_benchmark(), "northstar_i16")
    movie = Movie(cfg["movie"], 2**33 + 5, "cpu")
    x = movie.piece(0)
    assert x.dtype == torch.int16 and tuple(x.shape) == (512, 512, 512)
    background = (movie.footprints().sum(dim=1) < 1e-3).reshape(512, 512)
    assert int(background.sum()) > 100000
    share = float((x[:, background] < 0).float().mean())
    assert 0.15 < share < 0.17
    assert -8 * 40 < int(x.min()) and int(x.max()) < 32767
    assert movie.nbytes == 108000 * 512 * 512 * 2


def _run(values, key):
    return dict(calls=[dict(wall_s=1.0, cache={key: v, "stream_dtype": "int16"})
                       for v in values])


@pytest.mark.parametrize("metric,key", list(READERS.items()))
def test_reader_is_the_median_over_the_calls(metric, key):
    read = catalog.reader(metric)
    assert read(_run([0.5, 0.1, 0.3], key)) == pytest.approx(0.3)
    assert read(_run([0.4, 0.2], key)) == pytest.approx(0.3)


@pytest.mark.parametrize("metric,key", list(READERS.items()))
def test_reader_finds_nothing_to_read(metric, key):
    read = catalog.reader(metric)
    assert read({}) is None
    assert read(dict(calls=[])) is None
    run = _run([0.5, 0.1], key)
    del run["calls"][1]["cache"][key]          # a program without the counter
    assert read(run) is None


def _cut_to_the_cpu(tmp_path):
    """The cell's own files at 48x64x3600 with blocks 16 (a regular grid,
    as 512x512 with blocks 32 is), frame_range 1000 and 6 cells: (bench,
    root)."""
    here = tmp_path / "pmdbench"
    shutil.copytree(os.path.join(ROOT, "pmdbench"), here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = here / "configs" / "northstar_i16.json"
    cfg = json.loads(path.read_text())
    cfg["movie"].update(shape=[3600, 48, 64], piece_frames=256, n_cells=6)
    cfg["settings"].update(block_sizes=[16, 16], frame_range=1000, max_components=6,
                           sim_iters=20, num_workers=2)
    path.write_text(json.dumps(cfg))
    return catalog.load_benchmark(str(tmp_path)), str(tmp_path)


def test_a_traced_run_of_the_cell_cut_to_the_cpu(tmp_path, monkeypatch):
    """The free bytes set to hold 60% of the movie at the default
    ``cache_fraction``: every call caches its first 2048 frames and streams
    the rest again in the V regression, through the stream opened before
    the factorized SVD. The run's line carries the cell's per-layer metrics
    that a CPU run can read (no device trace, so no roofline of the card
    and no idle share), and every number of its check. The numbers at this
    size are not the card's, so ``correct`` is not asserted here."""
    import localmd_tpu_torch.loader as port_loader

    free = int(0.6 * 3600 * 48 * 64 * 2 / port_loader.CACHE_FRACTION)
    monkeypatch.setattr(port_loader, "device_free_bytes", lambda device, *a, **k: free)
    bench, root = _cut_to_the_cpu(tmp_path)
    result = run_tiny(bench, root, CELL, traced=True)
    metrics = result["metrics"]
    assert {"stats_s.i16", "fsvd_s.i16", "vreg_s.i16", "stream_roofline.i16", "vreg_host_read_s",
            "vreg_chunk_wait_s", "vreg_prefetch_lead_s"} <= set(metrics)
    assert "k1_roofline.i16" not in metrics
    assert metrics["vreg_host_read_s"]["value"] > 0
    assert metrics["vreg_prefetch_lead_s"]["value"] > 0
    assert set(result["checks"]) == set(catalog.limits(CELL))
