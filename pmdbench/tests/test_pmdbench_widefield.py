"""The widefield cell (``widefield_u16.resident``): its entries resolve by
name, K2's roofline arithmetic (``rooflines_k2.py``) at a known shape, the
readers of K2's counters, and a traced run of the cell cut to the CPU."""

import json
import os
import shutil

import pytest

from pmdbench import catalog, rooflines_k2

from conftest import ROOT, run_tiny

CELL = "widefield_u16.resident"
PER_LAYER = ("stats_s.widefield", "block_s.widefield", "fsvd_s.widefield", "vreg_s.widefield",
             "k1_roofline.widefield", "idle_share.widefield", "vreg_k2_s", "k2_roofline")


def test_the_cell_resolves_to_its_config_traffic_and_limits():
    bench = catalog.load_benchmark()
    cell = catalog.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "widefield_u16", "decompose_resident", 1)
    cfg = catalog.config(bench, cell["config"])
    assert cfg["movie"]["shape"] == [40000, 540, 640] and cfg["movie"]["dtype"] == "uint16"
    assert cfg["settings"]["block_sizes"] == [32, 32]
    assert cfg["settings"]["background_rank"] == 15
    assert set(cfg["reduced"]) == {"frames", "storage"}
    assert catalog.traffic(cell["traffic"]) == dict(catalog.traffic("decompose_resident"))
    # no recon_gap: nothing reads far enough above the float32 factorized
    # SVD's own to set its upper end (PERF.md section 2)
    assert set(catalog.limits(CELL)) == {"mean_gap", "noise_gap", "vreg_gap", "source_gap"}
    e2e = [m["name"] for m in catalog.metrics_of(bench, CELL, "end_to_end")]
    assert e2e == ["decompose_mpf_per_s", "setup_s"]
    per_layer = {m["name"]: m for m in catalog.metrics_of(bench, CELL, "per_layer")}
    assert set(per_layer) == set(PER_LAYER)
    for m in per_layer.values():
        assert m["workloads"] == [CELL] and m["moves"] == "decompose_mpf_per_s"


def test_k2_bound_at_the_kernel_tables_shape():
    """(2048, 262144) f32 frames by r' = 336 in one launch: the function's
    bytes bound it, 0.747 ms at the published HBM rate; its 2 t d r'
    operations take 0.729 ms at the TF32 rate, and 3xTF32's three products
    2.187 ms (``PERF.md``'s K2 row), which the roofline does not count."""
    peaks = catalog.peaks()
    t, d, r = 2048, 262144, 336
    assert rooflines_k2.k2_flops(t, d, r) == 2 * t * d * r
    assert rooflines_k2.k2_bytes(t, d, r, "float32") == t * d * 4 + d * r * 4 + r * t * 4
    assert rooflines_k2.k2_seconds(t, d, r, "float32", peaks) == pytest.approx(0.747e-3, rel=1e-3)
    assert (3 * rooflines_k2.k2_flops(t, d, r) / peaks["tf32_flops_per_s"]
            == pytest.approx(2.187e-3, rel=1e-3))
    # the projector is read once per launch
    assert (rooflines_k2.k2_bytes(t, d, r, "float32", launches=10)
            - rooflines_k2.k2_bytes(t, d, r, "float32") == 9 * d * r * 4)
    # the widefield cell's call, (40000, 345600) uint16 by 1650 in ten
    # launches, is bound by its operations
    wide = rooflines_k2.k2_seconds(40000, 345600, 1650, "uint16", peaks, launches=10)
    assert wide == pytest.approx(2 * 40000 * 345600 * 1650 / peaks["tf32_flops_per_s"])
    # a narrow projector on a uint16 movie is bound by the bytes
    narrow = rooflines_k2.k2_seconds(t, d, 8, "uint16", peaks)
    assert narrow == pytest.approx(rooflines_k2.k2_bytes(t, d, 8, "uint16") / 3.35e12)


def _traced(cache, kernels):
    return dict(profile=dict(device_ops=kernels, busy_s=1.0, window_s=4.0),
                calls=[dict(wall_s=1.0, cache=dict(cache, stream_dtype="uint16"))] * 3,
                movie=dict(shape=(40000, 540, 640)), peaks=catalog.peaks())


def test_k2_roofline_reads_each_calls_width_and_frames():
    peaks = catalog.peaks()
    cache = {"vreg.k2_width": 400, "vreg.k2_frames": 40000, "vreg.k2_calls": 10}
    kernels = {"void vproj_wgmma_kernel<unsigned short, 11>(...)": 0.9,
               "vproj_reduce_kernel": 0.05, "projector_t_kernel": 0.05, "other": 2.0}
    bound = 3 * rooflines_k2.k2_seconds(40000, 540 * 640, 400, "uint16", peaks, launches=10)
    assert catalog.reader("k2_roofline")(_traced(cache, kernels)) == pytest.approx(100 * bound)
    # the cell route, or a program without K2's counters, reads nothing
    assert catalog.reader("k2_roofline")(_traced({}, kernels)) is None
    assert catalog.reader("k2_roofline")(_traced(cache, {"other": 1.0})) is None


def test_vreg_k2_s_is_the_median_over_the_calls():
    run = dict(calls=[dict(cache={"vreg.k2_s": v}) for v in (0.3, 0.1, 0.2)])
    assert catalog.reader("vreg_k2_s")(run) == pytest.approx(0.2)
    del run["calls"][0]["cache"]["vreg.k2_s"]
    assert catalog.reader("vreg_k2_s")(run) is None


def _cut_to_the_cpu(tmp_path):
    """The cell's own files at 54x64 with blocks 16 (a snapped grid, as
    540x640 with blocks 32 is): (bench, root)."""
    here = tmp_path / "pmdbench"
    shutil.copytree(os.path.join(ROOT, "pmdbench"), here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = here / "configs" / "widefield_u16.json"
    cfg = json.loads(path.read_text())
    cfg["movie"].update(shape=[600, 54, 64], piece_frames=128)
    cfg["settings"].update(block_sizes=[16, 16], frame_range=600, max_components=8,
                           sim_iters=10, num_workers=0)
    path.write_text(json.dumps(cfg))
    return catalog.load_benchmark(str(tmp_path)), str(tmp_path)


def test_a_traced_run_of_the_cell_cut_to_the_cpu(tmp_path):
    """The run completes and its line carries the cell's per-layer metrics
    that a CPU run can read (no device trace, so no roofline or idle share
    of the card) and every number of its check. At this size a diffuse
    source spans one or two blocks and the numbers are not the card's, so
    ``correct`` is not asserted here."""
    bench, root = _cut_to_the_cpu(tmp_path)
    result = run_tiny(bench, root, CELL, traced=True)
    assert {"stats_s.widefield", "block_s.widefield", "fsvd_s.widefield", "vreg_s.widefield",
            "vreg_k2_s"} <= set(result["metrics"])
    assert "k2_roofline" not in result["metrics"]
    assert result["metrics"]["vreg_k2_s"]["value"] > 0
    assert set(result["checks"]) == set(catalog.limits(CELL))


def test_witnesses_of_the_cell_cut_to_the_cpu(tmp_path, monkeypatch):
    """``witnesses.py`` with the coset stage forced on, as on the card: its
    float64 U reproduces the program's products; the float64 Gram's
    projector leaves the basis orthonormal to rounding where the program's
    float32 Gram does not, and ``recon_gap`` falls with it; the faulted
    remainder and the best basis are read."""
    import torch

    from localmd_tpu_torch import engine
    from pmdbench import witnesses

    monkeypatch.setattr(engine, "COSET_STAGE", True)
    bench, root = _cut_to_the_cpu(tmp_path)
    out = witnesses.witnesses(CELL, 2**33 + 5, torch.device("cpu"), root=root, bench=bench)
    assert out["counters"]["fsvd.banded"] == 0 and out["counters"]["blocks.remainder"] == 7
    gram = out["gram"]
    assert gram["product_gap"] < 1e-6 and gram["departure_f64"] < 1e-8
    assert gram["departure_f32"] > 100 * gram["departure_f64"]
    prog, f64 = out["program"], out["fsvd_f64"]
    assert prog["departure"] == pytest.approx(gram["departure_f32"], rel=0.5)
    assert f64["departure"] < prog["departure"] / 100
    assert f64["numbers"]["recon_gap"] < prog["numbers"]["recon_gap"] <= prog["departure"]
    assert set(out["drop_remainder"]["numbers"]) == set(prog["numbers"])
    assert out["best_basis"]["rank"] == out["ranks"]["program"]
    assert "canvas" not in out                      # the program took the canvas Gram already
