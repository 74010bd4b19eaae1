"""Everything a cell needs is found by name, and a new cell, configuration,
traffic mix or metric is new files and new entries only."""

import json
import os
import shutil

from pmdbench import catalog

from conftest import ROOT, run_tiny


def test_every_entry_is_found_by_name():
    bench = catalog.load_benchmark()
    for cfg in bench["configs"]:
        assert catalog.config(bench, cfg["name"])["name"] == cfg["name"]
    for cell in bench["workloads"]:
        assert catalog.cell(bench, cell["name"]) is cell
        assert catalog.traffic(cell["traffic"])["kind"] in ("decompose", "view")
        assert set(catalog.limits(cell["name"])) >= {"mean_gap", "noise_gap", "vreg_gap"}
        for section in ("end_to_end", "per_layer"):
            names = [m["name"] for m in catalog.metrics_of(bench, cell["name"], section)]
            assert names, (cell["name"], section)
        e2e = [m["name"] for m in catalog.metrics_of(bench, cell["name"], "end_to_end")]
        assert "setup_s" in e2e
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert catalog.reader(m["name"])({}) is None


def test_adding_a_cell_is_adding_files(tmp_path):
    """A new configuration, traffic mix, limits and metric, each a new file,
    and entries in BENCHMARK.json: the harness runs the new cell and reads
    the new metric, with no file of the harness changed."""
    here = tmp_path / "pmdbench"
    shutil.copytree(os.path.join(ROOT, "pmdbench"), here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "northstar_u16.json").read_text())
    cfg["name"] = "mini_u16"
    cfg["movie"].update(shape=[600, 32, 32], n_cells=4, radius=3.0, piece_frames=128)
    cfg["settings"].update(block_sizes=[16, 16], frame_range=300, max_components=4,
                           background_rank=1, sim_iters=10, num_workers=0)
    (here / "configs" / "mini_u16.json").write_text(json.dumps(cfg))
    (here / "traffic" / "decompose_twice.json").write_text(json.dumps(
        dict(kind="decompose", movie_on="card", sample=1)))
    (here / "limits" / "mini_u16.twice.json").write_text(json.dumps(
        dict(mean_gap=1e-3, noise_gap=1e-3, recon_gap=1e-2)))
    (here / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(len(run['calls'])) if run.get('calls') else None\n")
    bench = catalog.load_benchmark(ROOT)
    bench["configs"].append(dict(name="mini_u16", source="https://example.org/mini",
                                 file="pmdbench/configs/mini_u16.json", reduced=[], why="test"))
    bench["workloads"].append(dict(name="mini_u16.twice", config="mini_u16",
                                   traffic="decompose_twice", chips=1, why="test"))
    bench["end_to_end"].append(dict(name="calls_in_window", unit="calls", better="higher",
                                    bound=0.1, source="host_clock", workloads=["mini_u16.twice"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_tiny(catalog.load_benchmark(str(tmp_path)), str(tmp_path), "mini_u16.twice")
    assert result["correct"] is True
    assert result["metrics"]["calls_in_window"]["value"] >= 1
    assert "setup_s" in result["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
