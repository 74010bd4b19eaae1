"""CPU tests of the benchmark harness. Tests that need a CUDA card are
marked ``gpu`` and decide inside the test whether one is present."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "northstar_u16": dict(movie=dict(shape=[4000, 48, 64], n_cells=6, radius=6.0, piece_frames=256),
                          settings=dict(block_sizes=[16, 16], frame_range=2000, max_components=6,
                                        background_rank=1, sim_iters=20, num_workers=0)),
}


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark's files with every configuration cut to a
    size the CPU runs in a second, and the view mix's windows to fit it:
    returns (bench, root); the harness's own files are under root/pmdbench."""
    from pmdbench import catalog

    here = tmp_path / "pmdbench"
    shutil.copytree(os.path.join(ROOT, "pmdbench"), here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for name, cut in TINY.items():
        path = here / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for key, values in cut.items():
            cfg[key].update(values)
        path.write_text(json.dumps(cfg))
    view = json.loads((here / "traffic" / "view.json").read_text())
    view["requests"] = 40
    view["mix"][1].update(frames=[100, 800], side=[4, 16])
    (here / "traffic" / "view.json").write_text(json.dumps(view))
    return catalog.load_benchmark(str(tmp_path)), str(tmp_path)


def run_tiny(bench, root, cell, seed=1234567890123, seconds=0.3, traced=False):
    import time

    import torch

    from pmdbench import harness

    run = harness.CellRun(bench, cell, seed, seconds, traced, torch.device("cpu"),
                          time.perf_counter(), here=os.path.join(root, "pmdbench"), root=root)
    return run.run()
