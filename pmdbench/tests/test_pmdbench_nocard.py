"""Without a card the benchmark fails and prints no result: it never
falls back to the CPU. The same in a directory that holds only
BENCHMARK.json and the benchmark's files."""

import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "pmdbench/run.py", "--workload", "northstar_u16.stream",
                           "--seed", "4294967301", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "pmdbench"), tmp_path / "pmdbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_cell_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "pmdbench/run.py", "--workload", "no_such.cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
