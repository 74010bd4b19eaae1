"""Finds what a cell needs by name: its configuration (``BENCHMARK.json``'s
``configs`` entry and the file it names), its traffic mix
(``traffic/<name>.json``), the limits of its check (``limits/<cell>.json``)
and the reader of each metric it reports (``metrics/<metric>.py``, or the
file of the name's first part). A new
cell, configuration, traffic mix or metric is new files and new entries in
``BENCHMARK.json``; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _named(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, as run."""
    entry = _named(bench["configs"], name, "config")
    with open(os.path.join(root, entry["file"])) as fh:
        return json.load(fh)


def _data(kind: str, name: str, here: str) -> dict:
    with open(os.path.join(here, kind, f"{name}.json")) as fh:
        return json.load(fh)


def traffic(name: str, here: str = HERE) -> dict:
    return _data("traffic", name, here)


def limits(cell_name: str, here: str = HERE) -> dict:
    return _data("limits", cell_name, here)


def peaks(here: str = HERE) -> dict:
    with open(os.path.join(here, "peaks.json")) as fh:
        return json.load(fh)


def metrics_of(bench: dict, cell_name: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it under ``workloads``, or list no cells."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str, here: str = HERE):
    """``metrics/<name>.py``'s ``read(run) -> float | None``; a dotted name
    with no file of its own (``stats_s.stream``) is read by the file of its
    first part (``metrics/stats_s.py``)."""
    path = os.path.join(here, "metrics", f"{metric_name}.py")
    if not os.path.exists(path):
        path = os.path.join(here, "metrics", f"{metric_name.split('.')[0]}.py")
    module_name = "pmdbench_metric_" + metric_name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
