#!/usr/bin/env python3
"""Readings that set the limits of a cell's check: the program's numbers
over many seeds (the lower readings) and the control's and a planted
fault's (the upper ones), at the cell's own size, in one process.

    python3 pmdbench/readings.py --workload <cell> --seeds 11,12,13 [--out FILE]

Per seed, one ``localmd_decomposition`` call on the cell's movie (held as
the cell's traffic holds it), one with the program's own lower-precision
path (``matmul_precision="tensorfloat32"``) and one with the block stage
keeping half its components (``faults.half_blocks``), then one reference
pass in float64 and in TF32. Prints one JSON line per seed:

- ``program``: the cell's numbers for the program as configured;
- ``control``: the reference in TF32 put in the program's place -- its
  mean and noise images and its least-squares coefficients, judged
  against the float64 reference;
- ``program_tf32``: the program with its TF32 path on;
- ``half_blocks``: the program with half of each block's components;
- ``vreg_std_first_tf32``: ``vreg_gap`` of a regression that standardizes
  each frame before one TF32 product with the basis.

For a ``view`` cell each line also holds the widest ``view_gap`` over
the seed's first ``sample`` requests: ``view_program`` (the program's
slicing), ``view_program_tf32`` (its slicing with TF32 on) and
``view_control`` (the reference's frames in TF32). The benchmark's runs
do not run this script.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _view_gaps(pmd, dc, requests, d2, precision_program: str) -> list:
    import torch

    from pmdbench import traffic
    from pmdbench.reference import frames as ref_frames

    tf32 = precision_program == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        got = [pmd[traffic.request_key(r)] for r in requests]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    return [ref_frames.gap(torch.as_tensor(g, device=dc.a.device),
                           ref_frames.served(dc.a, dc.c, dc.mean, dc.std, d2, r), dc.mean, d2, r)
            for g, r in zip(got, requests)]


def readings(cell_name: str, seed: int, dev, root: str = ROOT) -> dict:
    import torch

    from pmdbench import catalog, faults, harness, traffic
    from pmdbench.reference import frames as ref_frames
    from pmdbench.reference import projection as ref_projection

    bench = catalog.load_benchmark(root)
    run = harness.CellRun(bench, cell_name, seed, 0.0, False, dev, time.perf_counter(),
                          here=os.path.join(root, "pmdbench"), root=root)
    harness.import_port(dev)
    import localmd_tpu_torch

    run.port = localmd_tpu_torch
    movie = run._movie()
    on_host = run.mix.get("movie_on") == "host"
    source = movie.to_host() if on_host else movie.to_card()

    def fresh():
        return traffic.host_movie(source) if on_host else source.view(source.shape)

    t0 = time.perf_counter()
    pmd = run._call(fresh())
    wall = time.perf_counter() - t0
    block_sizes, settings = harness._settings(run.cfg)
    settings["matmul_precision"] = "tensorfloat32"
    pmd_tf = localmd_tpu_torch.localmd_decomposition(fresh(), block_sizes, device=dev, **settings)
    with faults.half_blocks():
        pmd_half = run._call(fresh())
    with faults.half_grid():
        pmd_grid = run._call(fresh())
    out = dict(cell=cell_name, seed=seed, call_s=wall, ranks=pmd.pipeline_ranks,
               ranks_half_blocks=pmd_half.pipeline_ranks)
    dcs = [harness.Decomposition(harness.factors(p), movie.shape, dev)
           for p in (pmd, pmd_tf, pmd_half, pmd_grid)]
    if run.mix["kind"] == "view":
        requests = traffic.view_requests(run.mix, movie.shape, seed)[: int(run.mix["sample"])]
        d2 = movie.shape[2]
        out["view_program"] = max(_view_gaps(pmd, dcs[0], requests, d2, "float64"))
        out["view_program_tf32"] = max(_view_gaps(pmd, dcs[0], requests, d2, "tf32"))
        dc = dcs[0]
        out["view_control"] = max(
            ref_frames.gap(ref_frames.served(dc.a, dc.c, dc.mean, dc.std, d2, r, "tf32"),
                           ref_frames.served(dc.a, dc.c, dc.mean, dc.std, d2, r), dc.mean, d2, r)
            for r in requests)
    del pmd, pmd_tf, pmd_half, pmd_grid
    gc.collect()
    torch.cuda.empty_cache()
    chunk_of = harness._chunks_from(source, movie, dev)
    refs = harness.reference_pass(dcs, chunk_of, movie.shape, dev, ("float64", "tf32"))
    r64, r32 = refs["float64"], refs["tf32"]
    one = lambda r, k: dict(mean=r["mean"], noise=r["noise"], best=[r["best"][k]],  # noqa: E731
                            proj=[r["proj"][k]])
    footprints = movie.footprints()
    out["program"] = harness.decomposition_numbers(dcs[:1], one(r64, 0), footprints)
    out["program_tf32"] = harness.decomposition_numbers(dcs[1:2], one(r64, 1), footprints)
    out["half_blocks"] = harness.decomposition_numbers(dcs[2:3], one(r64, 2), footprints)
    out["half_grid"] = harness.decomposition_numbers(dcs[3:], one(r64, 3), footprints)
    out["control"] = harness.decomposition_numbers(
        dcs[:1], one(r64, 0), footprints, outputs=[(r32["mean"], r32["noise"], r32["best"][0])])
    out["control"]["vreg_gap"] = float(
        ref_projection.coefficient_gaps(r64["proj"][0], r32["proj"][0]).max())
    out["vreg_std_first_tf32"] = float(ref_projection.coefficient_gaps(
        r64["proj"][0], _std_first_tf32(dcs[0], chunk_of, movie.shape)).max())
    return out


def _std_first_tf32(dc, chunk_of, shape):
    """A^T Y_std with each frame standardized in float32 before one TF32
    product with the basis."""
    import torch

    from pmdbench.reference.precision import products
    from pmdbench.reference.stats import CHUNK_FRAMES

    t, d1, d2 = shape
    a = dc.a.to(torch.float32)
    mean, std = dc.mean.to(torch.float32), dc.std.to(torch.float32)
    out = torch.empty((a.shape[1], t), dtype=torch.float32, device=a.device)
    with products("tf32"):
        for start in range(0, t, CHUNK_FRAMES):
            stop = min(start + CHUNK_FRAMES, t)
            y = chunk_of(start, stop).reshape(-1, d1 * d2).to(torch.float32)
            out[:, start:stop] = (((y - mean) / std) @ a).T
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, dev))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
