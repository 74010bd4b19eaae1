#!/usr/bin/env python3
"""Throughput of the PyTorch port (``localmd_tpu_torch``) on one NVIDIA GPU.

bench.py's configuration (bench.py:66-85; its second leg, bench.py:365-390,
for the 1024² cell; the JAX package's voltage workload,
scripts/bench_workloads.py:34-42, for the multi-window cell) on
bench.make_movie's movie (bench.py:23-63), made on the card from a seeded
``torch.Generator``: rank-16 white factors + N(0, 1) noise, uint16 as
clip(40 x + 1000) (``MOVIE_RANGES`` gives the other dtypes').

    python3 bench_torch.py [--cell 512_f32|1024_u16|voltage_f32|northstar_u16|northstar_i16|all]
                           [--runs 10]
                           [--profile] [--small-eigh k4|cusolver] [--routes auto|off|both]
                           [--profile-cold]

Per cell: one cold call of ``localmd_decomposition``, then ``--runs`` warm
calls, each timed on the host clock around work that ends in
``torch.cuda.synchronize()``. Prints one JSON line per cell: cold and warm
seconds (median and quartiles), Mpf/s at the median, per-stage medians of
``pipeline_timings``, peak allocated GiB, ``pipeline_ranks`` with the kept
rank beside them, the windows each block batch ran (an early stop shows as
fewer than ``n_windows``), each kernel's launches per warm call, and the
card's name and power limit.
``--profile`` adds one warm call under ``torch.profiler``:
device busy ms (union of kernel intervals), idle share, the kernels
with the most device time, and the device time of each of K1-K4. ``--small-eigh cusolver`` sends the small
eighs that go to K4 (k <= 64) to ``torch.linalg.eigh`` instead, to set the
two side by side in one call.

``--routes off`` forces the JAX package's accelerator routes off (the
coset block stage, the banded Gram and the cell-packed V projection, which
"auto" runs on the card), ``--routes both`` runs each cell once each way,
"auto" first; the JSON line names the setting. ``--profile-cold`` runs
the first cell's cold call, the process's first, under the profiler (the
JSON line's ``cold_profile``): its CUDA runtime calls, ``cudaLaunchKernel``
among them (a kernel's first launch loads its module), show where a cold
call's time goes (``chip_smoke.py`` phase 11 times cold calls in fresh
processes).

``northstar_u16`` is the JAX package's north-star workload
(bench_northstar.py:118-131): bench.make_movie's uint16 construction at
512 x 512 x 30000, written to a raw file in a temporary directory (removed
at the end) and run from disk with ``num_workers=4``, once with the device
movie cache ("auto") and once without it. Per setting: a cold call,
``--runs`` timed calls (three by default for this cell), and with
``--profile`` one more under the profiler. Beside the walls it reports the
cached frames, the GB copied host->device (the loader's pinned copies),
the file's write rate, and the disk-read and pinned host->device rates
measured alone. With less free disk than the file and ~3 GB of outputs
need (half the free space at most), T is cut, to no fewer than 8192
frames. ``northstar_i16`` is the same cell on the int16 construction
(clip(40 x - 100): negative samples, as ScanImage data near its PMT
offset) written as an int16 raw file, the format most two-photon data
arrives in; each leg also reports the GB the native reader read and the
loader's stream dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py:66-85
MAIN_CONFIG = dict(
    frame_range=1024, max_components=20, background_rank=15,
    temporal_avg_factor=10, sim_iters=250, seed=0, rank_prune=True,
)
BLOCKS = (32, 32)

# name -> (d1, d2, T, dtype, settings over MAIN_CONFIG and BLOCKS). The
# second cell is bench.py's second leg (bench.py:365-390): blocks 40 and
# frame_range 512. Its block_batch_size=64 only fitted a 16 GB TPU and is
# left at the default. The third is the JAX package's voltage workload
# (scripts/bench_workloads.py:34-42): 4000 init frames in two 2000-frame
# windows, so the block stage runs the multi-window loop; no rank_prune.
CELLS = {
    "512_f32": (512, 512, 2048, "float32", {}),
    "1024_u16": (1024, 1024, 4096, "uint16", dict(blocks=(40, 40), frame_range=512)),
    "voltage_f32": (256, 256, 20000, "float32",
                    dict(frame_range=4000, window_chunks=2000, rank_prune=False)),
}


# bench_northstar.py:118-131: the JAX package's north star, a 512 x 512 x
# 30000 uint16 movie streamed from a raw file
NORTHSTAR_SHAPE = (30000, 512, 512)
NORTHSTAR_BLOCKS = (32, 32)
NORTHSTAR_CONFIG = dict(
    frame_range=4096, max_components=20, background_rank=15, temporal_avg_factor=10,
    sim_iters=250, seed=0, rank_prune=True, num_workers=4,
)
NORTHSTAR_MIN_FRAMES = 8192
OUTPUT_RESERVE_BYTES = 3e9
NORTHSTAR_CELLS = {"northstar_u16": "uint16", "northstar_i16": "int16"}

# make_movie's integer constructions: dtype -> (scale, offset, lo, hi), the
# movie clip(scale x + offset, lo, hi) truncated toward zero. The float
# dtypes take x itself.
MOVIE_RANGES = {
    "uint16": (40.0, 1000.0, 0, 65535),        # bench.make_movie's own
    "int16": (40.0, -100.0, -32768, 32767),   # negative samples occur
    "uint8": (8.0, 128.0, 0, 255),
    "int8": (8.0, 0.0, -128, 127),
}


def northstar_frames(directory: str, t: int = NORTHSTAR_SHAPE[0]):
    """(frames, cut line or None): the most frames up to ``t`` whose raw file
    plus ~3 GB of outputs fit in half the free space of ``directory``; raises
    when even 8192 frames do not fit."""
    _, d1, d2 = NORTHSTAR_SHAPE
    free = shutil.disk_usage(directory).free
    fit = int((free / 2 - OUTPUT_RESERVE_BYTES) // (d1 * d2 * 2))
    if fit >= t:
        return t, None
    if fit < NORTHSTAR_MIN_FRAMES:
        raise RuntimeError(
            f"{directory}: {free / 1e9:.1f} GB free holds fewer than {NORTHSTAR_MIN_FRAMES} "
            "north-star frames plus outputs in half of it"
        )
    return fit, (f"north-star movie cut to T = {fit} frames (of {t}): {free / 1e9:.1f} GB "
                 f"free in {directory}, half of it holds the file plus ~3 GB of outputs")


def write_movie_file(path: str, t: int, seed: int = 0, piece: int = 2048, dtype="uint16"):
    """bench.make_movie's ``dtype`` construction at 512 x 512 x ``t``, made
    on the card in ``piece``-frame pieces from a seeded torch.Generator and
    written to ``path``. Returns (the movie on the card, seconds of the
    write including the copies off the card)."""
    import torch

    _, d1, d2 = NORTHSTAR_SHAPE
    movie, _ = make_movie(dtype, d1, d2, t, seed=seed, piece=piece)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(path, "wb") as fh:
        for s in range(0, t, piece):
            fh.write(movie[s : s + piece].cpu().numpy().tobytes())
    return movie, time.perf_counter() - t0


def stream_legs(path: str, t: int, frames: int = 2048, dtype="uint16") -> dict:
    """The two legs of streaming measured alone (bench_northstar.py:48-80):
    reading ``frames`` frames from the file into a pinned buffer through the
    loader's reader (4 threads; the page cache included, as the pipeline's
    reads see it), and copying that pinned buffer to the card."""
    import torch

    from localmd_tpu_torch.dataset import RawBinaryArray

    _, d1, d2 = NORTHSTAR_SHAPE
    src = RawBinaryArray(path, (t, d1, d2), dtype)
    src.set_io_threads(4)
    n = min(frames, t)
    host = torch.empty((n, d1, d2), dtype=getattr(torch, dtype), pin_memory=True)
    t0 = time.perf_counter()
    src.read_into(slice(t - n, t), host.numpy())
    disk_s = time.perf_counter() - t0
    dev = torch.empty_like(host, device="cuda")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    nbytes = host.numel() * host.element_size()
    return dict(disk_read_GBps=nbytes / disk_s / 1e9,
                pinned_h2d_GBps=nbytes / float(np.median(times[1:])) / 1e9)


NATIVE_READS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def count_native_reads() -> None:
    """Count the native reader's scatter reads (calls, bytes, seconds
    inside them) in ``NATIVE_READS``: a dataset reads through it only where
    the host buffer has the file's dtype (``dataset._MemmapFrames.read_into``)."""
    from localmd_tpu_torch.io.native import FastReader

    if getattr(FastReader.read_scatter, "counted", False):
        return
    read = FastReader.read_scatter

    def counted(self, offsets, sizes, out):
        t0 = time.perf_counter()
        try:
            return read(self, offsets, sizes, out)
        finally:
            NATIVE_READS["calls"] += 1
            NATIVE_READS["bytes"] += int(sum(sizes))
            NATIVE_READS["seconds"] += time.perf_counter() - t0

    counted.counted = True
    FastReader.read_scatter = counted


def bench_northstar(runs: int, with_profile: bool, card: str, cell: str = "northstar_u16") -> dict:
    """A north-star cell: from a raw file, cache "auto" and False."""
    import torch

    from localmd_tpu_torch.dataset import RawBinaryArray
    from localmd_tpu_torch.ops import kernels

    dtype = NORTHSTAR_CELLS[cell]
    count_native_reads()
    tmp = tempfile.mkdtemp(prefix="northstar_")
    try:
        t, cut = northstar_frames(tmp)
        if cut:
            print(cut, flush=True)
        _, d1, d2 = NORTHSTAR_SHAPE
        path = os.path.join(tmp, f"movie.{dtype}.raw")
        movie, write_s = write_movie_file(path, t, dtype=dtype)
        del movie
        torch.cuda.empty_cache()
        nbytes = t * d1 * d2 * np.dtype(dtype).itemsize
        out = dict(cell=cell, shape=[t, d1, d2], dtype=dtype, card=card,
                   settings=NORTHSTAR_CONFIG, file_GB=nbytes / 1e9, write_GBps=nbytes / write_s / 1e9,
                   legs=stream_legs(path, t, dtype=dtype))
        for cache in ("auto", False):
            dataset = RawBinaryArray(path, (t, d1, d2), dtype)
            settings = dict(NORTHSTAR_CONFIG, cache_movie=cache)
            _, cold, _ = timed_run(dataset, blocks=NORTHSTAR_BLOCKS, **settings)
            walls, stages, peak = [], {}, 0.0
            kernels.reset_launch_counts()
            NATIVE_READS.update(calls=0, bytes=0)
            for _ in range(runs):
                pmd, secs, peak_i = timed_run(dataset, blocks=NORTHSTAR_BLOCKS, **settings)
                walls.append(secs)
                peak = max(peak, peak_i)
                for k, v in pmd.pipeline_timings.items():
                    stages.setdefault(k, []).append(v)
            q1, med, q3 = (float(x) for x in np.percentile(walls, [25, 50, 75]))
            streamed = pmd.pipeline_cache["pinned_bytes"] / 1e9
            leg = dict(
                cold_s=cold, warm_s=walls, warm_median_s=med, warm_q1_s=q1, warm_q3_s=q3,
                mpf_per_s=d1 * d2 * t / med / 1e6,
                stage_median_s={k: float(np.median(v)) for k, v in stages.items()},
                cached_frames=pmd.pipeline_cache["cached_frames"],
                pinned_copies=pmd.pipeline_cache["pinned_copies"], streamed_GB=streamed,
                achieved_GBps=streamed / med, peak_gib=peak, ranks=pmd.pipeline_ranks,
                kept_rank=pmd.rank,
                launches_per_call={k: n / runs for k, n in kernels.launch_counts().items()},
                native_read_GB_per_call=NATIVE_READS["bytes"] / runs / 1e9,
                stream_dtype=pmd.pipeline_cache.get("stream_dtype"),
            )
            del pmd
            if with_profile:
                prof = profile_run(dataset, dict(settings, blocks=NORTHSTAR_BLOCKS))
                prof["idle_share_at_median_wall"] = 1.0 - prof["device_busy_ms"] / (med * 1e3)
                leg["profile"] = prof
            out["cache_" + str(cache).lower()] = leg
            torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _smooth_unit(x, n_dims: int, width: int, passes: int = 3):
    """Box-filter the trailing ``n_dims`` dims of (k, ...) ``x`` ``passes``
    times (about a Gaussian of sigma width/2), then scale each row to unit
    std."""
    import torch.nn.functional as F

    pool = F.avg_pool2d if n_dims == 2 else F.avg_pool1d
    y = x.unsqueeze(1)
    for _ in range(passes):
        y = pool(y, width, stride=1, padding=width // 2, count_include_pad=False)
    flat = y.squeeze(1).reshape(y.shape[0], -1)
    return (flat - flat.mean(1, keepdim=True)) / flat.std(1, keepdim=True)


def make_movie(dtype: str, d1=512, d2=512, t=2048, rank=16, seed=0, smooth=False,
               device="cuda", piece=512):
    """bench.make_movie's construction made on ``device``: spatial
    (d1*d2, rank) and temporal (rank, t) factors of unit-variance normals,
    x = (spatial @ temporal).T + N(0, 1); the movie is x in a float dtype
    and clip(scale x + offset) truncated in an integer one
    (``MOVIE_RANGES``: uint16 as bench.make_movie's clip(40 x + 1000),
    int16 as clip(40 x - 100), uint8 as clip(8 x + 128), int8 as
    clip(8 x)). Filled ``piece`` frames at a time.

    ``smooth=True`` box-filters the factors (9 pixels, 9 frames, three
    passes) so they are smoother than the noise, like footprints and
    calcium traces. PMD keeps such components; white factors look like
    noise to its roughness test. Returns (movie, clean_fn), clean_fn(frames)
    giving the noiseless frames in movie units."""
    import torch

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    spatial = torch.randn(d1 * d2, rank, generator=g, device=dev)
    temporal = torch.randn(rank, t, generator=g, device=dev)
    if smooth:
        spatial = _smooth_unit(spatial.T.reshape(rank, d1, d2), 2, 9).T
        temporal = _smooth_unit(temporal, 1, 9)
    scale, offset, lo, hi = MOVIE_RANGES.get(dtype, (1.0, 0.0, None, None))
    movie = torch.empty((t, d1, d2), dtype=getattr(torch, dtype), device=dev)
    for s in range(0, t, piece):
        chunk = (spatial @ temporal[:, s : s + piece]).T.reshape(-1, d1, d2)
        chunk += torch.randn(chunk.shape, generator=g, device=dev)
        if dtype in MOVIE_RANGES:
            chunk = (chunk * scale + offset).clamp(lo, hi)
        movie[s : s + piece] = chunk.to(movie.dtype)

    def clean(frames):
        return (spatial @ temporal[:, frames]).T.reshape(-1, d1, d2) * scale + offset

    return movie, clean


# the JAX package's accelerator routes in the port, by module and flag
ROUTE_FLAGS = (("engine", "COSET_STAGE"), ("blocksparse", "BANDED_GRAM"),
               ("blocksparse", "COSET_VPROJ"))


def set_routes(value) -> None:
    """Set every route flag to ``value``: "auto" (the package's default, on
    for the card) or False (the gather and canvas forms and K2)."""
    import importlib

    for module, flag in ROUTE_FLAGS:
        setattr(importlib.import_module(f"localmd_tpu_torch.{module}"), flag, value)


def timed_run(movie, blocks=BLOCKS, **settings):
    """One ``localmd_decomposition`` call on the card with bench.py's
    configuration, ``settings`` overriding it: (pmd, seconds, peak GiB)."""
    import torch

    from localmd_tpu_torch import localmd_decomposition

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pmd = localmd_decomposition(movie, blocks, device="cuda", **{**MAIN_CONFIG, **settings})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return pmd, seconds, torch.cuda.max_memory_allocated() / 2**30


# the port's kernels by the names of their device functions (csrc/*.cu)
PORT_KERNEL_NAMES = {
    "movie_stats": ("movie_stats_wgmma_kernel",),
    "v_projection": ("vproj_wgmma_kernel", "vproj_reduce_kernel", "projector_t_kernel"),
    "block_reconstruct": ("recon_gather_kernel",),
    "jacobi_eigh": ("jacobi_warp_kernel", "jacobi_cta_kernel"),
}


# CUDA runtime calls that can block the host: syncs, copies (one from
# pageable memory first waits for its stream), allocations, and launches
# (a kernel's first launch loads its module: the cold call's cost)
HOST_RUNTIME_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
                      "cudaMemcpyAsync", "cudaMemcpy", "cudaMalloc", "cudaFree", "cudaHostAlloc",
                      "cudaLaunchKernel")


def profile_run(movie, settings: dict, top: int = 12) -> dict:
    """One warm call under torch.profiler: wall, device busy time (union of
    kernel intervals), idle share, the kernels with most device time, the
    device time of each of the port's four kernels, each kind of device
    copy (``Memcpy HtoD`` and the others: count and device ms), and the
    CUDA runtime calls that can hold the host (count and host ms each)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _ = timed_run(movie, **settings)
    spans, by_name, host, copies = [], {}, {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name in HOST_RUNTIME_CALLS:
                n, us = host.get(e.name, (0, 0.0))
                host[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        if e.name.startswith("Memcpy"):
            n, us = copies.get(e.name, (0, 0.0))
            copies[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    busy_us, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        profiled_wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
        idle_share_profiled=1.0 - busy_us / 1e3 / (wall * 1e3), n_kernels=len(spans),
        top_kernels_ms=[[name[:90], us / 1e3] for name, us in ranked],
        port_kernels_ms={
            kernel: sum(us for name, us in by_name.items() if any(f in name for f in funcs)) / 1e3
            for kernel, funcs in PORT_KERNEL_NAMES.items()
        },
        device_copies={name: [n, us / 1e3] for name, (n, us) in sorted(copies.items())},
        host_runtime_calls={name: [n, us / 1e3] for name, (n, us) in sorted(host.items())},
    )


def bench_cell(name: str, runs: int, with_profile: bool, card: str,
               profile_cold: bool = False) -> dict:
    """A cold call (under the profiler with ``profile_cold``), then ``runs``
    warm calls."""
    import torch

    from localmd_tpu_torch.ops import kernels

    d1, d2, t, dtype, settings = CELLS[name]
    movie, _ = make_movie(dtype, d1, d2, t)
    cold_profile = None
    if profile_cold:
        cold_profile = profile_run(movie, settings)
        cold = cold_profile["profiled_wall_ms"] / 1e3
    else:
        _, cold, _ = timed_run(movie, **settings)
    walls, stages, peak = [], {}, 0.0
    kernels.reset_launch_counts()
    for _ in range(runs):
        pmd, secs, peak_i = timed_run(movie, **settings)
        walls.append(secs)
        peak = max(peak, peak_i)
        for k, v in pmd.pipeline_timings.items():
            stages.setdefault(k, []).append(v)
    q1, med, q3 = (float(x) for x in np.percentile(walls, [25, 50, 75]))
    out = dict(
        cell=name, shape=[t, d1, d2], dtype=dtype, settings=settings, card=card, cold_s=cold,
        warm_s=walls, warm_median_s=med, warm_q1_s=q1, warm_q3_s=q3,
        mpf_per_s=d1 * d2 * t / med / 1e6,
        stage_median_s={k: float(np.median(v)) for k, v in stages.items()},
        peak_gib=peak, ranks=pmd.pipeline_ranks, kept_rank=pmd.rank,
        windows=pmd.pipeline_windows,
        launches_per_call={k: n / runs for k, n in kernels.launch_counts().items()},
    )
    if cold_profile is not None:
        out["cold_profile"] = cold_profile
    if with_profile:
        prof = profile_run(movie, settings)
        prof["idle_share_at_median_wall"] = 1.0 - prof["device_busy_ms"] / (med * 1e3)
        out["profile"] = prof
    del movie, pmd
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="all", choices=["all", *CELLS, *NORTHSTAR_CELLS])
    ap.add_argument("--runs", type=int, default=None,
                    help="warm calls per cell (default 10; 3 for the north-star cells)")
    ap.add_argument("--profile", action="store_true",
                    help="add one warm call under torch.profiler")
    ap.add_argument("--small-eigh", default="k4", choices=["k4", "cusolver"],
                    help="route of the eighs with k <= 64 (default: K4, as the package does)")
    ap.add_argument("--routes", default="auto", choices=["auto", "off", "both"],
                    help="the accelerator routes (coset block stage, banded Gram, cell V "
                         "projection): the package's default, forced off, or each cell "
                         "once with each (default: auto)")
    ap.add_argument("--profile-cold", action="store_true",
                    help="run the process's cold call (the first cell's) under torch.profiler: "
                         "its runtime calls, a kernel's first launch included")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available; this benchmark needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import logging

    from localmd_tpu_torch import config
    from localmd_tpu_torch.utils.logging import get_logger

    config.apply()
    get_logger().setLevel(logging.WARNING)
    if args.small_eigh == "cusolver":
        from localmd_tpu_torch.ops import linalg

        linalg.uses_jacobi = lambda device, k: False
    card = card_line()
    profile_cold = args.profile_cold     # the process's first cold call only
    for name in [*CELLS, *NORTHSTAR_CELLS] if args.cell == "all" else [args.cell]:
        for routes in (("auto", "off") if args.routes == "both" else (args.routes,)):
            set_routes("auto" if routes == "auto" else False)
            if name in NORTHSTAR_CELLS:
                out = bench_northstar(args.runs or 3, args.profile, card, name)
            else:
                out = bench_cell(name, args.runs or 10, args.profile, card, profile_cold)
            profile_cold = False
            out["small_eigh"] = args.small_eigh
            out["routes"] = routes
            print(json.dumps(out), flush=True)
    set_routes("auto")
    return 0


if __name__ == "__main__":
    sys.exit(main())
