#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``localmd_tpu_torch``) on one NVIDIA GPU.

Phases (each prints one progress line; any failure raises, exit code != 0):

0. device: require CUDA, print the card, power limit and versions; TF32 off.
1. build: compile the four CUDA kernels from ``localmd_tpu_torch/csrc``
   (one nvcc per source, all at once).
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the paths' shapes plus edge cases (offset uint16 inputs for the
   3xTF32 kernels K1 and K2; K1 and K2 also on int16, uint8, int8, float16
   and bfloat16 chunks at the paths' shapes, with each type's extremes, an
   offset baseline, P and d off the 16-byte chunk and a base off 16-byte
   alignment, and each dtype's time and bytes read beside float32's and
   uint16's), with CUDA-event times, each beside its bound
   on this card and, where one PyTorch call computes the same function,
   that call's time (K2: ``torch.matmul``; K4: cuSOLVER's
   ``torch.linalg.eigh``, timed in alternation with K4 at every shape of
   ``K4_SHAPES``, and also its float64 eigenvalues as K4's reference; K3:
   ``torch.sparse.mm`` of a CSR U built once from the same panels, held to
   K3's plain twin at 1e-5); K3 is timed at each case it checks, with its
   block lists prepared once as the path keeps them.
3. golden: the port on the golden movie with the committed injected
   sketches and pinned thresholds, against tests/golden/reference_golden.npz
   (K4 on the path: every small eigh; its 40 x 36 grid has a snapped tail,
   so the V regression takes K2); then the same construction at a regular
   40 x 40, every accelerator route on against every route off (<= 1e-5),
   each route seen to run.
4. main path: ``localmd_decomposition`` on bench.make_movie's 512 x 512 x
   2048 float32 movie made on the card (bench.py's configuration), once
   cold and three times warm with the routes at "auto" (the coset block
   stage, the banded Gram and the cell V projection all run; K2 does not),
   then ``reconstruct_frames`` on 512 frames, twice (the first call also
   builds K3's block lists), then three warm calls with the routes forced
   off: each side's warm median and route stages, equal ranks, equal K4
   launches across a side's warm calls.
5. the same movie as uint16, once, and bench.py's second leg (1024 x 1024
   x 4096 uint16, blocks 40: a snapped tail, so K2 reads the uint16 chunks
   and the coset stage runs its lattices plus one gathered batch), once.
6. denoising: the same construction with smoothed factors, float32 and
   uint16, once each; the reconstruction must be closer to the clean movie
   than the raw frames.
7. the multi-window path: the JAX package's voltage workload
   (scripts/bench_workloads.py:34-42) on bench.make_movie's construction at
   256 x 256 x 20000 float32, once cold and three times warm, then three
   warm calls with the routes forced off (the banded Gram and the cell V
   projection against the canvas Gram and K2, timed as in phase 4), then
   with smoothed factors once: shape, ranks, at least one residual window,
   finite frames through K3, the kernels and routes launched, and
   denoising on the smoothed movie.
8. from disk: the JAX package's north star (bench_northstar.py:118-131),
   bench.make_movie's uint16 construction at 512 x 512 x 30000 (15.7 GB)
   written to a raw file in a temporary directory (removed at the end; T
   is cut, to no fewer than 8192 frames, when half the free space cannot
   hold the file and ~3 GB of outputs; the file stays for phase 11). The
   same movie runs card-resident, then from the file with the device movie
   cache (twice: the second call must cache as many frames, its plan
   reading the first call's freed cache as free) and without it: equal
   statistics and ``pipeline_ranks``, 512 sampled frames within 1e-5, frames
   cached, pinned copies made, the native reader in use; then device
   slicing against the host path on five keys, ``export_tiff`` read back
   exactly, ``close(materialize=False)`` freeing the factors, and the CLI
   (compress, info, export) in subprocesses against an in-process run.
9. the call's options and the quality tools at full width:
   ``sim.two_photon_movie(512, 512, 2048)`` made on the card; ``PMDLoader``
   with the JAX package's parameters on it (no ``device``: the card; the
   float64 crops; from the host at ``cache_fraction`` 0.5 and 0.25 with
   the free memory held near 3.5 GiB: at most half the frames cached at
   0.25, the statistics bit-equal, K1 launched in both); the movie run with
   bench.py's configuration, then ``metrics`` (compression ratio, both
   relative errors, the residual-to-noise ratio in (0.3, 3)) and
   ``compute_qc_images`` with the PMDArray as source (K3); the factorized
   SVD with the decomposition's U as scipy CSR against its
   ``BlockSparseMatrix`` (``s`` within 1e-5 relative); the same movie
   with the torch denoiser pair (finite, rank >= 1, K1 and K4 launched,
   the gather block stage), and the golden movie with the denoisers and the committed
   sketches on the card against the CPU (<= 1e-4); the same movie with
   ``matmul_precision="tensorfloat32"`` (``rel_error_centered`` within 1.1x
   of the "highest" run's, the setting restored), with ``profile_dir`` (a
   Chrome trace with CUDA kernel events), the .npz round trip through
   ``load_decomposition`` with no device (on the card, <= 1e-5 of the
   in-process frames), and ``widefield_movie()`` and ``voltage_movie()``
   made on the card, timed.
10. the mesh path (``parallel``): bench.py's configuration on its
   512 x 512 x 2048 float32 movie, made on the card in every rank, first
   in this process on one device (cold, then warm: the reference, with the
   forms the mesh path takes: the gather block stage, and the canvas Gram
   for one rank or the banded Gram for two), then
   with ``mesh=parallel.make_mesh()`` in two launches of ranks, each rank
   a subprocess of this script with a time limit: (a) one rank on NCCL,
   whose factorized SVD takes ``sharded_gram_quadratic``'s reduce-scatter
   and all-reduce; (b) two ranks on gloo sharing the one card, with the
   block stage split and both movie passes striped. Each rank runs cold,
   then warm twice, the second with the launch counts from 0, then
   ``reconstruct_frames`` on 512 sampled frames (K3). Checks:
   ``pipeline_ranks`` and the kept rank of the reference, the sampled
   frames within 1e-6 relative Frobenius of the reference's (the card gave
   them bit for bit; on this white movie a rounding change in the block
   fits moves the kept subspace by ~1e-3), every rank's factors equal to
   rank 0's bit for bit, K1, K3 and K4 and the cell V projection (in K2's
   place) launched in every rank; prints each rank's warm wall time and
   stages beside the reference's.
11. cold calls in fresh processes: the north star from phase 8's raw file
   (the page cache warm) and bench.py's 512 x 512 x 2048 float32 cell made
   on the card, each in three timed processes (``aot_warm`` "auto", True,
   False: ``COLD_AOT_WARM``) and one more whose cold call runs under the
   autograd profiler with CUDA activity alone, for its ``cudaLaunchKernel``
   time (its walls are left out of the medians); each process (a
   ``--cold-call`` subprocess of this script, the kernels already built)
   makes one cold call and one warm call. Checks: 512 sampled frames,
   ``pipeline_ranks``, the kept rank and the thresholds equal bit for bit
   across the processes and settings of a cell; ``pipeline_aot`` and
   ``pipeline_warm`` the JAX package's with its warms off (the port has no
   stage warm), on every setting; ``torch.distributed.tensor`` loaded
   neither by the port's import nor by the call (no mesh); the north
   star's cached frames equal to phase 8's in every call. Prints each
   process's seconds from its start to the call (the port's import
   apart), the cold wall and statistics stage, ``pipeline_warm`` and
   ``pipeline_aot``, both walls and the stages, and the timed processes'
   medians with each stage's cold-minus-warm time.
12. dtypes: (a) phase 8's raw file read as int16 (its values all fit),
   cache "auto", cold and warm, against phase 8's uint16 runs: equal
   statistics and ``pipeline_ranks``, 512 sampled frames within 1e-5 (and
   whether bit-equal), 2 bytes a pixel copied to the card, as many frames
   cached, the native reader, K1 launched on int16 chunks (the dtype each
   K1/K2 launch passes to its CUDA entry point is recorded); (c) the CLI's
   ``compress --raw-dtype int16`` on that file in a subprocess against
   (a)'s warm run; (b) card-resident bench_torch.make_movie movies at
   512 x 512 x 2048 in int16, uint8, int8, float16, bfloat16 and float64,
   each against the float32 movie of the same values (equal ranks, 512
   sampled frames within 1e-5, K1 on the native dtype, float32 for
   float64), and the golden movie in each dtype, where K2 runs, likewise.
13. the demo, the grid cache and the console script: (a)
   ``demos/demo_torch.py --device cuda --no-plots`` in a subprocess on its
   sim movie at 512 x 512 x 4096 float32 (the decomposition, the .npz
   and ``load_decomposition``, ``compute_qc_images``, ``export_tiff``, the
   residual-to-noise ratio in (0.3, 3), ``close``): exit 0, its wall time,
   kept rank and ratio, K1 and K4 launched by the decomposition and K3 by
   the export; (b) bench_torch.py's 1024_u16 cell, cold and then three warm
   calls a round, P / C / C / P, P rebuilding the grid's constants per call
   as the pipeline did before the grid cached them and C reading
   ``BlockGrid.device_constants``: equal ranks and 64 sampled frames bit
   for bit across the warm calls, one upload in the first C call after
   ``clear_block_grid_cache`` and none in any other call, each side's
   median, and the bytes
   ``clear_block_grid_cache`` frees (at least the grid's constants and
   coset ids); (c) ``localmd-tpu-torch info`` on phase 8's .npz (the
   demo's without phase 8), the installed script or, where the tree is
   not installed, pyproject.toml's entry point through ``python3 -c``.
14. the card against the JAX package: every case of
   ``tests/torch_parity_cases.py`` (order C, uint16, int16 with negative
   samples, a statistics tail, rank_prune, four windows, the call options,
   a regular grid, odd geometry, ...), its movie made with numpy and passed
   as the CPU tests pass it, the sketch, the stored rank-prune matrix and
   the JAX package's thresholds injected, against the JAX package's result
   committed in ``tests/golden/torch_parity/`` (remade by
   ``tests/golden/generate_torch_parity.py``, which needs jax):
   ``reconstruct_frames`` of every frame (K3) and ``pmd[:, :, :]`` within
   1e-4 relative Frobenius, ``pipeline_ranks`` and kept rank equal,
   ``mean_img`` and ``var_img`` within rtol 1e-4. Prints each case's
   errors, ranks, the kept-rank cut's margin, launches and routes; a case
   that misses is run again with the routes off for the report. K1-K4
   each launch in the phase, ``regular_48`` takes every route and every
   irregular grid K2. ``--phases 14`` runs the build and this phase.
15. the card against the JAX package at the main path's full width:
   bench.py's configuration (blocks 32, frame_range 1024, max_components
   20, background_rank 15, temporal_avg_factor 10, sim_iters 250,
   rank_prune) on ``tests/torch_parity_full.py``'s 512 x 512 x 2048 movie
   (rank 4, noise 0.3; made on the host in 256-frame chunks), float32 with
   the routes at "auto" and forced off and uint16 at "auto", the sketch,
   the stored rank-prune matrix and the JAX package's thresholds injected,
   against the JAX package's result committed in
   ``tests/golden/torch_parity_full/`` (remade by
   ``tests/golden/generate_torch_parity_full.py``, which needs jax): the
   reconstruction's fingerprints (through ``reconstruct_frames``, K3, over
   all 2048 frames) and ``s`` within 1e-4 relative, ``mean_img`` and
   ``var_img`` within rtol 1e-4, ``pipeline_ranks`` and kept rank equal.
   Prints each run's seconds, errors, the kept-rank cut's margin,
   launches and routes and the host memory the movies took. Where a
   block's kept count differs from the JAX package's, it prints the block
   and the first component decided differently, with both packages'
   statistics beside the threshold (the JAX package's are stored); when
   every such statistic lies within 1e-4 of its threshold in both
   packages (an fp32 tie), the run is made again with the JAX package's
   decision at each tie, as its thresholds and draws are injected, and
   that run is held to every bar; any other difference is a miss. K1, K3
   and K4 launch in every run, K2 in the routes-off run, every route in
   the "auto" runs. Before the runs, the float32 movie's statistics are
   formed on the card through K1 and through its plain twin in float64,
   each printed against the fixture's images (a measurement, not a
   gate). ``--phases 15`` runs the build and this phase.
16. the card against the JAX package on the other cells ``bench_torch.py``
   times, at full width, nothing cut, the routes at "auto"
   (``tests/torch_parity_cells.py``): 1024_u16 (1024 x 1024 x 4096
   uint16, blocks 40, snapped tails) by default; ``--cells`` names others
   of voltage_f32 (256 x 256 x 20000 float32, two windows) and
   northstar_u16 (512 x 512 x 30000 uint16 written to a raw file and read
   through ``dataset.RawBinaryArray``, num_workers 4), which miss the
   bars (``OPEN_CELLS``). Each movie is made on the host chunk by chunk on
   threads and checked against the fixture's digest; every Gaussian draw
   the numpy sketch, the thresholds the JAX package's, against the
   results committed in ``tests/golden/torch_parity_cells/`` (remade by
   ``tests/golden/generate_torch_parity_cells.py``, which needs jax):
   phase 15's bars (the fingerprint, computed on the card in float64 over
   every frame through ``reconstruct_frames``, K3, with a temporal probe
   in place of psi^T Y for T > 4096; ``s``; the images at a fixed pixel
   sample past 512 x 512 pixels and through psi; ranks) and phase 15's tie
   rule per (window, block, component), with up to two reruns. Prints per
   case the JAX package's own spread (its run with every sketch moved one
   float32 ulp, a measurement), the errors, ``s`` by index, ranks, the
   cuts' margins (the kept rank's and the factorized SVD's Gram),
   launches and routes, the seconds of the call, the fingerprint and the
   movie (and its write), for the north star the native reader's GB/s and
   the share of the file in the page cache, and a routes-off run against
   the first (a measurement). ``--phases 16`` runs the build and this
   phase.

Wherever a path runs, the kernels and routes it launched are checked
against the route it should take (``expected_routes``): K2 where the cell
V projection does not run, the route's own calls where it does.

The last two lines are a JSON object with one entry per kernel (its
launches summed over the runs of phases 3, 4 (the "auto" side), 5, 7 (the
"auto" side), 8, 9, 10, 11, 12, 13, 14, 15 and 16, each counted from 0) and the result line
``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py`` (one card; phase 8
needs ~19 GB of free temporary disk, or prints its cut; phase 16's north
star 16.7 GB). ``--phases 0,1,2``
runs a subset (the result line needs all of them), ``--phases 0,1,10`` the
mesh path alone, ``--phases 0,1,11`` the cold calls alone (writing the
north star's raw file itself), ``--phases 0,1,2,8,12`` the kernels and
the dtypes, ``--phases 0,1,13`` the demo, the grid cache and the console
script; ``--frames T`` sets the raw file's T.
``--mesh-rank`` and ``--cold-call`` are the entry points of phase 10's rank
processes and phase 11's cold-call processes.
Repeated warm timings and a profile: ``bench_torch.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "reference_golden.npz")
GOLDEN_SKETCHES = os.path.join(HERE, "tests", "golden", "torch_port_sketches.npz")

KERNELS = {
    "movie_stats": ("localmd_tpu_torch/csrc/movie_stats.cu",
                    "localmd_tpu/ops/pallas_kernels.py:120"),
    "v_projection": ("localmd_tpu_torch/csrc/v_projection.cu",
                     "localmd_tpu/ops/pallas_kernels.py:216"),
    "block_reconstruct": ("localmd_tpu_torch/csrc/block_reconstruct.cu",
                          "localmd_tpu/ops/pallas_kernels.py:332"),
    "jacobi_eigh": ("localmd_tpu_torch/csrc/jacobi_eigh.cu",
                    "scripts/ablate_jacobi_kernel.py:103"),
}
ALL_PHASES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
# K4's cases: the shapes the paths give it -- the rSVD Gram (256 and 225
# blocks, k = 30), svd_gram_left (k = 20), the threshold Monte-Carlo (131
# simulations, k = 11, odd), the background rSVD (k = 25) -- and k = 64
K4_SHAPES = ((256, 30), (256, 20), (131, 11), (225, 30), (1, 25), (64, 64))
K4_KINDS = ("random_psd", "rank_deficient", "repeated", "diagonal")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def rel_fro(a, b) -> float:
    import torch

    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# the accelerator routes: which ran, and which should have
# ---------------------------------------------------------------------------

ROUTE_CALLS = {"coset_stage": 0, "banded_gram": 0, "cell_vproj": 0}


def install_route_spies() -> None:
    """Count the calls of each accelerator route's function: the coset
    block stage (as the pipeline calls it), the banded Gram and the cell V
    projection's chunk product."""
    import localmd_tpu_torch.pipeline as pipeline
    from localmd_tpu_torch import blocksparse

    for name, module, attr in (("coset_stage", pipeline, "window0_coset_stage"),
                               ("banded_gram", blocksparse, "_banded_gram_quad"),
                               ("cell_vproj", blocksparse, "coset_vproj_chunk")):
        fn = getattr(module, attr)
        if getattr(fn, "route", None):
            continue

        def spy(*args, _fn=fn, _name=name, **kwargs):
            ROUTE_CALLS[_name] += 1
            return _fn(*args, **kwargs)

        spy.route = name
        setattr(module, attr, spy)


def reset_route_calls() -> None:
    for name in ROUTE_CALLS:
        ROUTE_CALLS[name] = 0


def expected_routes(d1: int, d2: int, blocks=(32, 32), single_window=True, world: int = 0,
                    spatial_avg_factor: int = 2) -> dict:
    """The routes a call takes with the flags as they are, ``world`` the
    mesh's size (0: no mesh): the coset stage for one window without a
    mesh on a grid of coset lattices whose blocks suit
    ``spatial_avg_factor`` (its memory gate aside), the banded
    Gram on a regular grid except on a one-rank mesh (whose Gram is
    ``sharded_gram_quadratic``; above one rank every rank forms the whole
    Gram, as the JAX package does) and the cell V projection on a regular
    grid."""
    from localmd_tpu_torch import blocksparse, engine
    from localmd_tpu_torch.config import route_enabled
    from localmd_tpu_torch.ops.tiling import block_grid

    regular = block_grid(d1, d2, tuple(blocks)).cell_geometry() is not None
    return {
        "coset_stage": (single_window and not world
                        and route_enabled(engine.COSET_STAGE, "cuda")
                        and engine.coset_stage_supported(blocks[0], blocks[1], spatial_avg_factor)
                        and engine.coset_stage_plan(d1, d2, *blocks) is not None),
        "banded_gram": regular and world != 1 and route_enabled(blocksparse.BANDED_GRAM, "cuda"),
        "cell_vproj": regular and route_enabled(blocksparse.COSET_VPROJ, "cuda"),
    }


def check_path(label: str, launches: dict, routes: dict, expected: dict,
               kernels_run=("movie_stats", "jacobi_eigh")) -> None:
    """Each route ran where it was expected and not elsewhere; K2 ran where
    the cell route did not; every kernel in ``kernels_run`` ran."""
    for name, want in expected.items():
        check((routes[name] > 0) == want,
              f"{label}: route {name} ran {routes[name]} times, expected {'some' if want else 'none'}")
    if expected["cell_vproj"]:
        check(launches["v_projection"] == 0, f"{label}: K2 ran beside the cell route")
    else:
        check(launches["v_projection"] > 0, f"{label}: K2 never ran")
    for name in kernels_run:
        check(launches[name] > 0, f"{label}: never launched {name}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet,
# dense): fp32 on the CUDA cores, TF32 on the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, tensor_3xtf32: bool) -> dict:
    """The least time for ``flops`` fp32-accurate operations over ``nbytes``
    moved (inputs read once, outputs written once): on the tensor cores as
    the three TF32 products of 3xTF32, or on the CUDA cores in fp32."""
    fp32_ms = flops / PEAK_FP32 * 1e3
    x3_ms = 3 * flops / PEAK_TF32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = x3_ms if tensor_3xtf32 else fp32_ms
    return dict(fp32_ms=fp32_ms, x3_ms=x3_ms, bytes_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def log_bound(label: str, ms: float, b: dict) -> None:
    log(f"  {label} bound: fp32 {b['fp32_ms']:.3f} ms, 3xTF32 {b['x3_ms']:.3f} ms, "
        f"bytes {b['bytes_ms']:.3f} ms -> {b['bound_ms']:.3f} ms ({b['bound_by']}); "
        f"kernel {ms:.3f} ms = {b['bound_ms'] / ms:.1%} of the bound")


def k3_csr(panels, starts, fov, block_shape):
    """K3's function as one sparse matrix: a CSR U of (d1 d2, N S) whose
    column n S + s holds block n's panel column s at its canvas pixels
    (C order), so that U @ temporal.reshape(N S, f) is K3's canvas."""
    import torch

    n, p, s_slots = panels.shape
    (d1, d2), (b1, b2) = fov, block_shape
    dev = panels.device
    st = torch.as_tensor(np.asarray(starts), dtype=torch.long, device=dev)
    rows = ((st[:, 0, None, None] + torch.arange(b1, device=dev)[None, :, None]) * d2
            + st[:, 1, None, None] + torch.arange(b2, device=dev)[None, None, :]).reshape(n, p, 1)
    cols = (torch.arange(n, device=dev)[:, None, None] * s_slots
            + torch.arange(s_slots, device=dev)[None, None, :])
    index = torch.stack([rows.expand(n, p, s_slots).reshape(-1),
                         cols.expand(n, p, s_slots).reshape(-1)])
    coo = torch.sparse_coo_tensor(index, panels.reshape(-1), (d1 * d2, n * s_slots))
    return coo.coalesce().to_sparse_csr()


def phase_kernels(results: dict) -> None:
    import torch

    from localmd_tpu_torch.ops import kernels
    from localmd_tpu_torch.ops.tiling import BlockGrid

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    # K1: mean max|d| / max|ref| <= 1e-5; sigma max relative error <= 1e-4.
    # A baseline of 1000 under small noise is the input a careless tf32
    # split fails on.
    t, p = 1024, 262144
    chunk_f32 = torch.randn(t, p, generator=g, device=dev) * 2.3 + 1.0
    chunk_u16 = (torch.randn(t, p, generator=g, device=dev) * 40 + 1000).clamp(0, 65535).to(torch.uint16)
    chunk_u16_3 = (torch.randn(t, p, generator=g, device=dev) * 3 + 1000).clamp(0, 65535).to(torch.uint16)
    cases = [
        ("f32 nperseg=256", chunk_f32, True, 256),
        ("uint16 nperseg=256", chunk_u16, True, 256),
        ("uint16 clip(3 N + 1000) nperseg=256", chunk_u16_3, True, 256),
        ("uint16 clip(3 N + 1000) reference nperseg=T=1024", chunk_u16_3, True, 1024),
        ("f32 nperseg=500", chunk_f32, True, 500),
        ("f32 reference nperseg=T=1024", chunk_f32, True, 1024),
        ("f32 mean only", chunk_f32, False, 256),
        ("f32 P=262107 (ragged tile)", chunk_f32[:, : p - 37].contiguous(), True, 256),
        ("f32 T=300 reference nperseg=300", chunk_f32[:300].contiguous(), True, 300),
    ]
    errs = [check_k1(name, x, nper, noise) for name, x, noise, nper in cases]
    first_err = errs[0]
    del chunk_u16, chunk_u16_3
    ms = cuda_ms(lambda: kernels.movie_stats(chunk_f32, 2048), reps=10)
    plain_ms = cuda_ms(lambda: kernels.movie_stats_plain(chunk_f32, 2048), reps=10)
    n_segs = (t - 256) // 128 + 1
    b = bound(2.0 * 128 * 256 * n_segs * p, t * p * 4 + 2 * p * 4, tensor_3xtf32=True)
    log(f"  K1 (1024, 262144) f32 nperseg 256: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    log_bound("K1 (1024, 262144) f32", ms, b)
    results["movie_stats"] = dict(max_abs_err=first_err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None)

    # K2: relative Frobenius error <= 1e-5. Both sides sum d fp32 products
    # in different orders; each split of K2 sums <= 4096 pixels.
    d, r = 262144, 300
    a = torch.randn(d, r, generator=g, device=dev) * 0.01
    c = torch.randn(r, generator=g, device=dev)
    raw_u16 = (torch.randn(t, d, generator=g, device=dev) * 40 + 1000).clamp(0, 65535).to(torch.uint16)
    a465 = torch.randn(d, 465, generator=g, device=dev) * 0.01
    c465 = torch.randn(465, generator=g, device=dev)
    cases = [("f32 (1024, 262144) r'=300", chunk_f32, a, c),
             ("uint16 (1024, 262144) r'=300", raw_u16, a, c),
             ("f32 (1024, 262144) r'=465", chunk_f32, a465, c465)]
    a_big = torch.randn(16384, 2560, generator=g, device=dev) * 0.02
    c_big = torch.randn(2560, generator=g, device=dev)
    cases.append(("f32 (1024, 16384) r'=2560", chunk_f32[:, :16384].contiguous(), a_big, c_big))
    cases.append(("uint16 (100, 701) r'=37 (unaligned rows)", raw_u16[:100, :701].contiguous(),
                  a[:701, :37].contiguous(), c[:37].contiguous()))
    cases.append(("f32 (300, 4096) r'=64, base off 16-byte alignment",
                  chunk_f32.reshape(-1)[1 : 1 + 300 * 4096].view(300, 4096),
                  a[:4096, :64].contiguous(), c[:64].contiguous()))
    for name, x, aa, cc in cases:
        check_k2(name, x, aa, cc)
    del raw_u16, chunk_f32, a, a_big, a465
    # the 1024^2 uint16 cell's call: 256-frame chunks of 1048576 pixels, r' = 168
    raw = (torch.randn(256, 1 << 20, generator=g, device=dev) * 40 + 1000).clamp(0, 65535).to(torch.uint16)
    a = torch.randn(1 << 20, 168, generator=g, device=dev) * 0.01
    c = torch.randn(168, generator=g, device=dev)
    check_k2("uint16 (256, 1048576) r'=168 (1024^2 uint16 call)", raw, a, c)
    prepared = kernels.prepare_projector(a)
    ms = cuda_ms(lambda: kernels.v_projection(raw, a, c, prepared), reps=10)
    lib_ms = cuda_ms(lambda: torch.matmul(raw.float(), a), reps=10)
    log(f"  K2 (256, 1048576) uint16 r'=168, projector prepared once: kernel {ms:.3f} ms, "
        f"torch.matmul(raw.float(), A) {lib_ms:.3f} ms")
    log_bound("K2 (256, 1048576) uint16", ms,
              bound(2.0 * 256 * (1 << 20) * 168, 256 * (1 << 20) * 2 + (1 << 20) * 168 * 4 + 168 * 256 * 4, True))
    del raw, a, prepared
    # the main path's call: the whole 2048-frame movie as one chunk, r' = 336
    raw = torch.randn(2048, d, generator=g, device=dev)
    a = torch.randn(d, 336, generator=g, device=dev) * 0.01
    c = torch.randn(336, generator=g, device=dev)
    out_k = kernels.v_projection(raw, a, c)
    out_p = kernels.v_projection_plain(raw, a, c)
    torch.cuda.synchronize()
    err = rel_fro(out_k, out_p)
    check(err <= 1e-5, f"K2 (2048, 262144): error {err}")
    first_err = max_abs(out_k, out_p)
    del out_k, out_p
    ms = cuda_ms(lambda: kernels.v_projection(raw, a, c), reps=10)
    prepared = kernels.prepare_projector(a)
    ms_k = cuda_ms(lambda: kernels.v_projection(raw, a, c, prepared), reps=10)
    plain_ms = cuda_ms(lambda: kernels.v_projection_plain(raw, a, c), reps=10)
    lib_ms = cuda_ms(lambda: torch.matmul(raw.float(), a), reps=10)
    log(f"  K2 (2048, 262144) f32 r'=336 (main path): rel Frobenius err {err:.3e}; "
        f"kernel {ms:.3f} ms with the projector's preparation ({ms_k:.3f} ms without), plain {plain_ms:.3f} ms, "
        f"torch.matmul {lib_ms:.3f} ms")
    b = bound(2.0 * 2048 * d * 336, 2048 * d * 4 + d * 336 * 4 + 336 * 2048 * 4, tensor_3xtf32=True)
    log_bound("K2 (2048, 262144) f32 r'=336", ms, b)
    results["v_projection"] = dict(max_abs_err=first_err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=lib_ms)
    del raw, a, prepared

    # K3: relative Frobenius error <= 1e-5. Timed as the path calls it,
    # with the block lists prepared once (PMDArray keeps them); the bound
    # counts 3xTF32 on the tensor cores and the canvas written once.
    first = None
    for name, (d1, d2, blk, s_slots, f) in [
        ("961 blocks 32x32 on 512^2, S=20, f=512", (512, 512, 32, 20, 512)),
        ("60x52 blocks 20 (snapped tail)", (60, 52, 20, 3, 40)),
        ("60x52 blocks 15 (odd)", (60, 52, 15, 5, 70)),
        ("961 blocks 32x32 on 512^2, S=40, f=512", (512, 512, 32, 40, 512)),
    ]:
        grid = BlockGrid(d1, d2, (blk, blk))
        n = grid.n_blocks
        panels = torch.randn(n, blk * blk, s_slots, generator=g, device=dev)
        temporal = torch.randn(n, s_slots, f, generator=g, device=dev)
        cosets = tuple(ids for ids, _ in grid.cosets())
        args = (panels, temporal, grid.starts, cosets, (d1, d2), (blk, blk))
        plan = kernels.prepare_reconstruct(grid.starts, cosets, (d1, d2), (blk, blk), dev)
        out_k = kernels.block_reconstruct(*args, plan)
        out_p = kernels.block_reconstruct_plain(*args)
        torch.cuda.synchronize()
        err = rel_fro(out_k, out_p)
        check(err <= 1e-5, f"K3 {name}: error {err}")
        ms = cuda_ms(lambda: kernels.block_reconstruct(*args, plan), reps=10)
        plain_ms = cuda_ms(lambda: kernels.block_reconstruct_plain(*args))
        # the library call: torch.sparse.mm of a CSR U (rows the canvas
        # pixels, columns each block's S slots), built once, by the stacked
        # temporal factors
        u_csr = k3_csr(panels, grid.starts, (d1, d2), (blk, blk))
        stacked = temporal.reshape(n * s_slots, f)
        out_l = torch.sparse.mm(u_csr, stacked)
        torch.cuda.synchronize()
        err_l = rel_fro(out_l, out_p.reshape(d1 * d2, f))
        check(err_l <= 1e-5, f"K3 {name}: torch.sparse.mm against the plain twin {err_l}")
        lib_ms = cuda_ms(lambda: torch.sparse.mm(u_csr, stacked), reps=10)
        b = bound(2.0 * n * blk * blk * s_slots * f,
                  4 * (n * blk * blk * s_slots + n * s_slots * f + d1 * d2 * f), True)
        log(f"  K3 block_reconstruct {name}: rel Frobenius err {err:.3e}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, torch.sparse.mm (CSR U, {u_csr._nnz()} nonzeros; "
            f"{err_l:.3e} from the plain twin) {lib_ms:.3f} ms = kernel x {lib_ms / ms:.2f}")
        log_bound(f"K3 {name}", ms, b)
        if first is None:
            first = dict(max_abs_err=max_abs(out_k, out_p), ms=ms, plain_ms=plain_ms,
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=lib_ms)
        del panels, temporal, out_k, out_p, out_l, u_csr, stacked
    results["block_reconstruct"] = first

    # K4: eigenvalues within 1e-5 |lambda_max| of the plain twin's and of
    # torch.linalg.eigh's (cuSOLVER) on the same input in float64; V diag(lambda)
    # V^T within 1e-5 relative Frobenius of the input; max|V^T V - I| <= 1e-5.
    # cuSOLVER's float32 eigenvalues are printed beside, measured against the
    # same float64 reference.
    from localmd_tpu_torch.ops import linalg

    first = None
    for (n, k) in K4_SHAPES:
        for kind in K4_KINDS:
            sym = k4_matrices(kind, n, k, g)
            vals_k, vecs_k = kernels.jacobi_eigh(sym)
            vals_p, _ = linalg.jacobi_eigh_plain(sym)
            vals_64 = torch.linalg.eigvalsh(sym.double()).flip(-1)
            vals_32 = torch.linalg.eigvalsh(sym).flip(-1)
            torch.cuda.synchronize()
            lam = float(vals_64.abs().max())
            err_p = max_abs(vals_k, vals_p) / lam
            err_c = max_abs(vals_k, vals_64) / lam
            err_32 = max_abs(vals_32, vals_64) / lam
            v64 = vecs_k.double()
            recon = rel_fro((v64 * vals_k.double()[:, None, :]) @ v64.transpose(1, 2), sym)
            orth = float((v64.transpose(1, 2) @ v64 - torch.eye(k, device=dev, dtype=torch.float64)).abs().max())
            log(f"  K4 jacobi_eigh ({n}, {k}, {k}) {kind}: eigenvalues vs plain {err_p:.2e}, "
                f"vs cuSOLVER f64 {err_c:.2e} (cuSOLVER f32 {err_32:.2e}) x |lambda_max|; "
                f"recon {recon:.2e}; orth {orth:.2e}")
            check(max(err_p, err_c) <= 1e-5, f"K4 ({n}, {k}) {kind}: eigenvalue error {err_p} / {err_c}")
            check(recon <= 1e-5 and orth <= 1e-5, f"K4 ({n}, {k}) {kind}: recon {recon}, orth {orth}")
            if first is None:
                first = (sym, max_abs(vals_k, vals_p))
    # K4 and cuSOLVER in alternation, one call each a round, 30 rounds, at
    # every shape; the kernels line keeps (256, 30, 30)
    sym0, err0 = first
    q = lambda xs: "-".join(f"{v:.3f}" for v in np.percentile(xs, [25, 75]))
    for (n, k) in K4_SHAPES:
        sym = k4_matrices("random_psd", n, k, g)
        k4_times, cus_times = [], []
        cuda_ms(lambda: torch.linalg.eigh(sym))
        for _ in range(30):
            k4_times.append(cuda_ms(lambda: kernels.jacobi_eigh(sym), reps=1))
            cus_times.append(cuda_ms(lambda: torch.linalg.eigh(sym), reps=1))
        k_ms, c_ms = float(np.median(k4_times)), float(np.median(cus_times))
        log(f"  K4 ({n}, {k}, {k}), 30 alternating rounds: kernel median {k_ms:.3f} ms "
            f"(quartiles {q(k4_times)}), cuSOLVER (torch.linalg.eigh) median {c_ms:.3f} ms "
            f"(quartiles {q(cus_times)})")
        if (n, k) == (256, 30):
            ms, cusolver_ms = k_ms, c_ms
    sym = sym0
    plain_ms = cuda_ms(lambda: linalg.jacobi_eigh_plain(sym))
    log(f"  K4 (256, 30, 30) plain twin {plain_ms:.3f} ms")
    # a cyclic-Jacobi rotation updates two rows and two columns of A and two
    # columns of V: ~18 k flops; sweeps * k (k - 1) / 2 rotations a matrix
    n, k = sym.shape[0], sym.shape[1]
    b = bound(n * linalg.jacobi_sweeps(k) * k * (k - 1) / 2 * 18 * k, 4 * n * (2 * k * k + k), False)
    log_bound("K4 (256, 30, 30)", ms, b)
    results["jacobi_eigh"] = dict(max_abs_err=err0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=cusolver_ms)


# the movie dtypes K1 and K2 read beside float32 and uint16, with the
# extremes of each (bfloat16: +-65280, float16's range in bfloat16's bits)
NEW_DTYPES = ("int16", "uint8", "int8", "float16", "bfloat16")
DTYPE_EXTREMES = {"int16": (-32768.0, 32767.0, 0.0), "uint8": (0.0, 255.0, 128.0),
                  "int8": (-128.0, 127.0, 0.0), "float16": (-65504.0, 65504.0, 0.0),
                  "bfloat16": (-65280.0, 65280.0, 0.0)}


def dtype_values(name: str, shape, g, kind: str = "movie"):
    """A (t, p) tensor of ``name`` on the card: "movie" is bench_torch's
    construction of that dtype on N(0, 1) (int16 clip(40 x - 100), uint8
    clip(8 x + 128), int8 clip(8 x); float16 and bfloat16 2.3 x + 1, as
    phase 2's float32 chunk); "baseline" small noise on an offset, the
    input a careless tf32 split fails on (integers clip(3 x + b) with b
    1000 for int16, -1000 for "baseline-", 100 for uint8, 60 for int8;
    floats 3 x + 1000); "extremes" the type's two ends and a middle value,
    drawn at random."""
    import torch

    from bench_torch import MOVIE_RANGES

    dev = torch.device("cuda")
    dt = getattr(torch, name)
    if kind == "extremes":
        vals = torch.tensor(DTYPE_EXTREMES[name], device=dev)
        return vals[torch.randint(0, 3, shape, generator=g, device=dev)].to(dt)
    x = torch.randn(shape, generator=g, device=dev)
    lo, hi = MOVIE_RANGES[name][2:] if name in MOVIE_RANGES else (-1e30, 1e30)
    if kind == "movie":
        if name in MOVIE_RANGES:
            scale, offset, _, _ = MOVIE_RANGES[name]
            return (x * scale + offset).clamp(lo, hi).to(dt)
        return (x * 2.3 + 1.0).to(dt)
    base = {"int16": 1000.0, "uint8": 100.0, "int8": 60.0}.get(name, 1000.0)
    if kind == "baseline-":
        base = -base
    return (x * 3 + base).clamp(lo, hi).to(dt)


def check_k1(label: str, x, nper: int = 256, noise: bool = True, divisor: int = 2048) -> float:
    """K1 against its plain version on ``x``: mean max|d| / max|ref| <= 1e-5,
    sigma max relative error <= 1e-4 (== 0 without noise). Returns the
    max abs error."""
    import torch

    from localmd_tpu_torch.ops import kernels

    m_k, s_k = kernels.movie_stats(x, divisor, compute_noise=noise, nperseg=nper)
    m_p, s_p = kernels.movie_stats_plain(x, divisor, compute_noise=noise, nperseg=nper)
    torch.cuda.synchronize()
    mean_err = max_abs(m_k, m_p) / max(float(m_p.abs().max()), 1e-30)
    sig_err = (float(((s_k - s_p).abs() / s_p.abs().clamp_min(1e-30)).max()) if noise
               else max_abs(s_k, s_p))
    log(f"  K1 movie_stats {label}: mean err {mean_err:.3e}, sigma err {sig_err:.3e}")
    check(mean_err <= 1e-5, f"K1 {label}: mean error {mean_err}")
    check(sig_err <= 1e-4 if noise else sig_err == 0.0, f"K1 {label}: sigma error {sig_err}")
    return max(max_abs(m_k, m_p), max_abs(s_k, s_p))


def check_k2(label: str, x, a, c) -> float:
    """K2 against its plain version: relative Frobenius error <= 1e-5."""
    import torch

    from localmd_tpu_torch.ops import kernels

    out_k = kernels.v_projection(x, a, c)
    out_p = kernels.v_projection_plain(x, a, c)
    torch.cuda.synchronize()
    err = rel_fro(out_k, out_p)
    log(f"  K2 v_projection {label}: rel Frobenius err {err:.3e}")
    check(err <= 1e-5, f"K2 {label}: error {err}")
    return err


def phase_kernel_dtypes(results: dict) -> None:
    """Phase 2, the new dtypes: K1 and K2 against their plain versions on
    int16, uint8, int8, float16 and bfloat16 chunks at the paths' shapes
    (K1 (1024, 262144); K2 (2048, 262144) x 336 and (256, 1048576) x 168)
    and the edge cases (each type's extremes, an offset baseline, P and d
    off the 16-byte chunk, a base off 16-byte alignment), then each one's
    time beside the float32 and uint16 kernels' at the same shape, its
    bytes read and its bound. ``results["dtypes"]`` keeps the times."""
    import torch

    from localmd_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    t, p = 1024, 262144
    times = {}
    n_segs = (t - 256) // 128 + 1
    for name in ("float32", "uint16") + NEW_DTYPES:
        label = f"{name} (1024, 262144)"
        x = (dtype_values(name, (t, p), g) if name in NEW_DTYPES else
             (torch.randn(t, p, generator=g, device=dev) * 40 + 1000).clamp(0, 65535)
             .to(getattr(torch, name)))
        if name in NEW_DTYPES:
            check_k1(f"{label} nperseg=256", x)
            check_k1(f"{label} reference nperseg=T=1024", x, nper=1024)
            check_k1(f"{label} mean only", x, noise=False)
            check_k1(f"{name} (1024, 262107) (P off the 16-byte chunk)",
                     x[:, : p - 37].contiguous())
            check_k1(f"{name} (300, 4096) base off 16-byte alignment, reference nperseg=300",
                     x.reshape(-1)[1 : 1 + 300 * 4096].view(300, 4096), nper=300)
            for kind in ("baseline", "baseline-", "extremes"):
                if kind == "baseline-" and name not in ("int16", "int8", "float16", "bfloat16"):
                    continue
                check_k1(f"{name} (1024, 65536) {kind}", dtype_values(name, (t, 65536), g, kind))
        ms = cuda_ms(lambda: kernels.movie_stats(x, 2048), reps=10)
        plain_ms = cuda_ms(lambda: kernels.movie_stats_plain(x, 2048), reps=10)
        nbytes = t * p * x.element_size() + 2 * p * 4
        b = bound(2.0 * 128 * 256 * n_segs * p, nbytes, tensor_3xtf32=True)
        log(f"  K1 {label} nperseg 256: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
            f"reads {t * p * x.element_size() / 1e9:.3f} GB")
        log_bound(f"K1 {label}", ms, b)
        times[f"K1 {name}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                                   bound_by=b["bound_by"], bytes=nbytes)
        del x
    torch.cuda.empty_cache()

    for (t, d, r) in ((2048, 262144, 336), (256, 1 << 20, 168)):
        a = torch.randn(d, r, generator=g, device=dev) * 0.01
        c = torch.randn(r, generator=g, device=dev)
        prepared = kernels.prepare_projector(a)
        for name in ("float32", "uint16") + NEW_DTYPES:
            label = f"{name} ({t}, {d}) r'={r}"
            x = (dtype_values(name, (t, d), g) if name in NEW_DTYPES else
                 (torch.randn(t, d, generator=g, device=dev) * 40 + 1000).clamp(0, 65535)
                 .to(getattr(torch, name)))
            if name in NEW_DTYPES:
                check_k2(label, x, a, c)
                if t == 2048:
                    for kind in ("baseline", "extremes"):
                        check_k2(f"{name} (256, 262144) r'={r} {kind}",
                                 dtype_values(name, (256, d), g, kind), a, c)
                    check_k2(f"{name} (100, 701) r'=37 (rows off the 16-byte chunk)",
                             x[:100, :701].contiguous(), a[:701, :37].contiguous(),
                             c[:37].contiguous())
                    check_k2(f"{name} (300, 4096) r'=64, base off 16-byte alignment",
                             x.reshape(-1)[1 : 1 + 300 * 4096].view(300, 4096),
                             a[:4096, :64].contiguous(), c[:64].contiguous())
            ms = cuda_ms(lambda: kernels.v_projection(x, a, c, prepared), reps=10)
            plain_ms = cuda_ms(lambda: kernels.v_projection_plain(x, a, c), reps=5)
            nbytes = t * d * x.element_size() + d * r * 4 + r * t * 4
            b = bound(2.0 * t * d * r, nbytes, tensor_3xtf32=True)
            log(f"  K2 {label}, projector prepared once: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms; reads {t * d * x.element_size() / 1e9:.3f} GB of raw")
            log_bound(f"K2 {label}", ms, b)
            times[f"K2 {name} ({t}, {d}) r'={r}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                bytes=nbytes)
            del x
        del a, c, prepared
        torch.cuda.empty_cache()
    results["dtypes"] = times


def k4_matrices(kind: str, n: int, k: int, g):
    """(n, k, k) symmetric float32 test matrices on the card."""
    import torch

    dev = torch.device("cuda")
    if kind == "diagonal":
        return torch.diag_embed(torch.rand(n, k, generator=g, device=dev) * 5)
    if kind == "repeated":
        q, _ = torch.linalg.qr(torch.randn(n, k, k, generator=g, device=dev, dtype=torch.float64))
        lam = torch.tensor([9.0, 4.0, 1.0, 0.25], device=dev, dtype=torch.float64)
        lam = lam.repeat_interleave(-(-k // 4))[:k]
        return ((q * lam) @ q.transpose(1, 2)).float().contiguous()
    width = k + 3 if kind == "random_psd" else 10       # rank-deficient: a k x 10 Gram
    a = torch.randn(n, k, width, generator=g, device=dev)
    return (a @ a.transpose(1, 2)).contiguous()


# ---------------------------------------------------------------------------
# phase 3: golden fixture on the card
# ---------------------------------------------------------------------------

def golden_movie(d2: int = 36):
    """MUST match tests/test_golden.py _make_movie() (d2 = 36; 40 makes the
    regular grid of tests/test_torch_coset.py)."""
    rng = np.random.default_rng(55)
    T, d1, R = 500, 40, 4
    spatial = rng.random((d1 * d2, R)).astype(np.float32)
    temporal = rng.standard_normal((R, T)).astype(np.float32)
    temporal *= np.asarray([8.0, 6.0, 4.5, 3.0], np.float32)[:, None]
    movie = (spatial @ temporal).T.reshape(T, d1, d2)
    movie += 1e-4 * rng.standard_normal(movie.shape).astype(np.float32)
    return movie.astype(np.float32), T, R


def golden_run(movie, T: int, R: int):
    """The golden settings on the card: the committed sketches injected,
    the thresholds pinned."""
    import torch

    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    sketches = np.load(GOLDEN_SKETCHES)
    saved = port_pipeline.threshold_heuristic
    port_pipeline.threshold_heuristic = lambda *a, **k: (1e9, 1e9)
    try:
        with sketch_override(lambda shape: sketches["x".join(str(int(s)) for s in shape)]):
            return port_pipeline.localmd_decomposition(
                torch.as_tensor(movie, device="cuda"), (16, 16), frame_range=T,
                max_components=R, background_rank=2, temporal_avg_factor=4,
                compute_normalizer=True, welch_compat="reference", seed=0,
                final_rank_tol=0.0, device="cuda",
            )
    finally:
        port_pipeline.threshold_heuristic = saved


def phase_golden() -> dict:
    """Phase 3. Returns the launch counts of the golden run (counted from
    0), whose irregular grid takes K2."""
    from bench_torch import set_routes
    from localmd_tpu_torch.ops import kernels

    golden = np.load(GOLDEN, allow_pickle=True)
    movie, T, R = golden_movie()
    kernels.reset_launch_counts()
    reset_route_calls()
    pmd = golden_run(movie, T, R)
    recon_k3 = pmd.reconstruct_frames(np.arange(T)).cpu().numpy()
    recon_host = pmd[:, :, :]
    after = kernels.launch_counts()
    golden_routes = dict(ROUTE_CALLS)
    ref = golden["recon"]
    err_k3 = float(np.linalg.norm(recon_k3 - ref) / np.linalg.norm(ref))
    err_host = float(np.linalg.norm(recon_host - ref) / np.linalg.norm(ref))
    mean_err = float(np.max(np.abs(pmd.mean_img - golden["mean_img"])) / np.abs(golden["mean_img"]).max())
    var_err = float(np.max(np.abs(pmd.var_img - golden["noise_var_img"]) / np.abs(golden["noise_var_img"])))
    log(f"  golden: recon rel Frobenius {err_k3:.3e} (K3) / {err_host:.3e} (slicing), "
        f"mean max|d|/max|ref| {mean_err:.3e}, var rel {var_err:.3e}, ranks {pmd.pipeline_ranks}")
    log(f"  golden launches {after}, routes {golden_routes}")
    check_path("golden", after, golden_routes, expected_routes(40, 36, (16, 16)),
               kernels_run=tuple(after))
    check(err_k3 <= 1e-5 and err_host <= 1e-5, f"golden reconstruction error {err_k3} / {err_host}")
    check(np.allclose(pmd.mean_img, golden["mean_img"], rtol=1e-4, atol=1e-5), "golden mean_img")
    check(np.allclose(pmd.var_img, golden["noise_var_img"], rtol=1e-4, atol=0), "golden var_img")

    # the regular 40 x 40 construction, every route on against every route off
    movie40, T, R = golden_movie(40)
    recon = {}
    for routes in (False, "auto"):
        set_routes(routes)
        reset_route_calls()
        pmd40 = golden_run(movie40, T, R)
        recon[routes] = pmd40.reconstruct_frames(np.arange(T))
        calls = dict(ROUTE_CALLS)
        log(f"  regular 40x40 golden construction, routes {routes}: routes run {calls}, ranks "
            f"{pmd40.pipeline_ranks}")
        want = expected_routes(40, 40, (16, 16))
        check(calls == {k: int(v) for k, v in want.items()},
              f"regular golden, routes {routes}: routes run {calls}, expected {want}")
    err40 = rel_fro(recon["auto"], recon[False])
    log(f"  regular 40x40: routes on against off, rel Frobenius {err40:.3e}")
    check(err40 <= 1e-5, f"regular golden construction: routes on against off {err40}")
    return after


# ---------------------------------------------------------------------------
# phases 4-7: the main path at 512 x 512 x 2048, the multi-window path
# ---------------------------------------------------------------------------

def run_main(movie, runs: int, label: str, **settings):
    """``runs`` calls of localmd_decomposition (the first cold) with
    bench.py's configuration, ``settings`` over it; checks the ranks and
    returns the last PMDArray."""
    return run_side(movie, runs, label, **settings)[0]


def run_side(movie, runs: int, label: str, cold: bool = True, **settings):
    """``runs`` calls (the first cold if ``cold``), each logged: (the last
    PMDArray, the warm calls' walls, their ``pipeline_timings`` and their
    K4 launches, each call's counted alone)."""
    from bench_torch import timed_run
    from localmd_tpu_torch.ops import kernels

    t, d1, d2 = movie.shape
    pmd, walls, stages, k4 = None, [], [], []
    for i in range(runs):
        before = kernels.jacobi_eigh.launches
        pmd, secs, peak = timed_run(movie, **settings)
        kind = "cold" if (cold and i == 0) else "warm"
        log(f"  {label} run {i} ({kind}): {secs:.4f} s = "
            f"{d1 * d2 * t / secs / 1e6:.1f} Mpf/s; stages "
            + json.dumps({k: round(v, 4) for k, v in pmd.pipeline_timings.items()})
            + f"; peak {peak:.2f} GiB; K4 launches {kernels.jacobi_eigh.launches - before}")
        if kind == "warm":
            walls.append(secs)
            stages.append(pmd.pipeline_timings)
            k4.append(kernels.jacobi_eigh.launches - before)
    ranks = pmd.pipeline_ranks
    log(f"  {label} ranks {ranks}, kept rank {pmd.rank}, windows {pmd.pipeline_windows}")
    check(0 < pmd.rank <= ranks["final"] <= ranks["reduced"], f"{label}: ranks {ranks}, {pmd.rank}")
    return pmd, walls, stages, k4


AB_STAGES = ("block_decomposition", "factorized_svd", "v_regression")


def routes_ab(movie, label: str, pmd_on, side_on, runs: int = 3, kept_equal: bool = True,
              **settings) -> None:
    """The routes forced off for ``runs`` warm calls after the "auto" side
    ``side_on`` (walls, stages, K4 launches) ended in ``pmd_on``: each
    side's warm median and the median of its three route stages, equal
    ``pipeline_ranks`` (and kept ranks with ``kept_equal``), equal K4
    launches across one side's warm calls, and the two sides' sampled
    frames apart (reported, no bar: on a white movie a rounding change
    moves the kept subspace by ~1e-3)."""
    import torch

    from bench_torch import set_routes

    set_routes(False)
    try:
        pmd_off, *side_off = run_side(movie, runs, f"{label} routes off", cold=False, **settings)
    finally:
        set_routes("auto")
    for name, (walls, stages, k4) in (("auto", side_on), ("off", side_off)):
        log(f"  {label} routes {name}: warm median {float(np.median(walls)):.4f} s of "
            + ", ".join(f"{w:.4f}" for w in walls) + "; stage medians "
            + json.dumps({k: round(float(np.median([s[k] for s in stages])), 4) for k in AB_STAGES})
            + f"; K4 launches per warm call {k4}")
        check(len(set(k4)) == 1, f"{label} routes {name}: K4 launches vary across warm calls {k4}")
    sample = np.sort(np.random.default_rng(0).choice(movie.shape[0], 512, replace=False))
    err = rel_fro(pmd_on.reconstruct_frames(sample), pmd_off.reconstruct_frames(sample))
    log(f"  {label}: routes auto against off, ranks {pmd_on.pipeline_ranks} / kept {pmd_on.rank} "
        f"against {pmd_off.pipeline_ranks} / kept {pmd_off.rank}; 512 sampled frames rel "
        f"Frobenius {err:.3e}")
    check(pmd_on.pipeline_ranks == pmd_off.pipeline_ranks
          and (pmd_on.rank == pmd_off.rank or not kept_equal),
          f"{label}: routes auto against off changed the ranks")
    del pmd_off
    torch.cuda.empty_cache()


def check_recon(pmd, movie, clean_fn, label: str, denoised: bool) -> None:
    """``reconstruct_frames`` on the first 512 frames: shape, finite values,
    and -- with ``denoised`` -- closer to the clean movie than the raw
    frames are."""
    import torch

    frames = np.arange(512)
    times = []
    for _ in range(2):          # the first call also makes the C-order panels and K3's lists
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon = pmd.reconstruct_frames(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(tuple(recon.shape) == (512,) + tuple(movie.shape[1:]), f"{label}: recon shape")
    check(bool(torch.isfinite(recon).all()), f"{label}: non-finite reconstruction")
    clean = clean_fn(torch.as_tensor(frames, device=recon.device))
    err_recon = float(torch.linalg.norm(recon - clean))
    err_raw = float(torch.linalg.norm(movie[:512].to(torch.float32) - clean))
    log(f"  {label} reconstruct_frames(512): {times[0]:.4f} s first, {times[1]:.4f} s again; "
        f"||recon - clean|| {err_recon:.1f}, ||movie - clean|| {err_raw:.1f}")
    if denoised:
        check(err_recon < err_raw, f"{label}: reconstruction is not closer to the clean movie")


def phase_voltage() -> dict:
    """Phase 7: the multi-window path at the voltage workload. Returns the
    launch counts of its white-movie runs (counted from 0)."""
    import torch

    from bench_torch import CELLS, make_movie
    from localmd_tpu_torch import engine
    from localmd_tpu_torch.ops import kernels

    d1, d2, t, dtype, settings = CELLS["voltage_f32"]
    log(f"phase 7 multi-window {d1}x{d2}x{t} {dtype} (voltage workload) {settings}")
    calls = []
    residual = engine.single_residual_block_md_batched

    def counted(*args, **kwargs):
        calls.append(1)
        return residual(*args, **kwargs)

    engine.single_residual_block_md_batched = counted
    try:
        movie, clean_fn = make_movie(dtype, d1, d2, t)
        kernels.reset_launch_counts()
        reset_route_calls()
        pmd, *side_on = run_side(movie, 4, "voltage f32", **settings)
        check(tuple(pmd.shape) == (t, d1, d2), f"voltage: shape {pmd.shape}")
        windows = pmd.pipeline_windows
        check(windows["n_windows"] == 2, f"voltage: {windows}")
        check_recon(pmd, movie, clean_fn, "voltage f32", denoised=False)
        launches = kernels.launch_counts()
        log(f"  launches on the multi-window path: {launches}; routes run {ROUTE_CALLS}; "
            f"residual-window calls {len(calls)}")
        check(len(calls) >= 1, "voltage: no residual window ran")
        check_path("multi-window path", launches, ROUTE_CALLS,
                   expected_routes(d1, d2, single_window=False),
                   kernels_run=("movie_stats", "block_reconstruct", "jacobi_eigh"))
        # the banded Gram and the cell route against the canvas Gram and K2.
        # The kept rank is reported, not held: without rank_prune the white
        # movie's final singular values form a continuum through the
        # 1e-3 * s_0 cut (230 of 465 kept), and a rounding change moves one
        # across it (230 against 229 on the card)
        routes_ab(movie, "voltage f32", pmd, side_on, kept_equal=False, **settings)
        del pmd, movie
        torch.cuda.empty_cache()
        before = len(calls)
        movie, clean_fn = make_movie(dtype, d1, d2, t, smooth=True)
        pmd = run_main(movie, 1, "voltage smooth f32", **settings)
        log(f"  residual-window calls on the smoothed movie: {len(calls) - before}")
        check_recon(pmd, movie, clean_fn, "voltage smooth f32", denoised=True)
        del pmd, movie
        torch.cuda.empty_cache()
    finally:
        engine.single_residual_block_md_batched = residual
    return launches


# ---------------------------------------------------------------------------
# phase 8: from a movie file on disk to an exported movie
# ---------------------------------------------------------------------------

def timed(fn):
    """(result, seconds) of ``fn()`` on the host clock, the card drained
    before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def log_stream_run(label: str, pmd, secs: float, t: int) -> None:
    cache = pmd.pipeline_cache
    gb = cache["pinned_bytes"] / 1e9
    log(f"  {label}: {secs:.4f} s = {512 * 512 * t / secs / 1e6:.1f} Mpf/s; stages "
        + json.dumps({k: round(v, 4) for k, v in pmd.pipeline_timings.items()})
        + f"; cached {cache['cached_frames']}/{cache['total_frames']} frames; streamed "
        f"{gb:.3f} GB in {cache['pinned_copies']} pinned copies = {gb / secs:.3f} GB/s; "
        f"ranks {pmd.pipeline_ranks}, kept {pmd.rank}")


def check_stream_launches(label: str, launches: dict) -> None:
    """The kernels and routes of one from-disk decomposition (K3 runs in
    export_tiff); ``ROUTE_CALLS`` counted from 0 with ``launches``."""
    log(f"  launches of the {label} run: {launches}; routes run {ROUTE_CALLS}")
    check_path(label, launches, ROUTE_CALLS, expected_routes(512, 512))


def phase_from_disk(tmp: str, frames=None):
    """Phase 8, in the temporary directory ``tmp`` (its raw file stays there
    for phase 11). Returns the launch counts of its from-disk runs and of
    the export, each counted from 0 just before it (the card-resident
    reference run and the comparisons are not counted), the raw file
    (path, frames, the frames the cache held), phase 12's reference and the
    CLI's .npz with its rank (kept in ``tmp`` for phase 13)."""
    import torch

    from bench_torch import NORTHSTAR_BLOCKS, NORTHSTAR_CONFIG, stream_legs, timed_run
    from localmd_tpu_torch import RawBinaryArray, TensorMovie, TiffArray, localmd_decomposition
    from localmd_tpu_torch.io.native import native_available
    from localmd_tpu_torch.io.tiff import write_tiff_stream
    from localmd_tpu_torch.ops import kernels

    log(f"phase 8 from disk: 512x512xT uint16 raw file, {NORTHSTAR_CONFIG}")
    path, t, movie = write_northstar(tmp, frames)
    settings = dict(NORTHSTAR_CONFIG)

    # 2. the same movie resident on the card: the reference of the file runs
    pmd_res, secs, _ = timed_run(TensorMovie(movie), blocks=NORTHSTAR_BLOCKS, **settings)
    log_stream_run("card-resident", pmd_res, secs, t)
    movie_max = u16_max(movie)
    del movie
    torch.cuda.empty_cache()

    # 3. from the file, movie cache "auto"
    check(native_available(), "the native reader is not built: the timed path would read in Python")
    src = RawBinaryArray(path, (t, 512, 512), "uint16")
    kernels.reset_launch_counts()
    reset_route_calls()
    pmd, secs_on, _ = timed_run(src, blocks=NORTHSTAR_BLOCKS, cache_movie="auto", **settings)
    launches_on = kernels.launch_counts()
    log_stream_run("from disk, cache auto", pmd, secs_on, t)
    check_stream_launches("from disk, cache auto", launches_on)
    check(src._native_reader() is not None and src._fast_reader.n_threads == 4,
          "the file was not read by the native reader with 4 threads")
    mean_d = float(np.abs(pmd.mean_img - pmd_res.mean_img).max())
    std_d = float(np.abs(pmd.var_img - pmd_res.var_img).max())
    sample = np.sort(np.random.default_rng(0).choice(t, 512, replace=False))
    err = rel_fro(pmd.reconstruct_frames(sample), pmd_res.reconstruct_frames(sample))
    log(f"  from disk vs card-resident: mean max|d| {mean_d:.3e}, std max|d| {std_d:.3e}, "
        f"512 sampled frames rel Frobenius {err:.3e}")
    check(mean_d <= 1e-5 * float(np.abs(pmd_res.mean_img).max())
          and std_d <= 1e-5 * float(np.abs(pmd_res.var_img).max()), "from-disk statistics differ")
    check(pmd.pipeline_ranks == pmd_res.pipeline_ranks,
          f"ranks {pmd.pipeline_ranks} vs {pmd_res.pipeline_ranks}")
    check(err <= 1e-5, f"from-disk reconstruction error {err}")
    check(pmd.pipeline_cache["cached_frames"] > 0, "no frame was cached")
    check(pmd.pipeline_cache["pinned_copies"] > 0, "no pinned copy was made")
    # again in this process: the cache plan reads the first call's
    # cache, freed into the allocator's pool, as free memory
    pmd_again, secs_again, _ = timed_run(src, blocks=NORTHSTAR_BLOCKS, cache_movie="auto",
                                         **settings)
    log_stream_run("from disk, cache auto, again", pmd_again, secs_again, t)
    u16_ref = disk_summary(pmd, secs_on, secs_again, sample, movie_max)
    cached = pmd.pipeline_cache["cached_frames"]
    check(pmd_again.pipeline_cache["cached_frames"] == cached,
          f"the second cached run held {pmd_again.pipeline_cache['cached_frames']} frames "
          f"against {cached}")
    del pmd_again

    # 4. from the file, no cache: the V regression streams through the
    # pinned ring while the factorized SVD runs
    kernels.reset_launch_counts()
    reset_route_calls()
    pmd_off, secs_off, _ = timed_run(src, blocks=NORTHSTAR_BLOCKS, cache_movie=False, **settings)
    launches_off = kernels.launch_counts()
    log_stream_run("from disk, no cache", pmd_off, secs_off, t)
    check_stream_launches("from disk, no cache", launches_off)
    err_off = rel_fro(pmd_off.reconstruct_frames(sample), pmd_res.reconstruct_frames(sample))
    log(f"  no cache vs card-resident: 512 sampled frames rel Frobenius {err_off:.3e}")
    check(pmd_off.pipeline_ranks == pmd_res.pipeline_ranks,
          f"no cache: ranks {pmd_off.pipeline_ranks} vs {pmd_res.pipeline_ranks}")
    check(err_off <= 1e-5, f"no-cache reconstruction error {err_off}")
    check(pmd_off.pipeline_cache["cached_frames"] == 0, "the no-cache run cached frames")
    check(pmd_off.pipeline_cache["pinned_copies"] > 0, "no cache: no pinned copy was made")
    legs = stream_legs(path, t)
    log(f"  alone: disk read {legs['disk_read_GBps']:.3f} GB/s (native reader, 4 threads, "
        f"2048 frames into pinned memory), pinned H2D {legs['pinned_h2d_GBps']:.3f} GB/s")

    # 6. slicing on the cached run's array, each case against the host path
    cases = [
        ("unaligned ROI [0:512, 100:228, 37:300]", (slice(0, 512), slice(100, 228), slice(37, 300))),
        ("strided [-5:, ::7, ::9]", (slice(-5, None), slice(None, None, 7), slice(None, None, 9))),
        (f"fancy pairs [[3, 17, {t - 1}], [5, 400], [7, 511]]", ([3, 17, t - 1], [5, 400], [7, 511])),
        ("pixel trace [:, 250, 250]", (slice(None), 250, 250)),
        ("full frame [1000]", (1000,)),
    ]
    for name, key in cases:
        got, secs = timed(lambda: pmd[key])
        want, host_s = timed(lambda: pmd._getitem_host(key).squeeze().astype(np.float32))
        err = float(np.linalg.norm((got - want).astype(np.float64)) / np.linalg.norm(want))
        log(f"  slice {name}: {tuple(got.shape)}, device {secs * 1e3:.2f} ms, host path "
            f"{host_s * 1e3:.2f} ms, rel Frobenius {err:.3e}")
        check(got.shape == want.shape and err <= 1e-5, f"slice {name}: error {err}")
    dev = pmd.slice_device(slice(0, 4), slice(0, 64), slice(0, 64))
    check(isinstance(dev, torch.Tensor) and dev.is_cuda and tuple(dev.shape) == (4, 64, 64),
          "slice_device did not return a CUDA tensor")

    # 7. export frames 0-2047 as uint16 and read them back
    n_exp = min(2048, t)
    tif = os.path.join(tmp, "denoised.tif")
    kernels.reset_launch_counts()
    _, secs = timed(lambda: pmd.export_tiff(tif, frames=range(n_exp), dtype="uint16"))
    launches_export = kernels.launch_counts()
    log(f"  launches of the export: {launches_export}")
    check(launches_export["block_reconstruct"] > 0, "export_tiff never launched block_reconstruct")
    size = os.path.getsize(tif)
    back = TiffArray(tif)[0:n_exp]
    want = np.concatenate([
        np.clip(np.rint(pmd.reconstruct_frames(np.arange(s, min(s + 512, n_exp))).cpu().numpy()),
                0, 65535)
        for s in range(0, n_exp, 512)
    ])
    log(f"  export_tiff {n_exp} frames uint16: {secs:.3f} s = {size / secs / 1e6:.1f} MB/s; "
        f"read back equal: {np.array_equal(back, want)}")
    check(back.shape == want.shape and np.array_equal(back, want), "exported TIFF differs")
    os.remove(tif)

    # 8. close without materializing: the factors' device memory goes; the
    # row map is the memoized grid's (BlockGrid.device_constants), shared by
    # every call on this grid and freed by clear_block_grid_cache
    from localmd_tpu_torch.ops.tiling import block_grid

    u = pmd_off._blocksparse
    check(u.rows is block_grid(512, 512, NORTHSTAR_BLOCKS, "F").device_constants("cuda")[2],
          "the array's row map is not the grid's cached constant")
    factor_bytes = sum(x.numel() * x.element_size() for x in (
        u.panels, u.dense_basis, pmd_off._r_padded, pmd_off._v_src))
    before = torch.cuda.memory_allocated()
    del u
    pmd_off.close(materialize=False)
    gc.collect()
    freed = before - torch.cuda.memory_allocated()
    log(f"  close(materialize=False): {freed / 1e6:.1f} MB freed, factors {factor_bytes / 1e6:.1f} MB")
    check(freed >= factor_bytes, f"close freed {freed} bytes of {factor_bytes}")
    try:
        pmd_off[0]
    except RuntimeError:
        pass
    else:
        raise AssertionError("slicing a closed array did not raise")
    launches = {name: launches_on[name] + launches_off[name] + launches_export[name]
                for name in launches_on}
    del pmd, pmd_off, pmd_res
    torch.cuda.empty_cache()

    # 9. the CLI on the first 2048 frames as a TIFF, against an in-process run
    n_cli = min(2048, t)
    tif_in = os.path.join(tmp, "first.tif")
    raw = np.memmap(path, dtype=np.uint16, mode="r", shape=(t, 512, 512))
    write_tiff_stream(tif_in, (raw[i] for i in range(n_cli)), (n_cli, 512, 512), np.uint16)
    del raw
    npz, npy = os.path.join(tmp, "cli.npz"), os.path.join(tmp, "cli_recon.npy")
    cli = [sys.executable, "-m", "localmd_tpu_torch.cli"]
    bench = ["--blocks", "32", "32", "--frame-range", "1024", "--max-components", "20",
             "--background-rank", "15", "--temporal-avg-factor", "10", "--rank-prune",
             "--seed", "0"]
    outs = []
    for args in (["compress", tif_in, npz, *bench], ["info", npz],
                 ["export", npz, npy, "--frames", "0", "512"]):
        (proc, secs) = timed(lambda: subprocess.run(cli + args, capture_output=True, text=True,
                                                    cwd=HERE, timeout=600))
        check(proc.returncode == 0, f"cli {args[0]} failed:\n{proc.stderr[-3000:]}")
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        log(f"  cli {args[0]}: {secs:.2f} s, {proc.stdout.strip().splitlines()[-1][:300]}")
    ref = localmd_decomposition(TiffArray(tif_in), (32, 32), frame_range=1024,
                                max_components=20, background_rank=15, temporal_avg_factor=10,
                                rank_prune=True, seed=0, device="cuda")
    err = rel_fro(torch.as_tensor(np.load(npy), device="cuda"), ref.reconstruct_frames(np.arange(512)))
    log(f"  cli vs in-process: rank {outs[1]['rank']} vs {ref.rank}, export rel Frobenius {err:.3e}")
    check(outs[0]["rank"] == outs[1]["rank"] == ref.rank, "cli rank differs from the in-process run")
    check(err <= 1e-5, f"cli reconstruction error {err}")
    del ref
    for name in (tif_in, npy):      # the .npz stays for phase 13's console script
        os.remove(name)
    torch.cuda.empty_cache()
    return launches, (path, t, cached), u16_ref, (npz, outs[1]["rank"])


def u16_max(movie, piece: int = 2048) -> int:
    """The largest value of a uint16 tensor, ``piece`` frames at a time
    (torch reduces no uint16 tensor: its bits as int16, widened)."""
    import torch

    return max(int(movie[s : s + piece].view(torch.int16).to(torch.int32).bitwise_and_(0xFFFF).max())
               for s in range(0, movie.shape[0], piece))


def disk_summary(pmd, secs: float, secs_again: float, sample, movie_max: int) -> dict:
    """What phase 12 compares the int16 reading of the raw file with: a
    cached from-disk run's statistics, ranks, 512 sampled frames (on the
    host), stream and cache figures and walls (cold in its path, then
    again), and the movie's max value."""
    return dict(mean=pmd.mean_img, var=pmd.var_img, ranks=pmd.pipeline_ranks, rank=pmd.rank,
                sample=sample, recon=pmd.reconstruct_frames(sample).cpu(),
                cache=dict(pmd.pipeline_cache), secs=secs, secs_again=secs_again,
                movie_max=movie_max)


def write_northstar(tmp: str, frames=None):
    """The north star's raw file in ``tmp``: (path, frames, the movie on the
    card). T is cut, to no fewer than 8192 frames, to the free disk."""
    from bench_torch import northstar_frames, write_movie_file

    t, cut = northstar_frames(tmp)
    if frames:
        t, cut = min(frames, t), f"north-star movie set to T = {min(frames, t)} frames"
    if cut:
        log(cut)
    path = os.path.join(tmp, "movie.u16.raw")
    nbytes = t * 512 * 512 * 2
    movie, write_s = write_movie_file(path, t)
    log(f"  wrote 512x512x{t} ({nbytes / 1e9:.3f} GB) in {write_s:.2f} s = "
        f"{nbytes / write_s / 1e9:.3f} GB/s")
    return path, t, movie


# ---------------------------------------------------------------------------
# phase 9: the call's options, metrics, sim and diagnostics
# ---------------------------------------------------------------------------

def torch_temporal(traces):
    """(r, t) coarse traces: a 3-tap moving average (tests/test_torch_options.py)."""
    import torch

    return (traces + torch.roll(traces, 1, dims=-1) + torch.roll(traces, -1, dims=-1)) / 3.0


def torch_spatial(frames):
    """(r, b1, b2) component images: a 3-tap average along the rows."""
    import torch

    return (frames + torch.roll(frames, 1, 1) + torch.roll(frames, -1, 1)) / 3.0


def counted(fn):
    """(result, launches of each kernel inside ``fn()``, counted from 0);
    ``ROUTE_CALLS`` is counted from 0 with them."""
    from localmd_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    reset_route_calls()
    out = fn()
    return out, kernels.launch_counts()


def add_launches(total: dict, more: dict) -> dict:
    return {name: total.get(name, 0) + n for name, n in more.items()}


def golden_with_denoisers(device: str):
    """The golden movie through the pipeline with the denoiser pair and the
    committed sketches, thresholds pinned (phase 3's settings, but no
    background): with a rank-2 background removed from this rank-4 movie,
    two of each block's four coarse components are noise of nearly equal
    singular values, and the spatial denoiser, acting per component, then
    depends on the eigh's rotation inside that space (LAPACK against K4's
    twin on the CPU: 2.6e-4 apart); without it the routes agree to 3e-6
    (tests/test_torch_options.py)."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    sketches = np.load(GOLDEN_SKETCHES)
    movie, T, R = golden_movie()
    saved = port_pipeline.threshold_heuristic
    port_pipeline.threshold_heuristic = lambda *a, **k: (1e9, 1e9)
    try:
        with sketch_override(lambda shape: sketches["x".join(str(int(x)) for x in shape)]):
            pmd = port_pipeline.localmd_decomposition(
                movie, (16, 16), frame_range=T, max_components=R, background_rank=0,
                temporal_avg_factor=4, welch_compat="reference", seed=0, final_rank_tol=0.0,
                spatial_denoiser=torch_spatial, temporal_denoiser=torch_temporal, device=device,
            )
    finally:
        port_pipeline.threshold_heuristic = saved
    return pmd.reconstruct_frames(np.arange(T)).cpu()


CACHE_FREE_BYTES = 7 << 29      # free memory the cache_fraction runs see: 3.5 GiB
CACHE_STATS_FRAMES = 256        # their statistics chunk, so a cache stops inside the movie


def loader_checks(movie) -> dict:
    """``PMDLoader`` with the JAX package's parameters on the card: every
    default on the card-resident movie (the loader lands on the card, its
    crops float32 there and float64 on request), then the movie from the
    host at ``cache_fraction`` 0.5 and 0.25 with the card's free memory held
    near ``CACHE_FREE_BYTES`` by an allocation: the 0.25 run caches at most
    half the 0.5 run's frames, in whole chunks, and the statistics are
    bit-equal. Returns the launches of the three loaders."""
    import torch

    from localmd_tpu_torch import PMDLoader
    from localmd_tpu_torch.utils import device_free_bytes

    loader, launches = counted(lambda: PMDLoader(movie))
    crop = loader.temporal_crop(slice(0, 8))
    log(f"  PMDLoader(movie): device {loader.device}, mean_img on {loader.mean_img.device}, "
        f"crop {crop.dtype} on {crop.device}; launches {launches}")
    check(loader.device.type == "cuda" and loader.mean_img.is_cuda and crop.is_cuda,
          "PMDLoader(movie) did not land on the card")
    check(crop.dtype == torch.float32 and torch.equal(crop, movie[:8].permute(1, 2, 0)),
          "PMDLoader(movie).temporal_crop")
    check(launches["movie_stats"] > 0, "PMDLoader(movie) never launched K1")
    pre = {"mean_img": loader.mean_img.cpu().numpy(), "std_img": loader.std_img.cpu().numpy(),
           "spatial_basis": loader.spatial_basis.cpu().numpy()}
    wide = PMDLoader(movie, precomputed=pre, dtype="float64")
    crop64 = wide.temporal_crop_standardized(slice(0, 8))
    want = (movie[:8].permute(1, 2, 0).double() - loader.mean_img.double()[..., None]) \
        / loader.std_img.double()[..., None]
    check(crop64.dtype == torch.float64 and crop64.is_cuda and torch.equal(crop64, want),
          "PMDLoader(dtype='float64').temporal_crop_standardized")
    del loader, wide, crop, crop64, want

    host = movie.cpu().numpy()
    torch.cuda.empty_cache()
    # the plan counts the allocator's cached, unallocated bytes as free
    # (utils.device_free_bytes); the ballast is a new allocation beside them
    spare = device_free_bytes("cuda") - CACHE_FREE_BYTES
    ballast = torch.empty(max(0, spare), dtype=torch.uint8, device="cuda")
    runs = {}
    try:
        for fraction in (0.5, 0.25):
            ld, n = counted(lambda: PMDLoader(host, background_rank=0, cache_fraction=fraction,
                                              frame_constant=CACHE_STATS_FRAMES))
            runs[fraction] = (ld._cache_frames, ld.mean_img.cpu(), ld.std_img.cpu(), n)
            launches = add_launches(launches, n)
            log(f"  PMDLoader(host movie, cache_fraction={fraction}): {ld._cache_frames} of "
                f"{host.shape[0]} frames cached, on {ld.device}; launches {n}")
            del ld
    finally:
        del ballast
        torch.cuda.empty_cache()
    (half, m5, s5, n5), (quarter, m25, s25, n25) = runs[0.5], runs[0.25]
    check(0 < quarter and 2 * quarter <= half < host.shape[0]
          and half % CACHE_STATS_FRAMES == quarter % CACHE_STATS_FRAMES == 0,
          f"cache_fraction: {quarter} frames at 0.25 against {half} at 0.5")
    check(torch.equal(m5, m25) and torch.equal(s5, s25), "cache_fraction changed the statistics")
    check(n5["movie_stats"] > 0 and n25["movie_stats"] > 0, "a cache_fraction run never launched K1")
    return launches


def scipy_u_check(pmd, frames: int = 128) -> None:
    """``compute_lowrank_factorized_svd`` with the decomposition's U as
    scipy CSR and its V = R s Vt (the first ``frames`` frames), on the
    card, against the same product through the ``BlockSparseMatrix``:
    singular values within 1e-5 relative."""
    import torch

    from localmd_tpu_torch import compute_lowrank_factorized_svd

    u_csr = pmd.u
    v = (pmd.r * pmd.s[None, :]) @ pmd.v[:, :frames]
    bsm = pmd._blocksparse
    v_pad = torch.zeros((bsm.shape[1], frames), dtype=torch.float32, device="cuda")
    v_pad[torch.as_tensor(pmd._col_map, device="cuda")] = torch.as_tensor(v, device="cuda")
    k = min(pmd.rank, frames)
    (_, s_csr, _), secs_csr = timed(lambda: compute_lowrank_factorized_svd(
        u_csr, torch.as_tensor(v, device="cuda"), expected_rank=k))
    (_, s_bsm, _), secs_bsm = timed(lambda: compute_lowrank_factorized_svd(bsm, v_pad,
                                                                          expected_rank=k))
    err = float(torch.linalg.vector_norm(s_csr - s_bsm) / torch.linalg.vector_norm(s_bsm))
    log(f"  compute_lowrank_factorized_svd, scipy U ({u_csr.shape[0]}x{u_csr.shape[1]}, "
        f"{u_csr.nnz} nonzeros) against the BlockSparseMatrix, {frames} frames, rank {k}: "
        f"s rel {err:.3e}; {secs_csr:.3f} s against {secs_bsm:.3f} s")
    check(s_csr.is_cuda and s_csr.shape == s_bsm.shape, "scipy U: s not on the card or its shape")
    check(err <= 1e-5, f"scipy U: s {err} from the BlockSparseMatrix path's")


def phase_options() -> dict:
    """Phase 9. Returns the launch counts of its pipeline runs, of the
    loader checks and of the metrics and QC pass, each counted from 0 just
    before it."""
    import torch

    from bench_torch import timed_run
    from localmd_tpu_torch import diagnostics, load_decomposition, metrics, sim

    log("phase 9 options, metrics, sim and diagnostics: sim.two_photon_movie 512x512x2048")
    movie, secs = timed(lambda: sim.two_photon_movie(512, 512, 2048, seed=0))
    log(f"  two_photon_movie(512, 512, 2048): {secs:.3f} s; mean {float(movie.mean()):.3f}, "
        f"std {float(movie.std()):.3f}")
    check(tuple(movie.shape) == (2048, 512, 512) and movie.is_cuda, "sim movie shape or device")
    loader_launches = loader_checks(movie)

    (pmd, secs, peak), launches = counted(lambda: timed_run(movie))
    log(f"  sim movie, bench.py's configuration: {secs:.4f} s, peak {peak:.2f} GiB, ranks "
        f"{pmd.pipeline_ranks}, kept {pmd.rank}; launches {launches}; routes run {ROUTE_CALLS}")
    check(pmd.rank >= 1, "sim movie: rank 0")
    check_path("sim movie", launches, ROUTE_CALLS, expected_routes(512, 512))
    launches = add_launches(launches, loader_launches)

    def quality():
        return [timed(lambda: metrics.compression_ratio(pmd)),
                timed(lambda: metrics.reconstruction_error(pmd, movie)),
                timed(lambda: metrics.residual_noise_ratio(pmd, movie)),
                timed(lambda: diagnostics.compute_qc_images(movie, pmd))]

    parts, quality_launches = counted(quality)
    (ratio, err, rnr, qc), secs = zip(*parts)
    log(f"  metrics and QC: compression_ratio {ratio:.3f} ({secs[0]:.3f} s, the host CSR export "
        f"of U), rel_error {err['rel_error']:.6f}, rel_error_centered "
        f"{err['rel_error_centered']:.6f} ({secs[1]:.3f} s), residual_noise_ratio {rnr:.6f} "
        f"({secs[2]:.3f} s); compute_qc_images {secs[3]:.3f} s, image means "
        + ", ".join(f"{k} {float(np.mean(v)):.4f}" for k, v in qc.items())
        + f"; launches {quality_launches}")
    check(0.3 < rnr < 3.0, f"residual_noise_ratio {rnr} outside (0.3, 3)")
    check(all(v.shape == (512, 512) and np.isfinite(v).all() for v in qc.values()),
          "QC images not finite")
    check(quality_launches["block_reconstruct"] > 0, "metrics and QC never launched K3")
    launches = add_launches(launches, quality_launches)
    scipy_u_check(pmd)

    (pmd_den, secs, _), den_launches = counted(lambda: timed_run(
        movie, spatial_denoiser=torch_spatial, temporal_denoiser=torch_temporal))
    frames = pmd_den.reconstruct_frames(np.arange(512))
    log(f"  denoisers: {secs:.4f} s, ranks {pmd_den.pipeline_ranks}, kept {pmd_den.rank}; "
        f"launches {den_launches}; routes run {ROUTE_CALLS}")
    check(pmd_den.rank >= 1 and bool(torch.isfinite(frames).all()), "denoiser run: rank or frames")
    # denoisers take the gather route in the block stage; U's routes stay
    check_path("denoiser run", den_launches, ROUTE_CALLS,
               dict(expected_routes(512, 512), coset_stage=False))
    launches = add_launches(launches, den_launches)
    del pmd_den, frames
    card, cpu = golden_with_denoisers("cuda"), golden_with_denoisers("cpu")
    err_golden = rel_fro(card, cpu)
    log(f"  denoisers on the golden movie, card vs CPU: rel Frobenius {err_golden:.3e}")
    check(err_golden <= 1e-4, f"denoiser golden run: card vs CPU {err_golden}")

    (pmd_tf32, secs, _), tf32_launches = counted(lambda: timed_run(
        movie, matmul_precision="tensorfloat32"))
    err_tf32 = metrics.reconstruction_error(pmd_tf32, movie)
    restored = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    log(f"  matmul_precision tensorfloat32: {secs:.4f} s, ranks {pmd_tf32.pipeline_ranks}, kept "
        f"{pmd_tf32.rank}, rel_error_centered {err_tf32['rel_error_centered']:.6f} (highest "
        f"{err['rel_error_centered']:.6f}); after the call {restored}")
    check(np.isfinite(err_tf32["rel_error_centered"])
          and err_tf32["rel_error_centered"] <= 1.1 * err["rel_error_centered"],
          "tensorfloat32 run's error")
    check(restored == ("highest", False), f"matmul precision not restored: {restored}")
    launches = add_launches(launches, tf32_launches)
    del pmd_tf32

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        _, secs, _ = timed_run(movie, profile_dir=trace_dir)
        (name,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        from bench_torch import PORT_KERNEL_NAMES

        seen = {k: sum(any(d in n for d in names) for n in kernel_names)
                for k, names in PORT_KERNEL_NAMES.items()}
        log(f"  profile_dir: {secs:.4f} s, {name} with {len(events)} events, "
            f"{len(kernel_names)} CUDA kernel events; the port's kernels in it: {seen}")
        check(len(kernel_names) > 0, "the profiler trace lists no CUDA kernel event")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    npz_dir = tempfile.mkdtemp(prefix="chip_smoke_npz_")
    try:
        path = os.path.join(npz_dir, "sim.npz")
        pmd.to_npz(path)
        loaded = load_decomposition(path)
        sample = np.arange(0, 2048, 4)
        err_npz = rel_fro(loaded.reconstruct_frames(sample), pmd.reconstruct_frames(sample))
        log(f"  .npz round trip: load_decomposition(path) on {loaded.device}, 512 frames rel "
            f"Frobenius {err_npz:.3e}")
        check(loaded.device.type == "cuda" and loaded._csr_dev is not None,
              "load_decomposition did not reconstruct on the card")
        check(err_npz <= 1e-5, f".npz round trip error {err_npz}")
    finally:
        shutil.rmtree(npz_dir, ignore_errors=True)
    del pmd, movie
    torch.cuda.empty_cache()

    for label, make in (("widefield_movie() 1024x1024x1024", sim.widefield_movie),
                        ("voltage_movie() 256x256x20000", sim.voltage_movie)):
        other, secs = timed(make)
        log(f"  {label}: {secs:.3f} s, shape {tuple(other.shape)}, mean {float(other.mean()):.3f}")
        check(other.is_cuda and bool(torch.isfinite(other).all()), f"{label}: not finite")
        del other
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the mesh path
# ---------------------------------------------------------------------------

MESH_SAMPLE = np.sort(np.random.default_rng(0).choice(2048, 512, replace=False))
MESH_LAUNCHES = (("a", 1, "nccl"), ("b", 2, "gloo"))
MESH_RANK_TIMEOUT = 300        # seconds for one launch of ranks, then all are killed
MESH_GROUP_TIMEOUT = 120       # seconds a collective may wait for the other ranks


def _digest(x) -> str:
    import hashlib

    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def mesh_rank(world: int, rank: int, port: int, backend: str, out_dir: str) -> int:
    """One rank of phase 10: join the group, make the movie on this rank's
    card, run the mesh path cold and warm, write the warm run's numbers,
    launch counts and factor digests (rank 0 also its sampled frames)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from bench_torch import make_movie, timed_run
    from localmd_tpu_torch import config
    from localmd_tpu_torch.ops import kernels
    from localmd_tpu_torch.parallel import make_mesh

    config.apply()
    install_route_spies()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=MESH_GROUP_TIMEOUT))
    try:
        mesh = make_mesh(device="cuda")
        movie, _ = make_movie("float32")
        _, cold, _ = timed_run(movie, mesh=mesh)
        _, warm_1, _ = timed_run(movie, mesh=mesh)
        kernels.reset_launch_counts()
        reset_route_calls()
        pmd, warm, peak = timed_run(movie, mesh=mesh)
        recon = pmd.reconstruct_frames(MESH_SAMPLE)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        u = pmd._blocksparse
        result = dict(
            world=world, rank=rank, backend=dist.get_backend(mesh.get_group()),
            device=str(torch.device("cuda", torch.cuda.current_device())), cold=cold,
            warm=[warm_1, warm], peak_gib=peak, stages=pmd.pipeline_timings, ranks=pmd.pipeline_ranks, kept=pmd.rank,
            windows=pmd.pipeline_windows, launches=launches, routes=dict(ROUTE_CALLS),
            digests={name: _digest(x) for name, x in (
                ("panels", u.panels), ("dense_basis", u.dense_basis), ("r", pmd._r_padded),
                ("s", pmd._s_src), ("v", pmd._v_src), ("mean", pmd.mean_img),
                ("std", pmd.var_img), ("recon", recon))},
        )
        if rank == 0:
            torch.save(recon.cpu(), os.path.join(out_dir, f"recon_w{world}.pt"))
        with open(os.path.join(out_dir, f"w{world}_r{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def _launch_ranks(world: int, backend: str, out_dir: str) -> list:
    """Start ``world`` rank processes of this script and wait for them all
    within ``MESH_RANK_TIMEOUT``; on a timeout or a failed rank kill every
    rank and raise with the end of its log."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        log_file = open(os.path.join(out_dir, f"w{world}_r{rank}.log"), "w")
        env = {**os.environ, "LOCAL_RANK": str(rank)}
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(world), str(rank),
             str(port), backend, out_dir],
            cwd=HERE, env=env, stdout=log_file, stderr=subprocess.STDOUT), log_file))
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log_file in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    for rank, (proc, log_file) in enumerate(procs):
        if proc.returncode != 0:
            with open(log_file.name) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"mesh rank {rank} of {world} ({backend}) exited "
                                 f"{proc.returncode} (killed at {MESH_RANK_TIMEOUT} s if -9):\n{tail}")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"w{world}_r{rank}.json")) as f:
            results.append(json.load(f))
    return results


def phase_mesh() -> dict:
    """Phase 10. Returns the launch counts of the ranks' warm runs and
    read-backs, summed over every rank of both launches."""
    import torch

    from bench_torch import make_movie, timed_run
    from localmd_tpu_torch import blocksparse, engine

    log("phase 10 mesh path 512x512x2048 float32 (bench.make_movie): one device, then "
        "mesh (a) 1 rank NCCL, (b) 2 ranks gloo on the one card")
    # each launch's reference takes the forms its mesh path takes: the
    # gather block stage (a mesh makes the coset stage ineligible), the
    # sharded canvas Gram at one rank and the whole Gram (banded) on every
    # rank above one; the cell V projection runs in all
    movie, _ = make_movie("float32")
    refs = {}
    engine.COSET_STAGE = False
    try:
        for world in (1, 2):
            blocksparse.BANDED_GRAM = False if world == 1 else "auto"
            _, cold, _ = timed_run(movie)
            _, warm_1, _ = timed_run(movie)
            ref, warm, _ = timed_run(movie)
            refs[world] = (ref.reconstruct_frames(MESH_SAMPLE), ref.pipeline_ranks, ref.rank)
            log(f"  one device (reference of {world} rank(s): Gram "
                f"{'canvas' if world == 1 else 'banded'}): cold {cold:.4f} s, warm {warm_1:.4f} / "
                f"{warm:.4f} s; stages "
                + json.dumps({k: round(v, 4) for k, v in ref.pipeline_timings.items()})
                + f"; ranks {ref.pipeline_ranks}, kept {ref.rank}")
            del ref
    finally:
        engine.COSET_STAGE = blocksparse.BANDED_GRAM = "auto"
    del movie
    torch.cuda.empty_cache()
    launches: dict = {}
    failed = []   # every check of both launches is made and printed before any raises

    def expect(ok: bool, what: str) -> None:
        if not ok:
            log(f"    FAILED: {what}")
            failed.append(what)

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        for label, world, backend in MESH_LAUNCHES:
            t0 = time.perf_counter()
            results = _launch_ranks(world, backend, out_dir)
            log(f"  ({label}) {world} rank(s) on {backend}: launch to exit {time.perf_counter() - t0:.1f} s")
            ref_recon, ref_ranks, ref_kept = refs[world]
            for res in results:
                log(f"    rank {res['rank']} on {res['device']} ({res['backend']}): cold "
                    f"{res['cold']:.4f} s, warm {res['warm'][0]:.4f} / {res['warm'][1]:.4f} s, peak "
                    f"{res['peak_gib']:.2f} GiB; "
                    "stages " + json.dumps({k: round(v, 4) for k, v in res["stages"].items()})
                    + f"; ranks {res['ranks']}, kept {res['kept']}, windows {res['windows']}; "
                    f"launches {res['launches']}; routes run {res['routes']}")
                expect(res["backend"] == backend, f"({label}) rank {res['rank']}: backend {res['backend']}")
                expect(res["ranks"] == ref_ranks and res["kept"] == ref_kept,
                       f"({label}) rank {res['rank']}: ranks {res['ranks']} / {res['kept']} vs "
                       f"{ref_ranks} / {ref_kept}")
                want = expected_routes(512, 512, world=world)
                for name, n in res["routes"].items():
                    expect((n > 0) == want[name], f"({label}) rank {res['rank']}: route {name} "
                           f"ran {n} times, expected {'some' if want[name] else 'none'}")
                for name, n in res["launches"].items():
                    # K2 runs where the cell route does not
                    expect(n > 0 or (name == "v_projection" and want["cell_vproj"]),
                           f"({label}) rank {res['rank']} never launched {name}")
                    launches[name] = launches.get(name, 0) + n
                expect(res["digests"] == results[0]["digests"],
                       f"({label}) rank {res['rank']}'s factors differ from rank 0's")
            recon = torch.load(os.path.join(out_dir, f"recon_w{world}.pt")).to(ref_recon.device)
            err = rel_fro(recon, ref_recon)
            log(f"    512 sampled frames (K3) against one device: rel Frobenius {err:.3e}; "
                f"equal: {bool(torch.equal(recon, ref_recon))}; collectives staged through the "
                "host: none (gloo and NCCL take the card's tensors)")
            expect(err <= 1e-6, f"({label}) reconstruction error {err}")
            del recon, ref_recon
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del refs
    torch.cuda.empty_cache()
    check(not failed, "phase 10: " + "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 11: cold calls in fresh processes
# ---------------------------------------------------------------------------

COLD_CELLS = ("northstar", "512_f32")
# ``aot_warm`` of a cell's timed processes: every value once (the port has
# no stage warm, so all must give the same frames)
COLD_AOT_WARM = ("auto", True, False)
COLD_TIMEOUT = 300            # seconds for one process, then it is killed
COLD_SAMPLE_FRAMES = 512


def cold_call(cell: str, out_path: str, spawn_time: float, raw_path: str, frames: int,
              save_recon: bool, aot_warm, profiled: bool) -> int:
    """One process of phase 11: a cold call of ``cell`` with ``aot_warm``,
    then a warm call. Writes the seconds from the process's start to the
    call (split into the interpreter with torch's import and the CUDA
    check, the port's imports, the CUDA context and the movie), whether the
    port's import and the cold call loaded ``torch.distributed.tensor``,
    both calls' walls, stages and ``pipeline_warm`` / ``pipeline_aot``, the
    cold call's peak memory and launches (with its read-back), ranks,
    thresholds, cached frames and a digest of 512 sampled frames (the
    frames themselves with ``save_recon``). With ``profiled`` the cold call
    runs under the autograd profiler with CUDA activity alone, for its host
    time in ``cudaLaunchKernel`` (a kernel's first launch loads its module
    there); its walls are then not those of an unprofiled call."""
    import hashlib

    entered = time.time()
    import torch

    torch_imported = time.time()
    from bench_torch import BLOCKS, NORTHSTAR_BLOCKS, NORTHSTAR_CONFIG, make_movie, timed_run
    from localmd_tpu_torch import RawBinaryArray, config, engine
    from localmd_tpu_torch.ops import kernels

    imported = time.time()
    dist_tensor_after_import = "torch.distributed.tensor" in sys.modules
    config.apply()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    context = time.time()
    if cell == "northstar":
        movie, blocks, settings = (RawBinaryArray(raw_path, (frames, 512, 512), "uint16"),
                                   NORTHSTAR_BLOCKS, dict(NORTHSTAR_CONFIG))
    else:
        movie, _ = make_movie("float32")
        blocks, settings = BLOCKS, {}
    torch.cuda.synchronize()
    to_call = time.time() - spawn_time
    settings["aot_warm"] = aot_warm
    kernels.reset_launch_counts()
    launch_n, launch_ms = None, None
    if profiled:
        # the autograd profiler with CUDA activity alone: torch.profiler.profile
        # imports torch._inductor when it starts (and with it
        # torch.distributed.tensor, seconds of the process)
        from torch.autograd.profiler import profile

        with profile(use_device="cuda", use_cpu=False, use_kineto=True) as prof:
            pmd, cold, peak = timed_run(movie, blocks=blocks, **settings)
        launches_us = [e.time_range.end - e.time_range.start for e in prof.function_events
                       if e.name == "cudaLaunchKernel"]
        launch_n, launch_ms = len(launches_us), sum(launches_us) / 1e3
        del prof
    else:
        pmd, cold, peak = timed_run(movie, blocks=blocks, **settings)
    dist_tensor_after_call = "torch.distributed.tensor" in sys.modules
    t_total = pmd.shape[0]
    sample = np.sort(np.random.default_rng(0).choice(t_total, COLD_SAMPLE_FRAMES, replace=False))
    recon = pmd.reconstruct_frames(sample).cpu().contiguous()
    launches = kernels.launch_counts()      # the call and its read-back (K3)
    if save_recon:
        torch.save(recon, out_path + ".recon.pt")
    result = dict(
        cell=cell, aot_warm=aot_warm, profiled=profiled, spawn_to_call_s=to_call,
        start_s=entered - spawn_time, import_s=imported - entered,
        port_import_s=imported - torch_imported,
        dist_tensor_after_import=dist_tensor_after_import,
        dist_tensor_after_call=dist_tensor_after_call,
        context_s=context - imported,
        movie_s=to_call - (context - spawn_time), cold_s=cold, cold_stages=pmd.pipeline_timings,
        cold_warm=pmd.pipeline_warm, cold_aot=pmd.pipeline_aot,
        launch_kernel_calls=launch_n, launch_kernel_ms=launch_ms,
        peak_gib=peak, launches=launches, ranks=pmd.pipeline_ranks, kept=pmd.rank,
        thresholds=[list(v) for v in engine._threshold_cache.values()],
        cached_frames=pmd.pipeline_cache["cached_frames"],
        recon_sha256=hashlib.sha256(recon.numpy().tobytes()).hexdigest(),
    )
    del pmd, recon
    pmd, warm, _ = timed_run(movie, blocks=blocks, **settings)
    result.update(warm_s=warm, warm_stages=pmd.pipeline_timings,
                  warm_cached_frames=pmd.pipeline_cache["cached_frames"],
                  warm_warm=pmd.pipeline_warm, warm_aot=pmd.pipeline_aot)
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def _cold_process(cell, out_dir, raw, i, save_recon, aot_warm, profiled) -> dict:
    """Start one ``--cold-call`` process, wait for it within
    ``COLD_TIMEOUT`` (killed after it) and read what it wrote."""
    path, frames = raw
    out = os.path.join(out_dir, f"{cell}_{i}.json")
    log_path = out + ".log"
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cold-call", cell, out,
             repr(time.time()), path, str(frames), str(int(save_recon)), json.dumps(aot_warm),
             str(int(profiled))],
            cwd=HERE, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=COLD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"cold call {cell} #{i} exited {proc.returncode} "
                             f"(killed at {COLD_TIMEOUT} s if -9):\n{tail}")
    with open(out) as f:
        return json.load(f)


def phase_cold(tmp: str, raw, cached_frames) -> dict:
    """Phase 11. ``raw`` is (path, frames) of the north star's raw file,
    ``cached_frames`` the frames phase 8's cached runs held (None when
    phase 8 did not run). Returns the cold calls' launch counts, summed."""
    import torch

    log(f"phase 11 cold calls in fresh processes: the north star from its raw file "
        f"(512x512x{raw[1]} uint16) and 512x512x2048 float32 made on the card, "
        f"{len(COLD_AOT_WARM)} timed processes each (aot_warm {list(COLD_AOT_WARM)}) "
        f"and one under the profiler")
    torch.cuda.empty_cache()
    launches: dict = {}
    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            log(f"    FAILED: {what}")
            failed.append(what)

    runs = [(aot, False) for aot in COLD_AOT_WARM] + [("auto", True)]
    for cell in COLD_CELLS:
        rs = []
        for i, (aot, profiled) in enumerate(runs):
            r = _cold_process(cell, tmp, raw, i, save_recon=i < 2, aot_warm=aot,
                              profiled=profiled)
            rs.append(r)
            launch = (f", cudaLaunchKernel {r['launch_kernel_ms']:.1f} ms in "
                      f"{r['launch_kernel_calls']} calls" if profiled else "")
            log(f"  {cell} #{i} aot_warm={aot}{' profiled' if profiled else ''}: process to "
                f"call {r['spawn_to_call_s']:.3f} s (interpreter and torch {r['start_s']:.3f}, "
                f"imports {r['import_s']:.3f} of which the port {r['port_import_s']:.3f}, "
                f"torch.distributed.tensor loaded {r['dist_tensor_after_import']} after the "
                f"import and {r['dist_tensor_after_call']} after the call, CUDA context "
                f"{r['context_s']:.3f}, movie {r['movie_s']:.3f}); cold {r['cold_s']:.4f} s "
                f"(statistics {r['cold_stages']['stats_and_background']:.4f} s{launch}, "
                f"pipeline_warm {json.dumps(r['cold_warm'])}, pipeline_aot "
                f"{json.dumps(r['cold_aot'])}), warm {r['warm_s']:.4f} s; cold stages "
                + json.dumps({k: round(v, 4) for k, v in r["cold_stages"].items()})
                + "; warm stages "
                + json.dumps({k: round(v, 4) for k, v in r["warm_stages"].items()})
                + f"; peak {r['peak_gib']:.2f} GiB; launches {r['launches']}; cached "
                f"{r['cached_frames']}/{r['warm_cached_frames']}")
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
            expect(not r["dist_tensor_after_import"] and not r["dist_tensor_after_call"],
                   f"{cell} #{i}: the port loaded torch.distributed.tensor without a mesh")
            for when in ("cold", "warm"):
                # the port has no stage warm (PERF.md): what the JAX package
                # reports with its warms off, whatever the setting
                expect(r[f"{when}_aot"] == {"enabled": False, "used": False}
                       and r[f"{when}_warm"] == {"completed": [], "errors": {}},
                       f"{cell} #{i}: the {when} call's pipeline_aot {r[f'{when}_aot']} and "
                       f"pipeline_warm {r[f'{when}_warm']} with aot_warm={aot}")
            if cell == "northstar" and cached_frames is not None:
                expect(r["cached_frames"] == r["warm_cached_frames"] == cached_frames,
                       f"{cell} #{i}: cached {r['cached_frames']}/{r['warm_cached_frames']} "
                       f"frames against phase 8's {cached_frames}")
        base = rs[0]
        for i, r in enumerate(rs):
            expect(r["recon_sha256"] == base["recon_sha256"] and r["ranks"] == base["ranks"]
                   and r["kept"] == base["kept"] and r["thresholds"] == base["thresholds"]
                   and len(r["thresholds"]) == 1,
                   f"{cell} #{i}: frames, ranks or thresholds differ from the first process's "
                   f"({r['ranks']} / {r['kept']} / {r['thresholds']} against "
                   f"{base['ranks']} / {base['kept']} / {base['thresholds']})")
        # the first two processes are aot_warm "auto" and True
        first = torch.load(os.path.join(tmp, f"{cell}_0.json.recon.pt"))
        second = torch.load(os.path.join(tmp, f"{cell}_1.json.recon.pt"))
        equal = bool(torch.equal(first, second))
        log(f"  {cell}: 512 sampled frames of the first two processes (aot_warm "
            f"{runs[0][0]} and {runs[1][0]}): equal {equal}; thresholds {base['thresholds']}")
        expect(equal, f"{cell}: the sampled frames differ between aot_warm settings")
        del first, second
        med = lambda vals: float(np.median(vals))  # noqa: E731
        timed = [r for r in rs if not r["profiled"]]
        stages = base["cold_stages"].keys()
        summary = dict(
            spawn_to_call_s=med([r["spawn_to_call_s"] for r in rs]),
            port_import_s=med([r["port_import_s"] for r in rs]),
            cold_s=med([r["cold_s"] for r in timed]), warm_s=med([r["warm_s"] for r in timed]),
            cold_stages_s={k: med([r["cold_stages"][k] for r in timed]) for k in stages},
            cold_minus_warm_s={k: med([r["cold_stages"][k] - r["warm_stages"][k] for r in timed])
                               for k in stages},
            peak_gib=max(r["peak_gib"] for r in rs),
            launch_kernel_ms_profiled=[r["launch_kernel_ms"] for r in rs if r["profiled"]],
        )
        log(f"  {cell} medians of the timed processes: " + json.dumps(summary))
    check(not failed, "phase 11: " + "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 12: every movie dtype K1 and K2 read
# ---------------------------------------------------------------------------

# the dtype of each K1 / K2 launch: (kernel, dtype) -> launches, counted at
# the CUDA entry points (the wrappers' own counts stay as they are)
LAUNCH_DTYPES: dict = {}


def install_dtype_spies() -> None:
    """Record the dtype code each launch of K1 and K2 passes to its CUDA
    entry point, in ``LAUNCH_DTYPES``."""
    from localmd_tpu_torch.ops import _build, kernels

    lib = _build.library()
    names = {code: str(dt).removeprefix("torch.") for dt, code in kernels._DTYPE_CODES.items()}
    for kernel, entry in (("movie_stats", "lmd_movie_stats"), ("v_projection", "lmd_v_projection")):
        fn = getattr(lib, entry)
        if getattr(fn, "spied", False):
            continue

        def spy(x, dtype, *rest, _fn=fn, _kernel=kernel):
            key = (_kernel, names.get(dtype, str(dtype)))
            LAUNCH_DTYPES[key] = LAUNCH_DTYPES.get(key, 0) + 1
            return _fn(x, dtype, *rest)

        spy.spied = True
        setattr(lib, entry, spy)


# (d1, d2, T) of phase 12's card-resident movies and the golden movie's
# scale into each dtype (its values span about +-40)
DTYPE_MOVIE = (512, 512, 2048)
GOLDEN_INTO = {"int16": (100.0, -100.0), "uint8": (3.0, 128.0), "int8": (3.0, 0.0)}


def phase_dtypes(raw, u16_ref: dict) -> dict:
    """Phase 12. (a) Phase 8's raw file read as int16 (every value is below
    32768), cache "auto", cold and warm, against phase 8's uint16 runs:
    statistics, ranks and 512 sampled frames, 2 bytes a pixel copied, as
    many frames cached, the native reader, K1 on int16 chunks. (b) Card-
    resident bench_torch.make_movie movies (512 x 512 x 2048) in int16,
    uint8, int8, float16, bfloat16 and float64, each against the float32
    movie of the same values (ranks, 512 sampled frames <= 1e-5), K1 on the
    native dtype (float32 for float64); the golden movie in each dtype, where
    K2 runs (a snapped tail), likewise. (c) The CLI's ``compress --raw-dtype
    int16`` on (a)'s file in a subprocess against (a)'s warm run. Returns
    the launch counts of its runs, counted from 0."""
    import torch

    from bench_torch import (NATIVE_READS, NORTHSTAR_BLOCKS, NORTHSTAR_CONFIG, count_native_reads,
                             make_movie, timed_run)
    from localmd_tpu_torch import RawBinaryArray, load_decomposition
    from localmd_tpu_torch.ops import kernels

    path, t = raw
    log(f"phase 12 dtypes: the north star's raw file read as int16, card-resident movies of "
        f"{', '.join(NEW_DTYPES)} and float64, the CLI with --raw-dtype int16")
    install_dtype_spies()
    count_native_reads()
    reads = NATIVE_READS
    total = {name: 0 for name in KERNELS}

    # (a) the uint16 file as int16
    check(u16_ref["movie_max"] < 32768,
          f"the north star's max {u16_ref['movie_max']} does not fit int16")
    src = RawBinaryArray(path, (t, 512, 512), "int16")
    runs = []
    for kind in ("cold", "warm"):
        kernels.reset_launch_counts()
        reset_route_calls()
        LAUNCH_DTYPES.clear()
        reads.update(calls=0, bytes=0)
        pmd, secs, _ = timed_run(src, blocks=NORTHSTAR_BLOCKS, cache_movie="auto",
                                 **NORTHSTAR_CONFIG)
        launches = kernels.launch_counts()
        total = add_launches(total, launches)
        log_stream_run(f"int16 from disk, cache auto, {kind}", pmd, secs, t)
        log(f"  launches {launches}; K1/K2 launches by dtype {LAUNCH_DTYPES}; native reader "
            f"{reads['calls']} reads, {reads['bytes'] / 1e9:.3f} GB")
        check_stream_launches(f"int16 from disk ({kind})", launches)
        check(set(LAUNCH_DTYPES) == {("movie_stats", "int16")},
              f"int16 from disk: K1/K2 launched on {LAUNCH_DTYPES}")
        check(reads["bytes"] >= t * 512 * 512 * 2,
              f"the native reader read {reads['bytes']} bytes of a {t * 512 * 512 * 2}-byte file")
        runs.append((pmd, secs))
    ref = u16_ref
    for (pmd, secs), ref_secs in zip(runs, (ref["secs"], ref["secs_again"])):
        cache = pmd.pipeline_cache
        mean_d = float(np.abs(pmd.mean_img - ref["mean"]).max())
        var_d = float(np.abs(pmd.var_img - ref["var"]).max())
        recon = pmd.reconstruct_frames(ref["sample"]).cpu()
        err = rel_fro(recon, ref["recon"])
        log(f"  int16 against uint16 (phase 8): {secs:.4f} s against {ref_secs:.4f} s; mean "
            f"max|d| {mean_d:.3e}, var max|d| {var_d:.3e}, ranks {pmd.pipeline_ranks} / kept "
            f"{pmd.rank} against {ref['ranks']} / kept {ref['rank']}; 512 sampled frames rel "
            f"Frobenius {err:.3e}, bit-equal {torch.equal(recon, ref['recon'])}; pinned "
            f"{cache['pinned_bytes'] / 1e9:.3f} GB against {ref['cache']['pinned_bytes'] / 1e9:.3f} "
            f"GB; cached {cache['cached_frames']} against {ref['cache']['cached_frames']}; "
            f"stream dtype {cache['stream_dtype']}")
        check(cache["stream_dtype"] == "int16", f"int16 streamed as {cache['stream_dtype']}")
        check(mean_d <= 1e-5 * float(np.abs(ref["mean"]).max())
              and var_d <= 1e-5 * float(np.abs(ref["var"]).max()), "int16 statistics differ")
        check(pmd.pipeline_ranks == ref["ranks"], "int16 ranks differ from uint16's")
        check(err <= 1e-5, f"int16 sampled frames error {err}")
        check(cache["cached_frames"] == ref["cache"]["cached_frames"],
              "int16 cached another number of frames")
        # every frame read once, 2 bytes a pixel, minus what the cache served
        check(cache["pinned_bytes"] == ref["cache"]["pinned_bytes"] and
              cache["pinned_bytes"] <= t * 512 * 512 * 2,
              f"int16 copied {cache['pinned_bytes']} bytes to the card")
    pmd_warm = runs[-1][0]
    del runs

    # (c) the CLI on the same file, against the warm in-process run
    npz = os.path.join(os.path.dirname(path), "cli_int16.npz")
    args = [sys.executable, "-m", "localmd_tpu_torch.cli", "compress", path, npz,
            "--raw-shape", str(t), "512", "512", "--raw-dtype", "int16",
            "--blocks", str(NORTHSTAR_BLOCKS[0]), str(NORTHSTAR_BLOCKS[1]),
            "--frame-range", str(NORTHSTAR_CONFIG["frame_range"]),
            "--max-components", str(NORTHSTAR_CONFIG["max_components"]),
            "--background-rank", str(NORTHSTAR_CONFIG["background_rank"]),
            "--temporal-avg-factor", str(NORTHSTAR_CONFIG["temporal_avg_factor"]),
            "--rank-prune", "--seed", str(NORTHSTAR_CONFIG["seed"])]
    proc, secs = timed(lambda: subprocess.run(args, capture_output=True, text=True, cwd=HERE,
                                              timeout=600))
    check(proc.returncode == 0, f"cli compress --raw-dtype int16 failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cli_pmd = load_decomposition(npz, device="cuda")
    err = rel_fro(cli_pmd.reconstruct_frames(ref["sample"]),
                  pmd_warm.reconstruct_frames(ref["sample"]))
    log(f"  cli compress --raw-dtype int16: {secs:.2f} s (process), rank {out['rank']} against "
        f"{pmd_warm.rank}, stream dtype {out['cache'].get('stream_dtype')}, 512 sampled frames "
        f"rel Frobenius {err:.3e}")
    check(out["rank"] == pmd_warm.rank and out["cache"].get("stream_dtype") == "int16",
          "cli int16 run differs from the in-process run")
    check(err <= 1e-5, f"cli int16 reconstruction error {err}")
    os.remove(npz)
    del cli_pmd, pmd_warm
    torch.cuda.empty_cache()

    # (b) card-resident movies of each dtype against the float32 movie of their values
    d1, d2, t_mv = DTYPE_MOVIE
    sample = np.sort(np.random.default_rng(0).choice(t_mv, 512, replace=False))
    golden, g_t, g_r = golden_movie()
    golden = torch.as_tensor(golden, device="cuda")
    for name in NEW_DTYPES + ("float64",):
        movie, _ = make_movie(name, d1, d2, t_mv)
        kernels.reset_launch_counts()
        reset_route_calls()
        LAUNCH_DTYPES.clear()
        pmd, secs, _ = timed_run(movie)
        k1_dtypes = {dt for (k, dt) in LAUNCH_DTYPES if k == "movie_stats"}
        pmd32, secs32, _ = timed_run(movie.float())
        want = name if name != "float64" else "float32"
        err = rel_fro(pmd.reconstruct_frames(sample), pmd32.reconstruct_frames(sample))
        launches = kernels.launch_counts()
        total = add_launches(total, launches)
        # the golden movie in this dtype: its 40 x 36 grid keeps K2
        scale, offset = GOLDEN_INTO.get(name, (1.0, 0.0))
        lo, hi = (torch.iinfo(getattr(torch, name)).min, torch.iinfo(getattr(torch, name)).max) \
            if name in GOLDEN_INTO else (-1e30, 1e30)
        g_mv = (golden * scale + offset).round().clamp(lo, hi) if name in GOLDEN_INTO else golden
        g_mv = g_mv.to(getattr(torch, name))
        kernels.reset_launch_counts()
        LAUNCH_DTYPES.clear()
        g_pmd = golden_run(g_mv, g_t, g_r)
        g_dtypes = dict(LAUNCH_DTYPES)
        total = add_launches(total, kernels.launch_counts())
        g_32 = golden_run(g_mv.float(), g_t, g_r)
        g_err = rel_fro(g_pmd.reconstruct_frames(np.arange(g_t)),
                        g_32.reconstruct_frames(np.arange(g_t)))
        log(f"  {name} card-resident {d1}x{d2}x{t_mv}: {secs:.4f} s against float32 "
            f"{secs32:.4f} s; ranks {pmd.pipeline_ranks} / kept {pmd.rank} against "
            f"{pmd32.pipeline_ranks} / kept {pmd32.rank}; 512 sampled frames rel Frobenius "
            f"{err:.3e}; K1 on {sorted(k1_dtypes)}; launches {launches}; golden in {name}: "
            f"rel Frobenius {g_err:.3e} against its float32 values, K1/K2 by dtype {g_dtypes}")
        check(k1_dtypes == {want}, f"{name}: K1 launched on {k1_dtypes}")
        check(pmd.pipeline_ranks == pmd32.pipeline_ranks and pmd.rank == pmd32.rank,
              f"{name}: ranks differ from the float32 movie's")
        check(err <= 1e-5, f"{name}: sampled frames error {err}")
        check(set(g_dtypes) == {("movie_stats", want), ("v_projection", want)},
              f"golden in {name}: K1/K2 launched on {g_dtypes}")
        check(g_pmd.pipeline_ranks == g_32.pipeline_ranks and g_err <= 1e-5,
              f"golden in {name}: error {g_err} against its float32 values")
        del movie, pmd, pmd32, g_pmd, g_32, g_mv
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 13: the demo at full size, the grid's cached constants, the console
# script
# ---------------------------------------------------------------------------

DEMO_SHAPE = (512, 512, 4096)       # (d1, d2, T): the north star's FOV
GRID_CACHE_CALLS = 3                # warm calls per side and round, P / C / C / P


def phase_demo(tmp: str) -> tuple:
    """Phase 13 (a): ``demos/demo_torch.py --device cuda --no-plots`` in a
    subprocess on its sim movie at ``DEMO_SHAPE``. Returns the launches it
    reports, summed over its steps, and its .npz with its rank."""
    import torch

    d1, d2, t = DEMO_SHAPE
    out_dir = os.path.join(tmp, "demo")
    torch.cuda.empty_cache()        # the subprocess needs the card's memory
    cmd = [sys.executable, os.path.join(HERE, "demos", "demo_torch.py"), "", out_dir,
           "--d1", str(d1), "--d2", str(d2), "--t", str(t), "--device", "cuda", "--no-plots"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    log(f"phase 13 (a) demos/demo_torch.py on a {d1}x{d2}x{t} float32 sim movie "
        f"({d1 * d2 * t * 4 / 1e9:.1f} GB) in a subprocess")
    proc, wall = timed(lambda: subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                                              env=env, timeout=900))
    check(proc.returncode == 0,
          f"demo_torch.py exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    for line in lines[:-1]:
        log(f"  demo: {line}")
    rnr = summary["residual_noise_ratio"]
    log(f"  demo wall {wall:.3f} s (process start to exit), decomposition "
        f"{summary['seconds']:.4f} s, kept rank {summary['rank']}, residual_noise_ratio "
        f"{rnr:.6f}; launches per step {summary['launches']}")
    check("--no-plots: skipped the QC panel and the component browser" in lines,
          "the demo did not say that it skipped the renderings")
    check(summary["shape"] == [t, d1, d2] and summary["rank"] >= 1,
          f"demo shape {summary['shape']}, rank {summary['rank']}")
    check(0.3 < rnr < 3.0, f"the demo's residual_noise_ratio {rnr} is outside (0.3, 3)")
    steps = summary["launches"]
    for step, name in (("decomposition", "movie_stats"), ("decomposition", "jacobi_eigh"),
                       ("export_tiff", "block_reconstruct")):
        check(steps[step][name] > 0, f"the demo's {step} never launched {name}")
    n_export = min(500, t)
    check(os.path.getsize(summary["tiff"]) >= n_export * d1 * d2 * 2,
          "the demo's TIFF is short")
    launches = {name: sum(step[name] for step in steps.values()) for name in KERNELS}
    return launches, (summary["npz"], summary["rank"])


def phase_grid_cache() -> dict:
    """Phase 13 (b): the grid's device constants on bench_torch.py's 1024_u16
    cell. One cold call, then warm calls in rounds P / C / C / P: P is the
    per-call rebuild the pipeline made before the grid cached its constants
    (pageable copies, the row map cast on the host), C reads them from the
    memoized grid. The cache is
    cleared before the first C round: its first call uploads once, the rest
    of the C calls none (counted in ``device_constants``, not timed). Then
    the bytes ``clear_block_grid_cache`` frees. Returns the launches of all
    the calls, counted from 0 before the first."""
    import torch

    from bench_torch import CELLS, make_movie, timed_run
    from localmd_tpu_torch.ops import kernels, tiling
    from localmd_tpu_torch.ops.tiling import (BlockGrid, block_grid, clear_block_grid_cache,
                                              flatten_image)

    d1, d2, t, dtype, settings = CELLS["1024_u16"]
    log(f"phase 13 (b) grid cache on {d1}x{d2}x{t} {dtype} {settings}: cold, then "
        f"{GRID_CACHE_CALLS} warm calls a round, P / C / C / P")
    clear_block_grid_cache()        # earlier phases' grids: only this cell's is measured
    movie, _ = make_movie(dtype, d1, d2, t)
    cached = BlockGrid.device_constants

    def per_call(self, device):
        """The rebuild on every call that the pipeline made before
        ``device_constants`` existed."""
        dev = torch.device(device)
        return (flatten_image(torch.as_tensor(self.weights), "F").to(dev),
                flatten_image(torch.as_tensor(self.cumulative_weights), self.order).to(dev),
                torch.as_tensor(self.rows, dtype=torch.long, device=dev), None)

    sample = np.sort(np.random.default_rng(0).choice(t, 64, replace=False))
    kernels.reset_launch_counts()
    _, cold, _ = timed_run(movie, **settings)
    walls, ref = {"P": [], "C": []}, None
    for i, side in enumerate("PCCP"):
        if side == "P":
            BlockGrid.device_constants = per_call
        elif i == 1:
            clear_block_grid_cache()
        uploads = []
        try:
            for _ in range(GRID_CACHE_CALLS):
                before = tiling.UPLOADS["device_constants"]
                pmd, secs, _ = timed_run(movie, **settings)
                uploads.append(tiling.UPLOADS["device_constants"] - before)
                walls[side].append(secs)
                got = (pmd.pipeline_ranks, pmd.reconstruct_frames(sample))
                ref = ref or got
                check(got[0] == ref[0], f"{side}: ranks {got[0]} vs {ref[0]}")
                check(torch.equal(got[1], ref[1]),
                      f"{side}: 64 sampled frames differ from the first warm call's")
                del pmd, got
        finally:
            BlockGrid.device_constants = cached
        log(f"  round {i + 1} ({side}): walls "
            f"{[round(w, 4) for w in walls[side][-GRID_CACHE_CALLS:]]} s, uploads of the grid "
            f"constants per call {uploads}")
        want = [int(i == 1)] + [0] * (GRID_CACHE_CALLS - 1)
        check(uploads == want, f"round {i + 1} ({side}): uploads {uploads}, expected {want}")
    del ref
    launches = kernels.launch_counts()
    med = {side: float(np.median(w)) for side, w in walls.items()}
    log(f"  cold {cold:.4f} s; warm medians: per-call rebuild (P) {med['P']:.4f} s, cached (C) "
        f"{med['C']:.4f} s over {2 * GRID_CACHE_CALLS} calls a side (no claim: one card, "
        f"one process)")

    grid = block_grid(d1, d2, tuple(settings["blocks"]), "F")
    before = tiling.UPLOADS["device_constants"]
    held = list(grid.device_constants("cuda"))
    ids, _, _, _, _, inv = grid.coset_info("cuda")
    held += [*ids, inv]
    check(tiling.UPLOADS["device_constants"] == before, "the grid's constants were not cached")
    held_bytes = sum(x.numel() * x.element_size() for x in held)
    del grid, held, ids, inv
    gc.collect()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    clear_block_grid_cache()
    gc.collect()
    torch.cuda.synchronize()
    freed = allocated - torch.cuda.memory_allocated()
    log(f"  clear_block_grid_cache(): {freed} bytes freed ({freed / 1e6:.3f} MB; the grid held "
        f"{held_bytes} bytes of constants and coset ids)")
    check(freed >= held_bytes > 0, f"clear_block_grid_cache freed {freed} of {held_bytes} bytes")
    del movie
    torch.cuda.empty_cache()
    return launches


def phase_console_script(npz: str, rank: int) -> None:
    """Phase 13 (c): ``localmd-tpu-torch info`` on an .npz; where the script
    is not installed, the entry point pyproject.toml declares, through
    ``python3 -c``."""
    import tomllib

    with open(os.path.join(HERE, "pyproject.toml"), "rb") as f:
        spec = tomllib.load(f)["project"]["scripts"]["localmd-tpu-torch"]
    check(spec == "localmd_tpu_torch.cli:main", f"localmd-tpu-torch names {spec}")
    exe = shutil.which("localmd-tpu-torch")
    if exe:
        cmd, how = [exe], f"the installed script {exe}"
    else:
        module, attr = spec.split(":")
        code = f"import sys; from {module} import {attr}; sys.exit({attr}(sys.argv[1:]))"
        cmd, how = [sys.executable, "-c", code], f"not installed: {spec} through python3 -c"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    proc, secs = timed(lambda: subprocess.run(cmd + ["info", npz], capture_output=True, text=True,
                                              cwd=HERE, env=env, timeout=300))
    check(proc.returncode == 0, f"localmd-tpu-torch info failed ({how}):\n{proc.stderr[-3000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"phase 13 (c) localmd-tpu-torch info ({how}): {secs:.2f} s, {json.dumps(info)}")
    check(info["rank"] == rank and info["frames"] > 0, f"info rank {info['rank']}, expected {rank}")


def phase_demo_and_grid_cache(tmp: str, cli_npz) -> dict:
    """Phase 13: (a) the demo, (b) the grid cache, (c) the console script on
    phase 8's .npz, or the demo's where phase 8 did not run. Returns the
    launches of (a) and (b)."""
    launches_a, demo_npz = phase_demo(tmp)
    launches_b = phase_grid_cache()
    phase_console_script(*(cli_npz or demo_npz))
    return add_launches(launches_a, launches_b)


# ---------------------------------------------------------------------------
# phase 14: the card against the JAX package on every parity case
# ---------------------------------------------------------------------------

PARITY_DIR = os.path.join(HERE, "tests", "golden", "torch_parity")
PARITY_RECON_TOL = 1e-4         # relative Frobenius, through K3 and through slicing
PARITY_IMG_RTOL = 1e-4          # mean_img and var_img


def parity_module():
    """``tests/torch_parity_cases.py``: numpy only, the case table."""
    if os.path.join(HERE, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_parity_cases

    return torch_parity_cases


def parity_cases():
    """The case table and the JAX package's committed records: (module,
    cases.json, the stored draws)."""
    with open(os.path.join(PARITY_DIR, "cases.json")) as f:
        records = json.load(f)
    return parity_module(), records, dict(np.load(os.path.join(PARITY_DIR, "draws.npz")))


def pinned_run(movie, blocks, device: str, thresholds, draw, **options):
    """``localmd_decomposition`` with every Gaussian draw replaced by
    ``draw`` and ``threshold_heuristic`` pinned to ``thresholds``: the port
    where the JAX package's result was made with the same draws."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    thresholds = tuple(thresholds)
    saved = port_pipeline.threshold_heuristic
    port_pipeline.threshold_heuristic = lambda *a, **k: thresholds
    try:
        with sketch_override(draw):
            return port_pipeline.localmd_decomposition(movie, blocks, device=device, **options)
    finally:
        port_pipeline.threshold_heuristic = saved


def parity_run(name: str, device: str, records: dict, draws: dict):
    """One parity case through the port as its CPU test runs it: the movie
    as a numpy array, the case's sketch and stored rank-prune matrix
    injected, ``threshold_heuristic`` pinned to the JAX package's values."""
    cases = parity_module()
    return pinned_run(cases.movie(name), cases.CASES[name]["blocks"], device,
                      records[name]["thresholds"], cases.draws(name, draws.get(name)),
                      **cases.options(name))


def cut_margin(s, rel_tol: float) -> float:
    """The relative distance from the kept-rank cut (``rel_tol`` s_0) of the
    singular value nearest it: small means a rounding can move the kept
    rank."""
    s = np.asarray(s, np.float64)
    cut = rel_tol * s[0]
    return float(np.min(np.abs(s - cut)) / cut) if cut > 0 else float("inf")


def parity_errors(pmd, ref) -> dict:
    """The port's result against the JAX package's (a host PMDArray)."""
    want = ref[:, :, :]
    norm = np.linalg.norm(want)
    recon = pmd.reconstruct_frames(np.arange(pmd.shape[0])).cpu().numpy()
    return dict(
        k3=float(np.linalg.norm(recon - want) / norm),
        slicing=float(np.linalg.norm(pmd[:, :, :] - want) / norm),
        **cells_module().image_errors(pmd.mean_img, pmd.var_img, ref.mean_img, ref.var_img),
    )


@contextlib.contextmanager
def singular_spy():
    """Within the block, ``values["s"]`` and ``values["tol"]`` hold the
    singular values the final reformat cut and its relative tolerance, for
    ``cut_margin``."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch import factorization

    values = {}
    real_final, real_svd = port_pipeline.final_svd_reformat, factorization.projected_svd

    def svd_spy(p, v):
        out = real_svd(p, v)
        values["s"] = out[1].cpu().numpy()
        return out

    def final_spy(p, v, rel_tol=1e-3):
        values["tol"] = rel_tol
        factorization.projected_svd = svd_spy
        try:
            return real_final(p, v, rel_tol=rel_tol)
        finally:
            factorization.projected_svd = real_svd

    port_pipeline.final_svd_reformat = final_spy
    try:
        yield values
    finally:
        port_pipeline.final_svd_reformat, factorization.projected_svd = real_final, real_svd


def phase_parity() -> dict:
    """Phase 14: every case of ``tests/torch_parity_cases.py`` on the card
    against the JAX package's committed result. Every case runs and is
    reported before the phase fails on any miss; a case that misses is run
    again with the routes forced off, for the report. Returns the launch
    counts of the phase's runs and read-backs (counted from 0)."""
    import torch

    from bench_torch import set_routes
    from localmd_tpu_torch import load_decomposition
    from localmd_tpu_torch.ops import kernels

    cases, records, draws = parity_cases()
    log(f"phase 14 the card against the JAX package: {len(cases.CASES)} cases of "
        f"tests/torch_parity_cases.py, fixtures {os.path.relpath(PARITY_DIR, HERE)}")
    misses, irregular_k2 = [], []
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    with singular_spy() as singular:
        for name, case in cases.CASES.items():
            record = records[name]
            ref = load_decomposition(os.path.join(PARITY_DIR, f"{name}.npz"), device=None)
            before = kernels.launch_counts()
            reset_route_calls()
            t0 = time.perf_counter()
            pmd = parity_run(name, "cuda", records, draws)
            secs = time.perf_counter() - t0
            err = parity_errors(pmd, ref)
            routes = dict(ROUTE_CALLS)
            launched = {k: n - before[k] for k, n in kernels.launch_counts().items()}
            opts = cases.options(name)
            d1, d2 = case["shape"][1:]
            want = expected_routes(d1, d2, case["blocks"], single_window=not case.get("window_chunks"),
                                   spatial_avg_factor=opts.get("spatial_avg_factor", 2))
            margin = cut_margin(singular["s"], singular["tol"])
            log(f"  {name} {case['shape']} {case['dtype']} blocks {case['blocks']}: {secs:.2f} s; "
                f"rel Frobenius {err['k3']:.3e} (K3) / {err['slicing']:.3e} (slicing); mean "
                f"{err['mean']:.2e}, var {err['var']:.2e}; ranks {pmd.pipeline_ranks} kept "
                f"{pmd.rank} (JAX {record['pipeline_ranks']} kept {record['rank']}); kept-rank "
                f"cut margin {margin:.3e}; launches {launched}; routes {routes}")
            check_path(f"parity {name}", launched, routes, want,
                       kernels_run=("movie_stats", "block_reconstruct", "jacobi_eigh"))
            if name == "regular_48":
                check(all(want.values()), f"parity regular_48: expected every route, {want}")
            if not want["cell_vproj"]:
                irregular_k2.append(name)
            missed = [what for what, bad in (
                ("reconstruction", max(err["k3"], err["slicing"]) > PARITY_RECON_TOL),
                ("mean_img", err["mean"] > PARITY_IMG_RTOL),
                ("var_img", err["var"] > PARITY_IMG_RTOL),
                ("pipeline_ranks", pmd.pipeline_ranks != record["pipeline_ranks"]),
                ("kept rank", pmd.rank != record["rank"])) if bad]
            if missed:
                misses.append(f"{name}: {', '.join(missed)}")
                set_routes(False)
                try:
                    off = parity_run(name, "cuda", records, draws)
                finally:
                    set_routes("auto")
                err_off = parity_errors(off, ref)
                log(f"  {name} MISSED {missed}; routes off: rel Frobenius {err_off['k3']:.3e} / "
                    f"{err_off['slicing']:.3e}, ranks {off.pipeline_ranks} kept {off.rank}")
                del off
            del pmd
            torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    log(f"  phase 14: {time.perf_counter() - t_phase:.2f} s for {len(cases.CASES)} cases; launches "
        f"{launches}; cases taking K2 (irregular grids): {irregular_k2}")
    check(not misses, "phase 14: " + "; ".join(misses))
    for name in KERNELS:
        check(launches[name] > 0, f"phase 14 never launched {name}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the card against the JAX package at the main path's full width
# ---------------------------------------------------------------------------

FULL_DIR = os.path.join(HERE, "tests", "golden", "torch_parity_full")
FULL_TOL = 1e-4                 # both fingerprints and s, relative
# a keep decision whose statistic lies this close to its threshold in both
# packages (relative) is an fp32 tie, taken from the JAX package
FULL_TIE_RTOL = 1e-4
# (case, routes): the coset stage, the banded Gram and the cell V route;
# the gather stage, the canvas Gram and K2 (the JAX CPU reference's forms);
# K1 reading uint16
FULL_RUNS = (("full_512_f32", "auto"), ("full_512_f32", False), ("full_512_u16", "auto"))


def full_module():
    """``tests/torch_parity_full.py``: numpy only, the full-width cases."""
    parity_module()
    import torch_parity_full

    return torch_parity_full


def full_fixtures():
    """The JAX package's committed full-width results: (cases.json, the
    rank-prune matrix, {case: its arrays})."""
    with open(os.path.join(FULL_DIR, "cases.json")) as f:
        records = json.load(f)
    prune = np.load(os.path.join(FULL_DIR, "draws.npz"))["prune"]
    refs = {name: dict(np.load(os.path.join(FULL_DIR, f"{name}.npz"))) for name in records}
    return records, prune, refs


def full_run(name: str, device: str, movie, record: dict, prune):
    """One full-width case through the port: the sketch and the stored
    rank-prune matrix injected, the thresholds pinned to the JAX
    package's Monte-Carlo."""
    full = full_module()
    return pinned_run(movie, full.FULL_CASES[name]["blocks"], device, record["thresholds"],
                      full.draws(prune), **full.OPTIONS)


def full_width_errors(pmd, ref: dict) -> tuple:
    """The port's result against the JAX package's stored arrays: (errors,
    the port's fingerprint). The errors: both fingerprints of
    ``reconstruct_frames`` (K3) over every frame (``card_fingerprint``,
    float64 on the run's device), ``s`` and the images, each relative."""
    full = full_module()
    fp = card_fingerprint(pmd, full.probes(tuple(pmd.shape)), full.FINGERPRINT_CHUNK)
    err = full.fingerprint_errors(fp, ref)
    s, s_ref = np.asarray(pmd.s, np.float64), ref["s"].astype(np.float64)
    err["s"] = (float(np.linalg.norm(s - s_ref) / np.linalg.norm(s_ref))
                if s.shape == s_ref.shape else float("inf"))
    err.update(cells_module().image_errors(pmd.mean_img, pmd.var_img, ref["mean_img"],
                                           ref["var_img"]))
    return err, fp


def s_by_index(s, s_ref) -> str:
    """Where ``s`` differs from the JAX package's ``s_ref``: each value's
    relative difference, over the shorter of the two."""
    n = min(len(s), len(s_ref))
    line = f"s by index against JAX (relative, over {n} of {len(s)} and {len(s_ref)})"
    if not n:
        return line
    rel = np.abs(np.asarray(s[:n], np.float64) - s_ref[:n]) / np.asarray(s_ref[:n], np.float64)
    line += f": s_0 {rel[0]:.2e}, the first 12 within {rel[:12].max():.2e}"
    if n > 12:
        line += f", the rest median {np.median(rel[12:]):.2e} and max {rel[12:].max():.2e}"
    return line


def full_width_misses(err: dict, pipeline_ranks: dict, rank: int, record: dict) -> list:
    """The bars phases 15 and 16 hold each run to, and the CPU tests too:
    the names of those it misses (a NaN error misses)."""
    return [what for what, bad in (
        ("fingerprint psi_y", not err["psi_y"] <= FULL_TOL),
        ("fingerprint y_omega", not err["y_omega"] <= FULL_TOL),
        ("s", not err["s"] <= FULL_TOL),
        ("mean_img", not err["mean"] <= PARITY_IMG_RTOL),
        ("var_img", not err["var"] <= PARITY_IMG_RTOL),
        # phase 16's images seen through psi as well
        ("mean_img probe", "mean_probe" in err and not err["mean_probe"] <= FULL_TOL),
        ("var_img probe", "var_probe" in err and not err["var_probe"] <= FULL_TOL),
        ("pipeline_ranks", dict(pipeline_ranks) != record["pipeline_ranks"]),
        ("kept rank", rank != record["rank"])) if bad]


@contextlib.contextmanager
def block_spy(order=None, overrides=None):
    """Within the block: ``values["counts"]``, the kept count of each block
    as the pipeline hands them to its checkpoint, ``values["stats"]``, the
    (spatial, temporal) roughness statistics of each ``evaluate_fitness``
    call in call order, and ``values["windows"]``, each call's window (0
    for the two-stage kernel's, w for the w-th residual window since, -1
    for the zero-count fallback). ``order`` is the block id of each row of
    a window's calls in turn (the coset plan's lattice order, or block
    order for gathered batches); ``overrides`` maps (block, component), or
    (window, block, component), to the keep decision that replaces the
    port's there, and ``values["forced"]`` counts the replacements made."""
    from localmd_tpu_torch import checkpoint, engine
    from localmd_tpu_torch.ops.roughness import spatial_roughness_stat, temporal_roughness_stat

    values = dict(counts=None, stats=[], windows=[], forced=0)
    overrides = {(key if len(key) == 3 else (0, *key)): keep
                 for key, keep in dict(overrides or {}).items()}
    state = dict(window=0, kind="first")
    real_save, real_fitness = checkpoint.PipelineCheckpoint.save, engine.evaluate_fitness
    real_residual, real_fallback = engine.single_residual_block_md_batched, engine._fallback_rerun

    def save(ckpt, stage, **arrays):
        if stage == "blocks":
            values["counts"] = np.asarray(arrays["counts"])
        return real_save(ckpt, stage, **arrays)

    def tagged(fn, kind):
        def run(*args, **kwargs):
            if kind == "residual":
                state["window"] += 1
            state["kind"] = kind
            try:
                return fn(*args, **kwargs)
            finally:
                state["kind"] = "first"
        return run

    def fitness(images, traces, spatial_threshold, temporal_threshold):
        decisions = real_fitness(images, traces, spatial_threshold, temporal_threshold)
        if state["kind"] == "first":
            state["window"] = 0
        w = -1 if state["kind"] == "fallback" else state["window"]
        lo = sum(len(sp) for (sp, _), ww in zip(values["stats"], values["windows"]) if ww == w)
        values["stats"].append((spatial_roughness_stat(images), temporal_roughness_stat(traces)))
        values["windows"].append(w)
        for (ow, b, k), keep in overrides.items():
            rows = np.flatnonzero(order[lo:lo + len(decisions)] == b) if ow == w else ()
            if len(rows):
                decisions[int(rows[0]), k] = int(keep)
                values["forced"] += 1
        return decisions

    changes = ((checkpoint.PipelineCheckpoint, "save", save, real_save),
               (engine, "evaluate_fitness", fitness, real_fitness),
               (engine, "single_residual_block_md_batched", tagged(real_residual, "residual"),
                real_residual),
               (engine, "_fallback_rerun", tagged(real_fallback, "fallback"), real_fallback))
    for owner, attr, spy, _ in changes:
        setattr(owner, attr, spy)
    try:
        yield values
    finally:
        for owner, attr, _, real in changes:
            setattr(owner, attr, real)


def block_order(coset: bool, shape=None, blocks=None) -> np.ndarray:
    """The block id of each ``evaluate_fitness`` row of one window of a run
    on ``shape``'s FOV (T, d1, d2) with ``blocks`` (phase 15's by default):
    the coset stage's lattice order and then the blocks off its lattices
    (a snapped tail, one gathered batch), or block order for gathered
    batches."""
    from localmd_tpu_torch import engine
    from localmd_tpu_torch.ops.tiling import block_grid

    full = full_module()
    (_, d1, d2), (b1, b2) = shape or full.SHAPE, blocks or full.BLOCKS
    if not coset:
        return np.arange(block_grid(d1, d2, (b1, b2)).n_blocks)
    _, ids, remainder = engine.coset_stage_plan(d1, d2, b1, b2)
    return np.concatenate([np.asarray(ids), np.asarray(remainder, dtype=np.int64)])


def window_stats(values: dict, order, n_windows: int = 1) -> tuple:
    """The port's (spatial, temporal) statistics of a run, each (windows,
    blocks, components) in block order; None when a window's rows are not
    one per block or the fallback ran."""
    if -1 in values["windows"]:
        return None
    out = []
    for i in (0, 1):
        per = []
        for w in range(n_windows):
            parts = [st[i].cpu().numpy() for st, ww in zip(values["stats"], values["windows"])
                     if ww == w]
            if sum(len(p) for p in parts) != len(order):
                return None
            rows = np.concatenate(parts)
            stat = np.empty_like(rows)
            stat[order] = rows
            per.append(stat)
        out.append(np.stack(per))
    return tuple(out)


def block_flips(port_stats, jax_stats, thresholds, port_counts, jax_counts) -> list:
    """One entry per block whose kept count differs from the JAX
    package's: the first component whose keep decision differs, each
    package's statistic of every kind that decides it differently beside
    the threshold, and whether that is an fp32 tie (every such statistic,
    in both packages, within ``FULL_TIE_RTOL`` of its threshold)."""
    full = full_module()
    keep_port = full.keep_decisions(*port_stats, thresholds)
    keep_jax = full.keep_decisions(*jax_stats, thresholds)
    flips = []
    for b in np.flatnonzero(np.asarray(port_counts) != np.asarray(jax_counts)):
        differ = np.flatnonzero(keep_port[b] != keep_jax[b])
        entry = dict(block=int(b), port_count=int(port_counts[b]), jax_count=int(jax_counts[b]),
                     component=None, jax_keeps=None, kinds={}, tie=False)
        if differ.size:
            k = int(differ[0])
            entry.update(component=k, jax_keeps=bool(keep_jax[b, k]))
            for i, kind in enumerate(("spatial", "temporal")):
                port, jax, thr = float(port_stats[i][b, k]), float(jax_stats[i][b, k]), thresholds[i]
                if (port < thr) != (jax < thr):
                    entry["kinds"][kind] = (port, jax, thr)
            entry["tie"] = bool(entry["kinds"]) and all(
                abs(port - thr) <= FULL_TIE_RTOL * thr and abs(jax - thr) <= FULL_TIE_RTOL * thr
                for port, jax, thr in entry["kinds"].values())
        flips.append(entry)
    return flips


def describe_flip(flip: dict, starts) -> str:
    line = (f"window {flip['window']}, " if "window" in flip else "") + (f"block {flip['block']} at {tuple(int(x) for x in starts[flip['block']])}: kept "
            f"{flip['port_count']}, JAX {flip['jax_count']}")
    if flip["component"] is None:
        return line + "; no component's keep decision differs"
    line += f"; component {flip['component']}"
    for kind, (port, jax, thr) in flip["kinds"].items():
        line += (f", {kind} {port:.7g} (JAX {jax:.7g}, threshold {thr:.7g}; "
                 f"{(port - thr) / thr:+.2e} / {(jax - thr) / thr:+.2e} of it)")
    return line + ("; an fp32 tie" if flip["tie"] else "; NOT a tie")


def full_width_check(name: str, routes_setting, device: str, movie, record: dict, prune,
                     ref: dict) -> dict:
    """One full-width run held to the JAX package's stored result at phase
    15's bars, on the card or on the CPU. Where the blockwise ranks differ,
    the blocks that differ are reported; if every one is an fp32 tie (the
    deciding statistic within ``FULL_TIE_RTOL`` of its threshold in both
    packages), the run is made again with the JAX package's decision at
    each tie, as its thresholds and draws are injected, and that run is
    held to every bar. Returns ``misses`` (empty when the bars are met),
    ``ties`` and each run's numbers."""
    from bench_torch import set_routes
    from localmd_tpu_torch.ops.tiling import block_grid

    full = full_module()
    (_, d1, d2), blocks = full.SHAPE, full.BLOCKS
    set_routes(routes_setting)
    try:
        result = dict(runs=[], ties=[], misses=[])
        order, overrides = None, {}
        for attempt in ("run", "ties injected"):
            reset_route_calls()
            with singular_spy() as singular, block_spy(order, overrides) as spied:
                t0 = time.perf_counter()
                pmd = full_run(name, device, movie, record, prune)
                secs = time.perf_counter() - t0
            routes = dict(ROUTE_CALLS)
            t0 = time.perf_counter()
            err, fp = full_width_errors(pmd, ref)
            run = dict(attempt=attempt, secs=secs, read_secs=time.perf_counter() - t0, err=err,
                       fingerprint=fp,
                       ranks=dict(pmd.pipeline_ranks), rank=int(pmd.rank), routes=routes,
                       margin=cut_margin(singular["s"], singular["tol"]), forced=spied["forced"])
            s_line = s_by_index(pmd.s, ref["s"])
            del pmd
            result["runs"].append(run)
            missed = full_width_misses(err, run["ranks"], run["rank"], record)
            log(f"  {name} routes {routes_setting} ({attempt}): {secs:.2f} s the call, "
                f"{run['read_secs']:.2f} s the fingerprint (K3 over {full.SHAPE[0]} frames); "
                f"fingerprint psi_y {err['psi_y']:.3e}, y_omega {err['y_omega']:.3e}; s "
                f"{err['s']:.3e}; mean {err['mean']:.2e}, var {err['var']:.2e}; ranks "
                f"{run['ranks']} kept {run['rank']} (JAX {record['pipeline_ranks']} kept "
                f"{record['rank']}); kept-rank cut margin {run['margin']:.3e}; routes {routes}"
                + (f"; decisions replaced {spied['forced']}" if overrides else ""))
            order = block_order(routes["coset_stage"] > 0)
            stats = window_stats(spied, order)
            stats = None if stats is None else (stats[0][0], stats[1][0])
            log(f"    {s_line}")
            if stats is not None:
                jax_stats = ref["block_spatial"], ref["block_temporal"]
                diff = [np.median(np.abs(p - j) / np.abs(j)) for p, j in zip(stats, jax_stats)]
                near = min(float(np.min(np.abs(p - t) / t))
                           for p, t in zip(stats, record["thresholds"]))
                log(f"    block statistics against JAX's: median relative difference "
                    f"{diff[0]:.2e} (spatial), {diff[1]:.2e} (temporal); the port's nearest to a "
                    f"threshold {near:.2e} of it")
            if attempt == "ties injected":
                if spied["forced"] != len(overrides):
                    missed.append(f"{spied['forced']} of {len(overrides)} tie decisions replaced")
                result["misses"] = missed
                break
            if np.array_equal(spied["counts"], ref["block_counts"]):
                result["misses"] = missed
                break
            if stats is None or not np.array_equal(
                    full.kept_counts(*stats, record["thresholds"]), spied["counts"]):
                result["misses"] = missed + ["the port's block statistics were not captured"]
                break
            flips = block_flips(stats, (ref["block_spatial"], ref["block_temporal"]),
                                record["thresholds"], spied["counts"], ref["block_counts"])
            starts = block_grid(d1, d2, blocks).starts
            for flip in flips:
                log(f"    {describe_flip(flip, starts)}")
            if not all(flip["tie"] for flip in flips):
                result["misses"] = missed + ["blockwise ranks past an fp32 tie"]
                break
            result["ties"] = flips
            overrides = {(f["block"], f["component"]): f["jax_keeps"] for f in flips}
        return result
    finally:
        set_routes("auto")


def stats_f64(chunk2d, mean_divisor, compute_noise: bool, pixels: int = 65536) -> tuple:
    """K1's plain twin (``ops.kernels.movie_stats_plain``) in float64 on the
    chunk's device: (mean, sigma), float64. The windowed DFT matrices are
    the float32 ones K1 is given (their angles carry the reference's
    rounding), widened; ``pixels`` traces at a time."""
    import torch

    from localmd_tpu_torch.ops.noise import NOVERLAP, NPERSEG, _band_dft_matrices, welch_scale

    x = chunk2d.to(torch.float64)
    mean = x.sum(dim=0) / mean_divisor
    if not compute_noise:
        return mean, torch.zeros_like(mean)
    cos_m, sin_m, cos_1, sin_1 = (m.to(torch.float64) for m in _band_dft_matrices(NPERSEG, x.device))
    scale = welch_scale(NPERSEG, x.device).to(torch.float64)
    k = torch.arange(NPERSEG // 4 + 1, NPERSEG // 2 + 1, device=x.device)
    sigma = torch.empty_like(mean)
    for lo in range(0, x.shape[1], pixels):
        segs = x[:, lo:lo + pixels].T.unfold(-1, NPERSEG, NPERSEG - NOVERLAP)
        m = segs.mean(dim=-1, keepdim=True)
        re = segs @ cos_m - m * cos_1
        im = segs @ sin_m - m * sin_1
        band = ((re * re + im * im) * scale).mean(dim=-2)
        band = torch.where(2 * k >= NPERSEG, band * 0.5, band)
        sigma[lo:lo + pixels] = torch.sqrt(band.mean(dim=-1))
    return mean, sigma


def k1_attribution(movie, ref: dict) -> dict:
    """The statistics of ``movie`` (T, d1, d2) on the card twice, as the
    loader forms them (1024-frame chunks, the means summed, sigma averaged
    over the chunks of at least 256 frames): through K1, and through its
    plain twin in float64 (``stats_f64``). Returns each side's largest
    relative error of ``mean_img`` and ``var_img`` against the JAX
    package's ``ref``. A measurement: nothing checks it."""
    import torch

    from localmd_tpu_torch.loader import MIN_NOISE_FRAMES, STATS_CHUNK_FRAMES
    from localmd_tpu_torch.ops import kernels

    t, d1, d2 = movie.shape
    sums = {"K1": [0, 0, 0], "plain float64": [0, 0, 0]}
    for lo in range(0, t, STATS_CHUNK_FRAMES):
        hi = min(t, lo + STATS_CHUNK_FRAMES)
        chunk = torch.from_numpy(np.ascontiguousarray(movie[lo:hi])).cuda().reshape(hi - lo, d1 * d2)
        noise = hi - lo >= MIN_NOISE_FRAMES
        for side, (m, sig) in (("K1", kernels.movie_stats(chunk, t, compute_noise=noise)),
                               ("plain float64", stats_f64(chunk, t, noise))):
            acc = sums[side]
            acc[0], acc[1], acc[2] = acc[0] + m, acc[1] + (sig if noise else 0), acc[2] + noise
        del chunk
    out = {}
    for side, (mean, noise, n) in sums.items():
        std = (noise / n).reshape(d1, d2).double().cpu().numpy()
        out[side] = cells_module().image_errors(mean.reshape(d1, d2).double().cpu().numpy(), std,
                                                ref["mean_img"], ref["var_img"])
    return out


def phase_full_width() -> dict:
    """Phase 15: bench.py's configuration at full width (512 x 512 x 2048,
    ``tests/torch_parity_full.py``) on the card against the JAX package's
    committed result, in ``FULL_RUNS``. Every run is reported before the
    phase fails on any miss. Returns the launch counts of the phase's runs
    and read-backs (counted from 0)."""
    import tracemalloc

    import torch

    from localmd_tpu_torch.ops import kernels

    full = full_module()
    records, prune, refs = full_fixtures()
    log(f"phase 15 the card against the JAX package at full width: {full.SHAPE} blocks "
        f"{full.BLOCKS} {full.OPTIONS}, fixtures {os.path.relpath(FULL_DIR, HERE)}")
    t_phase = time.perf_counter()
    movies = {}
    tracemalloc.start()
    t0 = time.perf_counter()
    movies["full_512_f32"] = full.movie("full_512_f32")
    made = dict(full_512_f32=(time.perf_counter() - t0, tracemalloc.get_traced_memory()[1]))
    tracemalloc.reset_peak()
    t0 = time.perf_counter()
    u16 = np.empty(full.SHAPE, np.uint16)
    for lo in range(0, full.SHAPE[0], 256):
        u16[lo:lo + 256] = full.convert("uint16", movies["full_512_f32"][lo:lo + 256])
    movies["full_512_u16"] = u16
    made["full_512_u16"] = (time.perf_counter() - t0, tracemalloc.get_traced_memory()[1])
    tracemalloc.stop()
    for name, (secs, peak) in made.items():
        log(f"  {name}: made in {secs:.2f} s on the host, traced host peak {peak / 2**30:.3f} GiB")
    # where the card's var_img and s_0 gap to the JAX package comes from:
    # K1 against its plain twin in float64 on the same chunks (not counted)
    attribution = k1_attribution(movies["full_512_f32"], refs["full_512_f32"])
    log("  full_512_f32 statistics against JAX's: " + "; ".join(
        f"{side} mean {e['mean']:.3e}, var {e['var']:.3e}" for side, e in attribution.items()))
    misses, ties, prints = [], [], {}
    kernels.reset_launch_counts()
    for name, routes_setting in FULL_RUNS:
        label = f"{name} routes {routes_setting}"
        before = kernels.launch_counts()
        result = full_width_check(name, routes_setting, "cuda", movies[name], records[name],
                                  prune, refs[name])
        prints[name, routes_setting] = result["runs"][-1]["fingerprint"]
        launched = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        log(f"  {label}: launches {launched}")
        want = dict(coset_stage=False, banded_gram=False, cell_vproj=False)
        if routes_setting == "auto":
            want = expected_routes(*full.SHAPE[1:], full.BLOCKS)
            check(all(want.values()), f"full width {label}: expected every route, {want}")
        for run in result["runs"]:
            check_path(f"full width {label} ({run['attempt']})", launched, run["routes"], want,
                       kernels_run=("movie_stats", "block_reconstruct", "jacobi_eigh"))
        ties += [f"{label}: block {f['block']} component {f['component']}" for f in result["ties"]]
        if result["misses"]:
            misses.append(f"{label}: {', '.join(result['misses'])}")
        torch.cuda.empty_cache()
    del movies, u16
    # how far the card's own two forms of one computation lie apart: the
    # scale of the fp32 rounding the reduction to the pruned rank amplifies
    apart = full.fingerprint_errors(prints["full_512_f32", "auto"], prints["full_512_f32", False])
    log(f"  full_512_f32 routes auto against routes off on the card: fingerprint psi_y "
        f"{apart['psi_y']:.3e}, y_omega {apart['y_omega']:.3e}")
    launches = kernels.launch_counts()
    log(f"  phase 15: {time.perf_counter() - t_phase:.2f} s for {len(FULL_RUNS)} cases; "
        f"launches {launches}; fp32 ties given the JAX package's decision: {ties or 'none'}")
    check(not misses, "phase 15: " + "; ".join(misses))
    return launches


# ---------------------------------------------------------------------------
# phase 16: the card against the JAX package on the other timed cells
# ---------------------------------------------------------------------------

CELLS_DIR = os.path.join(HERE, "tests", "golden", "torch_parity_cells")
# the cells phase 16 holds at full width with the routes at "auto", as
# users run them; ``--cells`` names others. OPEN_CELLS miss phase 15's bars
# (the fingerprint and ``s`` past 1e-4 of the JAX package's, which moves
# by more than 1e-4 itself when its sketches move one float32 ulp): they
# stay out of the default run until that gap is settled (ROADMAP Queue 3)
CELL_RUNS = ("1024_u16",)
OPEN_CELLS = ("voltage_f32", "northstar_u16")
# a run, then up to two more with the JAX package's decision at the fp32
# ties found (a tie in one window can hide one in a later window)
CELL_ATTEMPTS = 3


def cells_module():
    """``tests/torch_parity_cells.py``: numpy only, the timed cells."""
    parity_module()
    import torch_parity_cells

    return torch_parity_cells


def cell_fixtures():
    """The JAX package's committed results on the cells: (cases.json,
    {case: its arrays})."""
    with open(os.path.join(CELLS_DIR, "cases.json")) as f:
        records = json.load(f)
    refs = {name: dict(np.load(os.path.join(CELLS_DIR, f"{name}.npz"))) for name in records}
    return records, refs


def card_fingerprint(pmd, probe: dict, chunk: int) -> dict:
    """``torch_parity_full.fingerprint`` of ``pmd`` on its own device in
    float64: ``reconstruct_frames`` (K3) ``chunk`` frames at a time, each
    chunk through the probes there; the probes are the host's, copied."""
    import torch

    full = full_module()
    t, d1, d2 = (int(x) for x in pmd.shape)
    dev = psi = omega = phi = psi_y = y_omega = None
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        y = pmd.reconstruct_frames(np.arange(lo, hi))
        if dev is None:
            dev = y.device
            psi, omega = (torch.as_tensor(probe[k], device=dev) for k in ("psi", "omega"))
            phi = torch.as_tensor(probe["phi"], device=dev) if "phi" in probe else None
            psi_y = torch.zeros((full.PROBES, full.PHI_COLUMNS if phi is not None else t),
                                dtype=torch.float64, device=dev)
            y_omega = torch.zeros(d1 * d2, dtype=torch.float64, device=dev)
        y = y.reshape(hi - lo, d1 * d2).to(torch.float64)
        py = (y @ psi).T
        if phi is not None:
            psi_y += py @ phi[lo:hi]
        else:
            psi_y[:, lo:hi] = py
        y_omega += omega[lo:hi] @ y
        del y, py
    key = "psi_y_phi" if phi is not None else "psi_y"
    return {key: psi_y.cpu().numpy(), "y_omega": y_omega.cpu().numpy()[full.pixel_sample(d1 * d2)]}


def cell_arrays(pmd, probe: dict) -> dict:
    """The port's result as the fixture holds the JAX package's: ``s``,
    the images at the stored pixels and through psi, and the fingerprint
    (``card_fingerprint``)."""
    cells = cells_module()
    mean, var = np.asarray(pmd.mean_img, np.float32), np.asarray(pmd.var_img, np.float32)
    sample = cells.pixel_sample(mean.size)
    return dict(card_fingerprint(pmd, probe, cells.FINGERPRINT_CHUNK), s=np.asarray(pmd.s),
                mean_img=mean.ravel()[sample], var_img=var.ravel()[sample],
                image_probe=cells.image_probe(mean, var, probe["psi"]))


def window_flips(port_stats, jax_stats, thresholds, port_counts, jax_counts) -> list:
    """``block_flips`` window by window: for each block, the first window
    after which its kept count differs from the JAX package's (``*_counts``
    are (windows, blocks), the counts after each window), with that
    window's statistics; each entry also names its ``window``."""
    flips = []
    same_before = np.ones(np.shape(port_counts)[1], bool)
    for w, (pc, jc) in enumerate(zip(port_counts, jax_counts)):
        first = (pc != jc) & same_before
        for flip in block_flips((port_stats[0][w], port_stats[1][w]),
                                (jax_stats[0][w], jax_stats[1][w]), thresholds,
                                np.where(first, pc, 0), np.where(first, jc, 0)):
            flips.append(dict(flip, window=w))
        same_before &= pc == jc
    return flips


@contextlib.contextmanager
def eigen_cut_spy():
    """Within the block, ``values["vals"]``: the eigenvalues of the last
    factorized SVD's Gram (``factorization.compute_lowrank_factorized_svd``),
    whose directions at or below ``torch_parity_cells.GRAM_CUT`` of the
    largest are dropped."""
    from localmd_tpu_torch import factorization

    values = {}
    real = factorization.subspace_eigh, factorization.eigh_descending

    def spy(fn):
        def run(*args, **kwargs):
            vals, vecs = fn(*args, **kwargs)
            values["vals"] = vals.cpu().numpy()
            return vals, vecs
        return run

    factorization.subspace_eigh, factorization.eigh_descending = (spy(fn) for fn in real)
    try:
        yield values
    finally:
        factorization.subspace_eigh, factorization.eigh_descending = real


def eigen_cut(vals) -> tuple:
    """(directions kept, the relative distance from the cut of the
    eigenvalue nearest it) of a factorized SVD's Gram eigenvalues."""
    cells = cells_module()
    vals = np.asarray(vals, np.float64)
    cut = max(vals[0], 0.0) * cells.GRAM_CUT
    return cells.gram_kept(vals), (float(np.min(np.abs(vals - cut)) / cut) if cut > 0
                                   else float("inf"))


def gram_flip(port_vals, jax_vals):
    """None where the port's factorized SVD keeps as many Gram directions
    as the JAX package's; else the directions decided differently and each
    package's eigenvalues there over its own cut (None past either's
    length). A report: the kept rank's bar judges it."""
    pv, jv = (np.asarray(v, np.float64) for v in (port_vals, jax_vals))
    (pn, _), (jn, _) = eigen_cut(pv), eigen_cut(jv)
    if pn == jn:
        return None
    idx = np.arange(min(pn, jn), max(pn, jn))
    flip = dict(port_kept=pn, jax_kept=jn, indices=idx, port_ratio=None, jax_ratio=None)
    if idx[-1] < min(len(pv), len(jv)):
        cut = cells_module().GRAM_CUT
        flip.update(port_ratio=pv[idx] / (pv[0] * cut), jax_ratio=jv[idx] / (jv[0] * cut))
    return flip


def describe_gram_flip(flip: dict, n_vals: int) -> str:
    line = (f"factorized SVD: the port keeps {flip['port_kept']} of {n_vals} Gram directions past "
            f"its cut, JAX {flip['jax_kept']}")
    if flip["port_ratio"] is None:
        return line
    return line + "; eigenvalues over the cut at the directions decided differently " + ", ".join(
        f"{i}: {p:.5f} (JAX {j:.5f})"
        for i, p, j in zip(flip["indices"], flip["port_ratio"], flip["jax_ratio"]))


def cell_check(name: str, device: str, source, record: dict, ref: dict) -> dict:
    """One cell held to the JAX package's stored result at phase 15's bars
    (``full_width_misses``, with the images also through psi), on the card
    or on the CPU, with the routes as they are. Where a block's count
    after some window differs, the first such window's flips are reported;
    if every one is an fp32 tie (``block_flips``), the run is made again
    with the JAX package's decision at each (window, block, component)
    found so far, up to ``CELL_ATTEMPTS`` runs; the last is held to every
    bar. Where the factorized SVD keeps another number of Gram directions
    than the JAX package's, the directions decided differently are
    reported. Returns ``misses`` (empty when the bars are met), ``ties``
    and each run's numbers and arrays (``cell_arrays``)."""
    from localmd_tpu_torch.ops.tiling import block_grid

    cells = cells_module()
    case = cells.CELL_CASES[name]
    (t, d1, d2), blocks = case["shape"], case["blocks"]
    opts = cells.options(name)
    n_windows, thresholds = cells.n_windows(name), record["thresholds"]
    probe = cells.probes(case["shape"])
    samples = [dict(record["spread"], rank=record["spread_rank"]), *record.get("spread_samples", ())]
    log(f"  {name}: the JAX package against itself, every sketch one float32 ulp up on half its "
        f"entries, {len(samples)} nudge seed(s) (a measurement, not a bar): " + ", ".join(
            f"{k} {min(x[k] for x in samples):.3e} to {max(x[k] for x in samples):.3e}"
            for k in ("psi_y", "y_omega", "s")) + f", kept {sorted({x['rank'] for x in samples})}")
    jax_stats = ref["block_spatial"], ref["block_temporal"]
    result = dict(runs=[], ties=[], misses=[])
    order, overrides = None, {}
    for attempt in range(CELL_ATTEMPTS):
        label = "run" if attempt == 0 else f"ties injected ({len(overrides)} decisions)"
        reset_route_calls()
        with singular_spy() as singular, block_spy(order, overrides) as spied, \
                eigen_cut_spy() as eig:
            t0 = time.perf_counter()
            pmd = pinned_run(source, blocks, device, thresholds, cells.sketch, **opts)
            secs = time.perf_counter() - t0
        routes = dict(ROUTE_CALLS)
        t0 = time.perf_counter()
        arrays = cell_arrays(pmd, probe)
        err = cells.errors(arrays, ref)
        run = dict(attempt=label, secs=secs, read_secs=time.perf_counter() - t0, err=err,
                   arrays=arrays,
                   ranks=dict(pmd.pipeline_ranks), rank=int(pmd.rank), routes=routes,
                   margin=cut_margin(singular["s"], singular["tol"]), forced=spied["forced"],
                   eigen_cut=eigen_cut(eig["vals"]))
        del pmd
        result["runs"].append(run)
        missed = full_width_misses(err, run["ranks"], run["rank"], record)
        log(f"  {name} ({label}): {secs:.2f} s the call, {run['read_secs']:.2f} s the "
            f"fingerprint (K3 over {t} frames, float64 on {device}); fingerprint psi_y "
            f"{err['psi_y']:.3e}, y_omega {err['y_omega']:.3e}; s {err['s']:.3e}; mean "
            f"{err['mean']:.2e}, var {err['var']:.2e} (at {len(ref['mean_img'])} pixels), "
            f"through psi {err['mean_probe']:.2e} / {err['var_probe']:.2e}; ranks {run['ranks']} "
            f"kept {run['rank']} (JAX {record['pipeline_ranks']} kept {record['rank']}); kept-rank "
            f"cut margin {run['margin']:.3e}; factorized SVD {run['eigen_cut'][0]} of "
            f"{len(eig['vals'])} Gram directions past its cut, the nearest {run['eigen_cut'][1]:.3e} "
            f"of it away; routes {routes}"
            + (f"; decisions replaced {spied['forced']}" if attempt else "")
            + (f"; misses {missed}" if missed else ""))
        log(f"    {s_by_index(arrays['s'], ref['s'])}")
        order = block_order(routes["coset_stage"] > 0, case["shape"], blocks)
        stats = window_stats(spied, order, n_windows)
        counts = (None if stats is None
                  else cells.window_counts(*stats, thresholds, opts["max_components"]))
        if stats is not None:
            for w in range(n_windows):
                diff = [np.median(np.abs(p[w] - j[w]) / np.abs(j[w])) for p, j in zip(stats, jax_stats)]
                near = min(float(np.min(np.abs(p[w] - thr) / thr)) for p, thr in zip(stats, thresholds))
                log(f"    window {w} block statistics against JAX's: median relative difference "
                    f"{diff[0]:.2e} (spatial), {diff[1]:.2e} (temporal); the port's nearest to a "
                    f"threshold {near:.2e} of it; kept {int(counts[w].sum())} after it (JAX "
                    f"{int(ref['window_counts'][w].sum())})")
        gflip = gram_flip(eig["vals"], ref["gram_vals"])
        if gflip is not None:
            log(f"    {describe_gram_flip(gflip, len(eig['vals']))}")
        if attempt and spied["forced"] != len(overrides):
            missed.append(f"{spied['forced']} of {len(overrides)} tie decisions replaced")
        if np.array_equal(spied["counts"], ref["block_counts"]) and (
                counts is None or np.array_equal(counts, ref["window_counts"])):
            result["misses"] = missed
            break
        if counts is None or not np.array_equal(counts[-1], spied["counts"]):
            result["misses"] = missed + ["the port's block statistics were not captured"]
            break
        flips = window_flips(stats, jax_stats, thresholds, counts, ref["window_counts"])
        starts = block_grid(d1, d2, blocks).starts
        for flip in flips:
            log(f"    {describe_flip(flip, starts)}")
        if not flips or not all(flip["tie"] for flip in flips):
            result["misses"] = missed + ["blockwise ranks past an fp32 tie"]
            break
        result["ties"] += [dict(f, what=f"window {f['window']} block {f['block']} component "
                                         f"{f['component']}") for f in flips]
        overrides.update({(f["window"], f["block"], f["component"]): f["jax_keeps"] for f in flips})
        result["misses"] = missed + [f"ties remain after {CELL_ATTEMPTS} runs"]
    return result


def page_cache_share(path: str):
    """The share of ``path``'s pages in the page cache (``mincore`` on a
    private mapping), or None where that cannot be read."""
    import ctypes
    import mmap

    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
        try:
            n = -(-size // mmap.PAGESIZE)
            vec = (ctypes.c_ubyte * n)()
            base = ctypes.c_char.from_buffer(mm)
            libc = ctypes.CDLL(None, use_errno=True)
            code = libc.mincore(ctypes.c_void_p(ctypes.addressof(base)), ctypes.c_size_t(size), vec)
            del base
            return None if code else float(np.mean(np.frombuffer(vec, np.uint8) & 1))
        finally:
            mm.close()
    except (OSError, ValueError, AttributeError):
        return None


def phase_cells(device: str = "cuda", names=CELL_RUNS) -> dict:
    """Phase 16: the cells ``names`` at full width (``tests/torch_parity_cells.py``)
    on ``device`` against the JAX package's committed results, the routes
    at "auto"; the north star read from a raw file. Every case is reported
    before the phase fails on any miss. Each cell then runs once more with
    the routes off (the Gram as Z^T Z, V through K2), printed against its
    first run: the scale of the port's own float32 rounding there, a
    measurement. Returns the launch counts of the phase's runs and
    read-backs (counted from 0)."""
    import torch

    from bench_torch import NATIVE_READS, count_native_reads, set_routes
    from localmd_tpu_torch.dataset import RawBinaryArray
    from localmd_tpu_torch.ops import kernels

    cells = cells_module()
    records, refs = cell_fixtures()
    count_native_reads()
    shapes = ", ".join(f"{n} {cells.CELL_CASES[n]['shape']}" for n in names)
    log(f"phase 16 the card against the JAX package on the other timed cells, full width, routes "
        f"auto: {shapes}, fixtures {os.path.relpath(CELLS_DIR, HERE)}")
    t_phase = time.perf_counter()
    misses, ties = [], []
    kernels.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cells_")
    try:
        for name in names:
            case, record = cells.CELL_CASES[name], records[name]
            (t, d1, d2), blocks = case["shape"], case["blocks"]
            mov = cells.movie(name)
            digest = cells.digest(mov)
            if digest != record["movie_digest"]:
                misses.append(f"{name}: the movie's digest {digest[:12]} is not the fixture's "
                              f"{record['movie_digest'][:12]}")
                continue
            t0 = time.perf_counter()
            if case["source"] == "raw":
                path = os.path.join(tmp, f"{name}.raw")
                built, written = mov.write(path)
                source = RawBinaryArray(path, case["shape"], case["dtype"])
                cached = page_cache_share(path)
                made = (f"made in {built:.2f} s and written in {written:.2f} s "
                        f"({os.path.getsize(path) / written / 1e9:.2f} GB/s) to a raw file, "
                        f"{'unknown' if cached is None else f'{cached:.1%}'} of its pages in the "
                        f"page cache before the call")
            else:
                source = mov.array()
                made = f"made in {time.perf_counter() - t0:.2f} s on the host ({source.nbytes / 1e9:.2f} GB)"
            log(f"  {name} {case['dtype']} {case['shape']} blocks {blocks} {cells.options(name)}: "
                f"movie {made}")
            before = kernels.launch_counts()
            NATIVE_READS.update(calls=0, bytes=0, seconds=0.0)
            result = cell_check(name, device, source, record, refs[name])
            reads = dict(NATIVE_READS)
            launched = {k: n - before[k] for k, n in kernels.launch_counts().items()}
            line = f"  {name}: launches {launched}"
            if case["source"] == "raw":
                runs = len(result["runs"])
                line += (f"; native reader {reads['bytes'] / 1e9:.2f} GB in {reads['calls']} calls "
                         f"over {runs} call(s), {reads['seconds']:.2f} s inside them "
                         f"({reads['bytes'] / max(reads['seconds'], 1e-9) / 1e9:.2f} GB/s), "
                         f"{reads['bytes'] / runs / 1e9 / result['runs'][0]['secs']:.2f} GB/s "
                         f"of the first call's wall")
            log(line)
            want = expected_routes(d1, d2, blocks, single_window=cells.n_windows(name) == 1)
            for run in result["runs"]:
                check_path(f"cell {name} ({run['attempt']})", launched, run["routes"], want,
                           kernels_run=("movie_stats", "block_reconstruct", "jacobi_eigh"))
            ties += [f"{name}: {f['what']}" for f in result["ties"]]
            if result["misses"]:
                misses.append(f"{name}: {', '.join(result['misses'])}")
            t0 = time.perf_counter()
            set_routes(False)
            try:
                pmd = pinned_run(source, blocks, device, record["thresholds"], cells.sketch,
                                 **cells.options(name))
                off, off_rank = cell_arrays(pmd, cells.probes(case["shape"])), int(pmd.rank)
                del pmd
            finally:
                set_routes("auto")
            first = result["runs"][0]
            apart = cells.errors(off, first["arrays"], s_prefix=True)
            log(f"  {name} routes off against its first run, on {device} "
                f"({time.perf_counter() - t0:.2f} s, a measurement): fingerprint psi_y "
                f"{apart['psi_y']:.3e}, y_omega {apart['y_omega']:.3e}; s {apart['s']:.3e} (over "
                f"the shorter); kept {off_rank} and {first['rank']}")
            del source, mov
            if case["source"] == "raw":
                os.remove(path)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = kernels.launch_counts()
    log(f"  phase 16: {time.perf_counter() - t_phase:.2f} s for {len(names)} cells; launches "
        f"{launches}; fp32 ties given the JAX package's decision: {ties or 'none'}")
    check(not misses, "phase 16: " + "; ".join(misses))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--frames", type=int, default=None,
                    help="T of phase 8's movie (default 30000, cut to the free disk)")
    ap.add_argument("--mesh-rank", nargs=5, default=None,
                    metavar=("WORLD", "RANK", "PORT", "BACKEND", "OUT_DIR"),
                    help="run one rank of phase 10 (started by phase 10 itself)")
    ap.add_argument("--cold-call", nargs=8, default=None,
                    metavar=("CELL", "OUT", "SPAWN_TIME", "RAW", "FRAMES", "SAVE_RECON",
                             "AOT_WARM", "PROFILED"),
                    help="run one process of phase 11 (started by phase 11 itself)")
    ap.add_argument("--cells", default=",".join(CELL_RUNS),
                    help=f"comma-separated cells of phase 16 (default: {','.join(CELL_RUNS)}; "
                         f"{', '.join(OPEN_CELLS)} miss its bars, ROADMAP Queue 3)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    cell_names = tuple(args.cells.split(","))
    if not set(cell_names) <= set(CELL_RUNS + OPEN_CELLS):
        ap.error(f"--cells {args.cells}: the cells are {', '.join(CELL_RUNS + OPEN_CELLS)}")

    import torch

    # phase 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.mesh_rank:
        world, rank, port, backend, out_dir = args.mesh_rank
        return mesh_rank(int(world), int(rank), int(port), backend, out_dir)
    if args.cold_call:
        cell, out, spawn, raw, frames, save, aot, profiled = args.cold_call
        return cold_call(cell, out, float(spawn), raw, int(frames), bool(int(save)),
                         json.loads(aot), bool(int(profiled)))
    from bench_torch import card_line, make_movie
    from localmd_tpu_torch import config
    from localmd_tpu_torch.ops import _build, kernels

    config.apply()
    install_route_spies()
    card = card_line()
    log(f"phase 0 device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # phase 1
    t0 = time.perf_counter()
    _build.library()
    path = _build.last_build["path"]
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({path}, "
        f"nvcc {_build.last_build.get('seconds', 0.0):.2f} s; per source, in parallel: "
        + ", ".join(f"{name} {secs:.2f} s"
                    for name, secs in _build.last_build.get("source_seconds", {}).items()) + ")")
    for line in _build.last_build.get("log", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
            log(f"  ptxas: {line.strip()}")

    results: dict = {}
    if 2 in phases:
        log("phase 2 kernels vs plain")
        phase_kernels(results)
        phase_kernel_dtypes(results)
    launches = None
    if 3 in phases:
        log("phase 3 golden on the card")
        launches_3 = phase_golden()
    if 4 in phases:
        # bench.make_movie's white factors look like noise to PMD's roughness
        # test (the JAX package ends at final rank 150-154 on this movie,
        # BENCH_r0*.json), so this leg checks shape, ranks and finite values;
        # phase 6 checks denoising
        log("phase 4 main path 512x512x2048 float32 (bench.make_movie): routes auto, then off")
        movie, clean_fn = make_movie("float32")
        kernels.reset_launch_counts()
        reset_route_calls()
        pmd, *side_on = run_side(movie, 4, "f32")
        check_recon(pmd, movie, clean_fn, "f32", denoised=False)
        launches = kernels.launch_counts()
        log(f"  launches on the main path: {launches}; routes run {ROUTE_CALLS}")
        check_path("main path", launches, ROUTE_CALLS, expected_routes(512, 512),
                   kernels_run=("movie_stats", "block_reconstruct", "jacobi_eigh"))
        routes_ab(movie, "f32", pmd, side_on)
        del pmd, movie
        torch.cuda.empty_cache()
        if 3 in phases:
            launches = add_launches(launches, launches_3)
    if 5 in phases:
        # K2 reads uint16 natively only where the cell route does not run:
        # bench.py's second leg (blocks 40 on 1024^2, a snapped tail) keeps it
        for (d1, d2, t), settings in (((512, 512, 2048), {}),
                                      ((1024, 1024, 4096), dict(blocks=(40, 40), frame_range=512))):
            label = f"u16 {d1}x{d2}x{t}"
            log(f"phase 5 main path {d1}x{d2}x{t} uint16 (bench.make_movie) {settings}")
            movie, clean_fn = make_movie("uint16", d1, d2, t)
            kernels.reset_launch_counts()
            reset_route_calls()
            pmd = run_main(movie, 1, label, **settings)
            check_recon(pmd, movie, clean_fn, label, denoised=False)
            after = kernels.launch_counts()
            log(f"  launches {after}; routes run {ROUTE_CALLS}")
            check_path(label, after, ROUTE_CALLS,
                       expected_routes(d1, d2, settings.get("blocks", (32, 32))),
                       kernels_run=("movie_stats", "block_reconstruct", "jacobi_eigh"))
            if launches is not None:
                launches = add_launches(launches, after)
            del pmd, movie
            torch.cuda.empty_cache()
    if 6 in phases:
        log("phase 6 denoising 512x512x2048, smoothed factors")
        for dtype, label in (("float32", "smooth f32"), ("uint16", "smooth u16")):
            movie, clean_fn = make_movie(dtype, smooth=True)
            pmd = run_main(movie, 1, label)
            check_recon(pmd, movie, clean_fn, label, denoised=True)
            del pmd, movie
            torch.cuda.empty_cache()
    if 7 in phases:
        launches_7 = phase_voltage()
        if launches is not None:
            launches = {name: launches[name] + launches_7[name] for name in launches}
    # phase 8's raw file stays until phases 11 and 12 have run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_northstar_") if phases & {8, 11, 13} else None
    try:
        raw, cached, u16_ref, cli_npz = None, None, None, None
        if 8 in phases:
            launches_8, (path, t, cached), u16_ref, cli_npz = phase_from_disk(tmp, args.frames)
            raw = (path, t)
            log(f"  launches from disk (phase 8): {launches_8}")
            # K2's launches follow the V route (check_stream_launches)
            for name in ("movie_stats", "block_reconstruct", "jacobi_eigh"):
                check(launches_8[name] > 0, f"the from-disk path never launched {name}")
            if launches is not None:
                launches = {name: launches[name] + launches_8[name] for name in launches}
        if 9 in phases:
            launches_9 = phase_options()
            log(f"  launches of phase 9: {launches_9}")
            for name in ("movie_stats", "block_reconstruct", "jacobi_eigh"):
                check(launches_9[name] > 0, f"phase 9 never launched {name}")
            if launches is not None:
                launches = add_launches(launches, launches_9)
        if 10 in phases:
            launches_10 = phase_mesh()
            log(f"  launches of phase 10 (every rank's warm run and read-back): {launches_10}")
            if launches is not None:
                launches = add_launches(launches, launches_10)
        if 11 in phases:
            if raw is None:
                log("phase 11 without phase 8: writing the north star's raw file")
                path, t, movie = write_northstar(tmp, args.frames)
                del movie
                raw = (path, t)
            launches_11 = phase_cold(tmp, raw, cached)
            log(f"  launches of phase 11 (the cold calls and their read-back): {launches_11}")
            for name in ("movie_stats", "block_reconstruct", "jacobi_eigh"):
                check(launches_11[name] > 0, f"phase 11 never launched {name}")
            if launches is not None:
                launches = add_launches(launches, launches_11)
        if 12 in phases:
            check(u16_ref is not None, "phase 12 compares with phase 8's runs: run it with phase 8")
            launches_12 = phase_dtypes(raw, u16_ref)
            log(f"  launches of phase 12: {launches_12}")
            for name in KERNELS:
                check(launches_12[name] > 0, f"phase 12 never launched {name}")
            if launches is not None:
                launches = add_launches(launches, launches_12)
        if 13 in phases:
            launches_13 = phase_demo_and_grid_cache(tmp, cli_npz)
            log(f"  launches of phase 13 (the demo's steps and the grid-cache calls): "
                f"{launches_13}")
            for name in ("movie_stats", "block_reconstruct", "jacobi_eigh"):
                check(launches_13[name] > 0, f"phase 13 never launched {name}")
            if launches is not None:
                launches = add_launches(launches, launches_13)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if 14 in phases:
        launches_14 = phase_parity()
        if launches is not None:
            launches = add_launches(launches, launches_14)
    if 15 in phases:
        launches_15 = phase_full_width()
        if launches is not None:
            launches = add_launches(launches, launches_15)
    if 16 in phases:
        launches_16 = phase_cells(names=cell_names)
        if launches is not None:
            launches = add_launches(launches, launches_16)

    if phases != set(ALL_PHASES):
        log(f"partial run (phases {sorted(phases)}): no result line")
        return 0
    # K2 runs where the cell route does not: the golden grid and 1024^2
    for name, n in launches.items():
        check(n > 0, f"the counted runs never launched {name}")
    log(card)
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name], **results[name])
        for name in KERNELS
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
