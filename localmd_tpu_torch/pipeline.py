"""End-to-end PMD pipeline on one device: ``localmd_decomposition``
(counterpart of localmd_tpu/pipeline.py).

  stats (K1, filling the device movie cache) -> background rSVD
  -> frame sampling -> threshold Monte-Carlo
  -> standardize + background-filter the init frames
  -> batched block decomposition over the whole patch grid: one init
     window, or (``window_chunks`` below the init length) the multi-window
     loop of ``engine.windowed_pmd_batched``
  -> pyramid-weighted overlap normalization (blocked-sparse U)
  -> factorized SVD (only_left) -> streamed V regression (K2)
  -> final SVD reformat -> PMDArray (frames through K3).

The JAX package's accelerator routes run on the card as it runs them off
the CPU, each behind its module flag ("auto": on for the card, off on the
CPU; True or False force it): ``engine.COSET_STAGE``, the gather-free
block stage for one window, no mesh, identity denoisers and no checkpoint
when its transients fit; ``blocksparse.BANDED_GRAM``, the block-banded
Gram of the factorized SVD; ``blocksparse.COSET_VPROJ``, the V regression's
cell route in place of K2. The last two need a regular grid
(``BlockGrid.cell_geometry``); every other input takes the gather and
canvas forms the CPU runs.

The movie may be in memory, a tensor or a file (``dataset.as_dataset``);
files stream through the loader's pinned ring. With ``checkpoint_path``
each stage -- ``stats``, ``background``, ``thresholds``, ``blocks`` (and its
per-batch ``blocks.part*``), ``projector``, ``v`` -- persists its outputs
and a rerun with the same configuration resumes after the last one
(``checkpoint.PipelineCheckpoint``); the denoisers are part of that
fingerprint by their content (``_fn_token``). The device is explicit:
``device="cuda"`` (the default) raises when CUDA is absent.

With ``mesh`` (``parallel.make_mesh()``: one rank per device, every rank
making the same call) the block batches are split over the ranks and, with
more than one rank, the statistics pass and the V regression are striped
over them; every rank returns the same ``PMDArray`` (``parallel.multihost``
sets out the stages).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
import time
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from localmd_tpu_torch import config
from localmd_tpu_torch.aot import normalized_init_geometry
from localmd_tpu_torch.blocksparse import BlockSparseMatrix, coset_vproj_eligible
from localmd_tpu_torch.checkpoint import PipelineCheckpoint
from localmd_tpu_torch.dataset import as_dataset
from localmd_tpu_torch.engine import (
    coset_stage_eligible,
    coset_stage_plan,
    coset_stage_transient_bytes,
    effective_window_length,
    identity,
    threshold_heuristic,
    window0_chunk_step,
    window0_coset_stage,
    window_count,
    windowed_pmd_batched,
)
from localmd_tpu_torch.factorization import (
    compute_lowrank_factorized_svd,
    final_svd_reformat,
    gram_is_banded,
)
from localmd_tpu_torch.loader import PMDLoader
from localmd_tpu_torch.ops.linalg import DEFAULT_OVERSAMPLES
from localmd_tpu_torch.ops.tiling import block_grid, check_fov_size, extract_patches
from localmd_tpu_torch.parallel.mesh import pad_to_multiple
from localmd_tpu_torch.parallel.multihost import (
    agree_int_min,
    validate_multihost_mesh,
    world_and_rank,
)
from localmd_tpu_torch.parallel.sharded import sharded_window0_chunk_step
from localmd_tpu_torch.pmd_array import PMDArray
from localmd_tpu_torch.utils import (
    block_batch_budget,
    device_free_bytes,
    display,
    make_generator,
    normal,
    stage_seeds,
)
from localmd_tpu_torch.utils.device import TRANSIENT_FLOOR_BYTES
from localmd_tpu_torch.utils.logging import DeviceSpans, span

# the stages of ``pipeline_timings``, in the order they run; each is also a
# ``localmd.<stage>`` span from the previous stage's fence to its own
STAGES = ("stats_and_background", "thresholds", "block_decomposition", "factorized_svd",
          "v_regression", "final_reformat")


def identify_window_chunks(
    frame_range: int, total_frames: int, window_chunks: int, np_rng=None
) -> list:
    """Sample non-overlapping contiguous chunks of frames for initialization
    (pipeline.py:50-77)."""
    if frame_range > total_frames:
        raise ValueError("Requested more frames than available")
    if window_chunks > frame_range:
        raise ValueError("The size of each temporal chunk is bigger than frame range")
    num_intervals = math.ceil(frame_range / window_chunks)
    available = np.arange(0, total_frames, window_chunks)
    if available[-1] > total_frames - window_chunks:
        available[-1] = total_frames - window_chunks
    if np_rng is None:
        np_rng = np.random
    starts = np.sort(np_rng.choice(available, size=num_intervals, replace=False))
    display(f"sampled from the following regions: {starts}")
    net_frames: list = []
    for k in starts:
        net_frames.extend(range(int(k), int(min(k + window_chunks, total_frames))))
    return net_frames


def _value_token(v, depth: int = 0) -> bytes:
    """Content bytes of a value captured by a denoiser, for the checkpoint
    fingerprint (pipeline.py:80-114). ``repr`` would truncate large arrays
    and embed per-process addresses; a tensor is hashed by its bytes on the
    host."""
    if depth > 3:
        return b"<deep>"
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return repr(v).encode()
    if isinstance(v, np.generic):
        return b"ns" + str(v.dtype).encode() + v.tobytes()
    if isinstance(v, np.ndarray):
        return b"nd" + str(v.shape).encode() + str(v.dtype).encode() + v.tobytes()
    if isinstance(v, torch.Tensor):
        host = v.detach().cpu().contiguous()
        return (b"tt" + str(tuple(host.shape)).encode() + str(host.dtype).encode()
                + host.reshape(-1).view(torch.uint8).numpy().tobytes())
    if isinstance(v, (tuple, list)):
        return b"[" + b",".join(_value_token(x, depth + 1) for x in v) + b"]"
    if isinstance(v, dict):
        return b"{" + b",".join(
            _value_token(k, depth + 1) + b":" + _value_token(x, depth + 1)
            for k, x in sorted(v.items(), key=lambda kv: repr(kv[0]))
        ) + b"}"
    code = getattr(v, "__code__", None)
    if code is not None:  # a captured function: its content, not its id
        token = code.co_code + repr(code.co_consts).encode()
        defaults = getattr(v, "__defaults__", None)
        if defaults:
            token += _value_token(tuple(defaults), depth + 1)
        return token
    # any other object: its type alone (stable across processes)
    return repr(type(v)).encode()


def _fn_token(fn) -> Optional[str]:
    """Fingerprint token of a denoiser (pipeline.py:117-136): its qualified
    name and a hash of its bytecode, constants, defaults and closure
    values, so a changed body, constant, default or captured value (a
    tensor included) invalidates the resumable stages."""
    if fn is None:
        return None
    name = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"
    code = getattr(fn, "__code__", None)
    if code is not None:
        payload = code.co_code + repr(code.co_consts).encode()
        defaults = getattr(fn, "__defaults__", None)
        if defaults:
            payload += _value_token(tuple(defaults))
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                payload += _value_token(cell.cell_contents)
            except ValueError:  # an empty cell
                payload += b"<empty>"
        name += ":" + hashlib.sha256(payload).hexdigest()[:12]
    return name


@contextlib.contextmanager
def _profile_scope(profile_dir: Optional[str], dev: torch.device):
    """With ``profile_dir``, profile the body with ``torch.profiler`` (CPU
    activity, and CUDA activity on the card) and write a Chrome trace into
    the directory, made if missing (pipeline.py:209-212 writes a jax
    profiler trace). Every thread is traced (``profile_all_threads``), so
    the loader's prefetch workers' spans are in the trace beside the
    caller's."""
    if profile_dir is None:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    from torch._C._profiler import _ExperimentalConfig

    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"localmd_decomposition.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    ))


def localmd_decomposition(
    dataset_obj,
    block_sizes: Tuple[int, int],
    frame_range: int,
    max_components: int = 50,
    background_rank: int = 15,
    sim_conf: float = 5,
    frame_batch_size: int = 10000,
    dtype: str = "float32",
    num_workers: int = 0,
    pixel_batch_size: int = 5000,
    max_consecutive_failures: int = 1,
    rank_prune: bool = False,
    rank_prune_factor: float = 0.33,
    temporal_avg_factor: int = 10,
    spatial_avg_factor: int = 2,
    order: str = "F",
    window_chunks: Optional[int] = None,
    compute_normalizer: bool = True,
    pixel_weighting: Optional[np.ndarray] = None,
    spatial_denoiser: Optional[Callable] = None,
    temporal_denoiser: Optional[Callable] = None,
    seed: Optional[int] = None,
    block_batch_size: int = 256,
    sim_iters: int = 250,
    final_rank_tol: float = 1e-3,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    matmul_precision: Optional[str] = None,
    profile_dir: Optional[str] = None,
    welch_compat: str = "scipy",
    cache_movie="auto",
    aot_warm="auto",
    device="cuda",
) -> PMDArray:
    """Run the PMD compression/denoising pipeline on ``device``.

    The signature is the JAX package's (pipeline.py:139-172) plus
    ``device``. ``dataset_obj`` is an array, a tensor, a path (.tif/.tiff/
    .npy) or a dataset object. ``num_workers`` sets the prefetch depth and
    the dataset's read threads: the native reader's, or the copy threads of
    an in-memory array's reads; ``cache_movie`` ("auto", True or False)
    the device movie cache; ``checkpoint_path`` stage checkpoints.
    ``dtype`` and ``pixel_batch_size`` go to ``PMDLoader`` as in the JAX
    package (pipeline.py:503-509): ``dtype`` is the dtype of the loader's
    temporal crops, which the pipeline does not read, and
    ``pixel_batch_size`` has no effect.

    ``mesh`` (``parallel.make_mesh()``, a 1-D ``DeviceMesh`` over every
    rank of a ``torch.distributed`` job) splits each block batch over the
    ranks; with more than one rank each rank also streams its own stripe
    of the movie in the statistics pass and the V regression, the cache is
    off, ``checkpoint_path`` raises and a device OOM is not retried (one
    rank retrying alone would leave the others waiting). A job of more
    than one rank must pass a mesh, and every rank gets the same result.

    ``spatial_denoiser`` / ``temporal_denoiser`` (None: ``engine.identity``)
    are written for one block -- (r, b1, b2) component images and (r, t)
    coarse traces, each returned in the same shape -- and mapped over the
    block axis with ``torch.func.vmap`` (see ``engine``: pure torch
    operations, no ``.item()``, no in-place write to the input). A spatial
    denoiser other than ``identity`` replaces CholeskyQR2 with the Gram SVD
    in the block stage, as in the JAX package.

    ``matmul_precision`` ("highest", "tensorfloat32" or "high", "bfloat16"
    or "medium"; None is "highest") sets torch's fp32 matmul precision for
    the whole call and restores the caller's afterwards. Only the port's
    ``torch.matmul``-class products follow it; K1-K4 stay 3xTF32 and the
    cuSOLVER eighs stay fp32.

    ``profile_dir`` runs the call under ``torch.profiler`` and writes a
    Chrome trace there. ``aot_warm`` is accepted and changes nothing: the
    JAX package's results are the same either way (pipeline.py:203-207),
    and no stage warm made a cold call on an H100 shorter (``PERF.md``).
    Warms on threads stalled the main thread's first launches (a kernel's
    first launch loads its module, which the CUDA driver serializes across
    threads). Warms on this thread in the statistics pass's idle waits
    (the threshold Monte-Carlo, and a noise batch through the block stage)
    took the threshold stage out of the call, but the statistics pass grew
    by as much.

    The result carries ``pipeline_timings`` (seconds per stage, each stage
    fenced with ``torch.cuda.synchronize`` on the card; while the torch
    profiler runs each stage is also a ``localmd.<stage>`` span),
    ``pipeline_ranks`` (the JAX package's: ``final`` is the width of ``s``,
    the kept count is ``rank``), ``pipeline_windows`` (init windows and,
    per block batch, the windows run before the early stop) and
    ``pipeline_cache`` (the loader's keys, ``PMDLoader.pipeline_record``:
    the movie cache, the copies, the stream dtype, the passes' reads and
    waits and the V regression's counters; and ``fsvd.banded``, 1 where
    the factorized SVD's Gram took the banded form and 0 where it took the
    canvas (or was resumed); ``blocks.remainder``, the blocks the coset
    block stage left off its lattices to the gathered batches, 0 without
    the coset stage; ``blocks.batches``, the gathered batches of blocks;
    ``blocks.windows_run``, the windows run summed over the batches and
    the coset stage (one each for a single window); ``blocks.fallback``,
    the zero-component blocks the window loop re-ran through the full
    kernel, summed over its windows; while the profiler runs,
    ``blocks.residual_s``, the device seconds of the residual windows'
    ``blocks.residual`` spans), and the JAX package's
    ``pipeline_aot`` and ``pipeline_warm`` as it reports them with its
    warms off (pipeline.py:1404-1415).
    """
    dev = config.resolve_device(device)
    precision = config.torch_matmul_precision(matmul_precision)
    # fail before any streaming: a wrong mesh would otherwise surface only
    # at the first collective, after the statistics pass (pipeline.py:283-299)
    validate_multihost_mesh(mesh)
    if mesh is not None:
        if mesh.device_type != dev.type:
            raise ValueError(f"mesh is on {mesh.device_type!r} devices but device={device!r}")
        if mesh.size() > 1 and checkpoint_path is not None:
            raise ValueError(
                "checkpoint_path is not supported with a mesh of more than one rank: "
                "every rank would write the same stage files. Run with "
                "checkpoint_path=None, or checkpoint a one-rank run."
            )
    with config.matmul_precision_scope(precision), _profile_scope(profile_dir, dev), \
            contextlib.ExitStack() as stage_span:
        return _decompose(
            dataset_obj, block_sizes, frame_range, max_components, background_rank, sim_conf,
            frame_batch_size, dtype, num_workers, pixel_batch_size, max_consecutive_failures,
            rank_prune, rank_prune_factor, temporal_avg_factor, spatial_avg_factor, order,
            window_chunks, compute_normalizer, pixel_weighting, spatial_denoiser,
            temporal_denoiser, seed, block_batch_size, sim_iters, final_rank_tol,
            checkpoint_path, welch_compat, cache_movie, mesh, dev, stage_span,
        )


def _decompose(
    dataset_obj, block_sizes, frame_range, max_components, background_rank, sim_conf,
    frame_batch_size, dtype, num_workers, pixel_batch_size, max_consecutive_failures, rank_prune,
    rank_prune_factor, temporal_avg_factor, spatial_avg_factor, order, window_chunks,
    compute_normalizer, pixel_weighting, spatial_denoiser, temporal_denoiser, seed,
    block_batch_size, sim_iters, final_rank_tol, checkpoint_path, welch_compat, cache_movie,
    mesh, dev: torch.device, stage_span: contextlib.ExitStack,
) -> PMDArray:
    """The body of ``localmd_decomposition`` on the resolved device, inside
    its precision and profiler scopes; ``stage_span`` holds the open
    ``localmd.<stage>`` span."""
    world, _ = world_and_rank(mesh)
    dataset = as_dataset(dataset_obj)
    t_total, d1, d2 = (int(s) for s in dataset.shape)
    check_fov_size((d1, d2))
    if order not in ("F", "C"):
        raise ValueError(f"order must be 'F' or 'C', got {order!r}")
    if rank_prune and (rank_prune_factor <= 0 or rank_prune_factor > 1):
        raise ValueError("rank_prune_factor must be in (0, 1]")

    timings: dict = {}
    t0 = [time.perf_counter()]
    stage_span.enter_context(span(None, None, f"localmd.{STAGES[0]}"))

    def _mark(stage):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[stage] = now - t0[0]
        t0[0] = now
        stage_span.close()
        following = STAGES.index(stage) + 1
        if following < len(STAGES):
            stage_span.enter_context(span(None, None, f"localmd.{STAGES[following]}"))

    np_rng = np.random.RandomState(seed) if seed is not None else np.random
    seeds = stage_seeds(seed, ("thresholds", "blocks", "prune"))

    # content-sensitive arguments are part of the resume fingerprint
    # (pipeline.py:309-334)
    pixel_weighting_token = None
    if pixel_weighting is not None:
        pw = np.ascontiguousarray(np.asarray(pixel_weighting, dtype=np.float32))
        pixel_weighting_token = hashlib.sha256(pw.tobytes()).hexdigest()[:16]
    ckpt = PipelineCheckpoint(
        checkpoint_path,
        dict(
            shape=(t_total, d1, d2), block_sizes=tuple(block_sizes), frame_range=frame_range,
            max_components=max_components, background_rank=background_rank,
            sim_conf=sim_conf, max_consecutive_failures=max_consecutive_failures,
            rank_prune=rank_prune, rank_prune_factor=rank_prune_factor,
            temporal_avg_factor=temporal_avg_factor, spatial_avg_factor=spatial_avg_factor,
            order=order, window_chunks=window_chunks, seed=seed, sim_iters=sim_iters,
            welch_compat=welch_compat, pixel_weighting=pixel_weighting_token,
            spatial_denoiser=_fn_token(spatial_denoiser),
            temporal_denoiser=_fn_token(temporal_denoiser),
        ),
    )
    sden = spatial_denoiser if spatial_denoiser is not None else identity
    tden = temporal_denoiser if temporal_denoiser is not None else identity
    precomputed = {}
    for stage in ("stats", "background"):
        if ckpt.has(stage):
            display(f"Resuming: {stage} stage loaded from checkpoint")
            precomputed.update(ckpt.load(stage))

    load_obj = PMDLoader(
        dataset,
        dtype=dtype,
        background_rank=background_rank,
        batch_size=frame_batch_size,
        pixel_batch_size=pixel_batch_size,
        order=order,
        compute_normalizer=compute_normalizer,
        seed=seed,
        welch_compat=welch_compat,
        np_rng=np_rng,
        num_workers=num_workers,
        precomputed=precomputed or None,
        cache_movie=cache_movie,
        device=dev,
        mesh=mesh,
    )
    if not ckpt.has("stats"):
        ckpt.save("stats", mean_img=load_obj.mean_img, std_img=load_obj.std_img)
    if not ckpt.has("background"):
        ckpt.save("background", spatial_basis=load_obj.spatial_basis)
    _mark("stats_and_background")

    # the clamps known before the statistics pass (aot.normalized_init_geometry)
    frame_range_in = frame_range
    frame_range, window_chunks, b1, b2 = normalized_init_geometry(
        (t_total, d1, d2), frame_range, window_chunks, block_sizes)
    if t_total < frame_range_in:
        display("WARNING: requested more frames than the dataset has")
        frames = list(range(t_total))
    else:
        frames = identify_window_chunks(frame_range, t_total, window_chunks, np_rng)
    display(f"Initializing on a total of {len(frames)} frames")

    if ckpt.has("thresholds"):
        display("Resuming: thresholds loaded from checkpoint")
        thr = ckpt.load("thresholds")
        spatial_threshold = float(thr["spatial_threshold"])
        temporal_threshold = float(thr["temporal_threshold"])
    else:
        display(f"Running threshold simulations for blocks {b1} x {b2} x {window_chunks}")
        # as many simulated noise blocks per batch as 1 GiB holds: few,
        # large batches keep the Monte-Carlo from being launch-bound
        sim_batch = max(1, min(sim_iters, TRANSIENT_FLOOR_BYTES // (b1 * b2 * window_chunks * 4)))
        spatial_threshold, temporal_threshold = threshold_heuristic(
            (b1, b2, window_chunks),
            num_comps=1,
            iters=sim_iters,
            percentile_threshold=sim_conf,
            generator=make_generator(seeds["thresholds"], dev),
            sim_batch=sim_batch,
            device=dev,
            # the generator's seed: a warm call with the same seed and
            # shapes reuses the simulation (pipeline.py:571-581)
            cache_token=("pipeline-thr", seeds["thresholds"]),
        )
        ckpt.save("thresholds", spatial_threshold=spatial_threshold,
                  temporal_threshold=temporal_threshold)
    _mark("thresholds")

    t_init = len(frames)
    if temporal_avg_factor >= t_init:
        raise ValueError(f"Need at least {temporal_avg_factor} frames")
    if t_init // temporal_avg_factor <= max_components:
        max_components = int(t_init // temporal_avg_factor)
        display(f"WARNING: max rank per block adjusted to {max_components}")
    sketch_limit = min(
        t_init // temporal_avg_factor,
        (b1 // spatial_avg_factor + (b1 % spatial_avg_factor > 0))
        * (b2 // spatial_avg_factor + (b2 % spatial_avg_factor > 0)),
    ) - DEFAULT_OVERSAMPLES
    if max_components > sketch_limit:
        max_components = int(sketch_limit)
        display(f"WARNING: max rank clamped to {max_components} for the rSVD sketch")
    if max_components <= 0:
        raise ValueError(
            "Configuration leaves no room for the rSVD sketch "
            f"(max_components clamped to {max_components}): increase "
            "frame_range, or decrease temporal_avg_factor/spatial_avg_factor, "
            "or use larger blocks"
        )
    crop_avg_constant = (t_init // temporal_avg_factor) * temporal_avg_factor

    # -- batched block decomposition -----------------------------------------
    grid = block_grid(d1, d2, (b1, b2), order)
    n_blocks = grid.n_blocks
    window_len = min(window_chunks, crop_avg_constant)
    single_window = window_len >= crop_avg_constant
    # every (window,) block's sketch is drawn up front over the global grid,
    # so results do not depend on the batch size or on which blocks a
    # resumed run still has to compute
    if single_window:
        n_windows, sketch_frames = 1, crop_avg_constant
    else:
        wl_eff = effective_window_length(window_len, crop_avg_constant, temporal_avg_factor)
        n_windows, sketch_frames = window_count(crop_avg_constant, wl_eff), wl_eff
    windows_run: list = []
    # per gathered batch, the blocks the window loop re-ran through the full
    # kernel (``blocks.fallback``; one entry a batch: ``blocks.batches``)
    fallbacks: list = []
    # the residual windows' device seconds (``blocks.residual_s``), settled
    # after the stage's fence
    block_record: dict = {}
    residual = DeviceSpans(block_record, "blocks.residual_s", "blocks.residual", dev)
    # blocks the coset stage left to the gathered batches (``blocks.remainder``)
    remainder_blocks = 0
    blocks_ckpt = ckpt.has("blocks")
    if blocks_ckpt:
        display("Resuming: blockwise decomposition loaded from checkpoint")
        loaded = ckpt.load("blocks")
        panels = torch.as_tensor(loaded["panels"], device=dev)
        counts = np.asarray(loaded["counts"])
        v_blocks = torch.as_tensor(loaded["v_blocks"], device=dev)
        temporal_basis_crop = torch.as_tensor(loaded["temporal_basis_crop"], device=dev)
    else:
        sketches = normal(
            (sketch_frames // temporal_avg_factor, max_components + DEFAULT_OVERSAMPLES),
            make_generator(seeds["blocks"], dev), dev, batch=(n_windows, n_blocks),
        )
        # Standardize + filter only the frames the block stage reads (each
        # frame's result is independent of the others, so this equals the
        # JAX package's load-then-crop).
        display("Loading and filtering initialization frames")
        # the movie cache may leave too little memory (pipeline.py:598-607)
        data, temporal_basis_crop = load_obj.without_cache_on_oom(
            load_obj.temporal_crop_with_filter, frames[:crop_avg_constant])
        if pixel_weighting is not None:
            data = data * torch.as_tensor(
                np.asarray(pixel_weighting, dtype=np.float32), device=dev
            )[:, :, None]

        bb = block_batch_budget(dev, per_block_bytes=b1 * b2 * crop_avg_constant * 4 * 4,
                                n_blocks=n_blocks, block_batch_size=block_batch_size)
        if mesh is not None:
            # whole shares for every rank, and one batch size for all: each
            # rank read its own free memory (pipeline.py:703-712)
            bb = agree_int_min(pad_to_multiple(bb, world), mesh)
        # the gather-free coset stage (pipeline.py:944-1033): one window, no
        # mesh, identity denoisers, no checkpoint, a grid of coset lattices
        # and transients that fit beside the live buffers
        coset_plan = None
        if single_window and mesh is None and coset_stage_eligible(
            b1, b2, spatial_avg_factor, sden, tden, checkpoint_path, dev
        ):
            coset_plan = coset_stage_plan(d1, d2, b1, b2)
        if coset_plan is not None:
            est = coset_stage_transient_bytes(
                d1, d2, crop_avg_constant, b1, b2, max_components, temporal_avg_factor,
                spatial_avg_factor, len(coset_plan[1]),
            )
            free = device_free_bytes(dev)
            if free is not None and est > free:
                display(f"Coset block stage needs ~{est / 1e9:.1f} GB of transients "
                        f"(~{free / 1e9:.1f} GB free): using batches of gathered blocks")
                coset_plan = None
        display(
            f"Decomposing {n_blocks} overlapping blocks ({b1}x{b2}, max "
            f"{max_components} comps/block, {n_windows} window(s)) "
            + ("on the coset lattices" if coset_plan is not None else f"in batches of {bb}")
        )

        def run_batch(idx: np.ndarray, ids: torch.Tensor):
            """One batch of block ids, on the host and on the device (any ids:
            the sketches are per block). With a mesh the batch is padded with
            block 0 to a multiple of the mesh size and the padding's outputs
            are dropped (pipeline.py:879-884)."""
            n_real = len(idx)
            pad = pad_to_multiple(n_real, world) - n_real
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                ids = torch.cat([ids, ids.new_zeros(pad)])
            if single_window:
                step = window0_chunk_step if mesh is None else partial(sharded_window0_chunk_step, mesh)
                acc, cnt, v_fit = step(
                    data, grid.starts[idx], sketches[0].index_select(0, ids), b1, b2,
                    max_components, temporal_avg_factor, spatial_avg_factor,
                    spatial_threshold, temporal_threshold, max_consecutive_failures, sden, tden,
                )
                windows_run.append(1)
                fallbacks.append(0)
            else:
                acc, cnt, v_fit, ran, fallback = windowed_pmd_batched(
                    extract_patches(data, grid.starts[idx], b1, b2), sketches.index_select(1, ids),
                    window_len, max_components, spatial_threshold, temporal_threshold,
                    max_consecutive_failures, temporal_avg_factor, spatial_avg_factor, sden, tden,
                    mesh=mesh, residual_span=residual.span,
                )
                windows_run.append(ran)
                fallbacks.append(fallback)
            return acc[:n_real], cnt[:n_real], v_fit[:n_real]

        parts = []  # (ids, panels, counts, v_blocks), in any order
        if checkpoint_path is not None:
            # per-batch parts (pipeline.py:895-942): a rerun computes only
            # the blocks no part holds
            for st in ckpt.matching_stages("blocks.part"):
                d = ckpt.load(st)
                parts.append((d["idx"],) + tuple(torch.as_tensor(d[k], device=dev)
                                                  for k in ("panels", "counts", "v_blocks")))
            done = np.concatenate([p[0] for p in parts]) if parts else np.empty(0, np.int64)
            missing = np.setdiff1d(np.arange(n_blocks), done)
            if done.size:
                display(f"Resuming block stage: {n_blocks - missing.size}/{n_blocks} "
                        "blocks from per-batch checkpoints")
        else:
            missing = np.arange(n_blocks)
        if coset_plan is not None:
            meta, ids, remainder = coset_plan
            acc, cnt, v_fit = window0_coset_stage(
                data, sketches[0].index_select(0, torch.as_tensor(ids, device=dev)), meta, b1, b2,
                max_components, temporal_avg_factor, spatial_avg_factor, spatial_threshold,
                temporal_threshold, max_consecutive_failures, crop_avg_constant,
            )
            windows_run.append(1)
            parts.append((ids, acc, cnt, v_fit))
            # the blocks off the lattices (a snapped tail): one gathered batch
            missing = remainder
            remainder_blocks = int(remainder.size)
        # one upload: a copy from pageable memory waits for the stream, and
        # one per batch would stall the host between batches
        missing_dev = torch.as_tensor(missing, device=dev)
        for s in range(0, missing.size, bb):
            idx = missing[s : s + bb]
            acc, cnt, v_fit = run_batch(idx, missing_dev[s : s + bb])
            if checkpoint_path is not None:
                ckpt.save(f"blocks.part{int(idx[0]):06d}", idx=idx, panels=acc, counts=cnt,
                          v_blocks=v_fit)
            parts.append((idx, acc, cnt, v_fit))
        del data  # movie-sized; everything below works from the block fits
        panels, counts, v_blocks = (torch.cat([p[k] for p in parts], dim=0) for k in (1, 2, 3))
        all_idx = np.concatenate([p[0] for p in parts])
        if not np.array_equal(all_idx, np.arange(n_blocks)):
            # a resumed run's parts come in any order
            perm = torch.as_tensor(np.argsort(all_idx), device=dev)
            panels, counts, v_blocks = (x.index_select(0, perm) for x in (panels, counts, v_blocks))
        counts = counts.cpu().numpy()
        del parts
        ckpt.save("blocks", panels=panels, counts=counts, v_blocks=v_blocks,
                  temporal_basis_crop=temporal_basis_crop)
        # the whole-stage checkpoint supersedes the per-batch parts
        for st in ckpt.matching_stages("blocks.part"):
            ckpt.discard(st)

    # -- pyramid-weight + normalize + assemble U -----------------------------
    # uploaded once per grid and device, cached on the memoized grid
    # (pipeline.py:1094-1095)
    weights_flat, cum_flat, rows, _ = grid.device_constants(dev)
    panels = panels * weights_flat[None, :, None]
    panels = panels / cum_flat[rows][:, :, None]
    u = BlockSparseMatrix(
        panels=panels,
        rows=rows,
        n_pixels=d1 * d2,
        dense_basis=load_obj.spatial_basis,
        starts=grid.starts,
        block_shape=(b1, b2),
        cosets=tuple(ids for ids, _ in grid.cosets()),
        coset_info=grid.coset_info(dev),
        cell_geom=grid.cell_geometry(),
    )
    if not ckpt.has("v") and coset_vproj_eligible(u):
        # the V regression's cell operands need only U and the statistics:
        # queue their build now, off the V pass's critical path
        # (pipeline.py:1112-1119)
        load_obj.prepare_vproj_cells(u)
    v_cropped = torch.cat(
        [v_blocks.reshape(n_blocks * max_components, -1), temporal_basis_crop], dim=0
    )
    del v_blocks
    total_rank = int(counts.sum())
    _mark("block_decomposition")
    residual.settle()
    display(f"Total blockwise rank (pre-background): {total_rank}")

    # -- factorized SVD / rank prune ----------------------------------------
    k_bg = u.dense_basis.shape[1]
    # the Gram's form (``fsvd.banded``): 0 where the projector is resumed
    fsvd_banded = 0

    def _compute_projector():
        nonlocal fsvd_banded
        if ckpt.has("projector"):
            display("Resuming: mixing matrix loaded from checkpoint")
            return torch.as_tensor(ckpt.load("projector")["p"], device=dev)
        if rank_prune:
            min_dim = min(total_rank + k_bg, v_cropped.shape[1])
            random_mat = normal(
                (v_cropped.shape[1], int(min_dim * rank_prune_factor)),
                make_generator(seeds["prune"], dev), dev,
            )
            target_v = v_cropped @ random_mat
        else:
            target_v = v_cropped
        # with more than one rank every rank holds the gathered panels and
        # the Gram runs whole on each (pipeline.py:1294-1301)
        fsvd_mesh = mesh if world == 1 else None
        fsvd_banded = int(gram_is_banded(u, target_v, fsvd_mesh))
        p_ = compute_lowrank_factorized_svd(
            u, target_v, only_left=True, mesh=fsvd_mesh, expected_rank=total_rank + k_bg,
        )
        ckpt.save("projector", p=p_)
        return p_

    v_resumed = ckpt.has("v")

    def _project_and_reformat():
        p = _compute_projector()
        display(f"Rank after reduction: <= {p.shape[1]}")
        _mark("factorized_svd")
        if v_resumed:
            display("Resuming: V regression loaded from checkpoint")
            v = torch.as_tensor(ckpt.load("v")["v"], device=dev)
        else:
            display("Running streaming V regression over the full movie")
            v = load_obj.v_projection(u, p)
        _mark("v_regression")
        display("Final SVD reformat")
        r, s_vals, vt, s_keep = final_svd_reformat(p, v, rel_tol=final_rank_tol)
        return p, v, r, s_vals, vt, s_keep

    if not v_resumed:
        # the V regression's disk reads and copies overlap the factorized SVD
        load_obj.start_v_prefetch()
    # The projector, the V regression and the reformat share one OOM-retry
    # scope: on a device OOM the movie cache goes, the projector is made
    # again from the same seed and the frames stream again
    # (pipeline.py:1314-1376).
    p, v, r, s_vals, vt, s_keep = load_obj.without_cache_on_oom(_project_and_reformat)
    del v_cropped
    if not v_resumed:
        ckpt.save("v", v=v)
    _mark("final_reformat")
    display(f"Matrix decomposition completed (final rank {int(s_keep.sum())})")

    out = PMDArray(
        u, r, s_vals, vt, load_obj.shape, order,
        load_obj.mean_img, load_obj.std_img,
        counts=counts, k2_keep=s_keep,
    )
    out.pipeline_timings = timings
    out.pipeline_ranks = {
        "blockwise": int(total_rank),
        "pre_reduction": int(total_rank + k_bg),
        "reduced": int(p.shape[1]),
        "final": int(s_vals.shape[0]),
    }
    out.pipeline_windows = {"n_windows": n_windows, "run_per_batch": windows_run}
    out.pipeline_cache = {
        **load_obj.pipeline_record(),
        "fsvd.banded": fsvd_banded,
        "blocks.remainder": remainder_blocks,
        "blocks.batches": len(fallbacks),
        "blocks.windows_run": int(sum(windows_run)),
        "blocks.fallback": int(sum(fallbacks)),
        **block_record,
    }
    out.pipeline_aot = {"enabled": False, "used": False}
    out.pipeline_warm = {"completed": [], "errors": {}}
    out._stage_warmer = None
    return out
