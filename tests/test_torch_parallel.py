"""The port's mesh path (``localmd_tpu_torch.parallel``) on torch.distributed
against the JAX package's mesh on the CPU.

Ranks are real processes: one launch of 1, 2 and 4 gloo ranks each
(``OMP_NUM_THREADS=1``), started together by a module-scoped fixture and
held to a time limit after which every rank is killed. Each rank runs this
file under ``__main__`` (it imports only torch and the port) and writes its
results; the JAX side runs in the test process on ``tests/conftest.py``'s
8 virtual CPU devices (``localmd_tpu.parallel.mesh.make_mesh``: 4 devices
for the split phases, 2 for the pipeline, whose compiles dominate the
file's time), with the same numpy inputs, the same injected sketch and
pinned thresholds. Tolerances: the split phases 1e-5 (Gram, V chunk)
and 1e-4 (block projectors and U V products), decisions and counts exact;
the pipeline 1e-4 relative Frobenius against JAX's mesh run and 1e-5
against the port's own single-device run, ``pipeline_ranks`` and the kept
rank equal, every rank's factors equal to rank 0's bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from functools import partial

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = (1, 2, 4)
JAX_MESH, JAX_PIPE_MESH = 4, 2
LAUNCH_TIMEOUT = 240          # seconds for one launch of ranks, then all are killed
GROUP_TIMEOUT = timedelta(seconds=60)

MAX_RANK, TAF, SAF = 3, 4, 2
BLOCK_THRESHOLDS = (1.33, 2.05)         # the JAX Monte-Carlo's at (12, 12, 80)
WB, WT, WL, W_RANK = 16, 240, 80, 6     # the windowed loop's blocks
W_THRESHOLDS = (1.0, 1.6)
PIPE = dict(frame_range=400, max_components=6, background_rank=2, temporal_avg_factor=5, seed=0)
PIPE_CASES = {
    # thresholds pinned to the JAX Monte-Carlo's for the case's (16, 16, window)
    "one_window": dict(window_chunks=None, thresholds=(1.34, 2.30)),
    "multi_window": dict(window_chunks=100, thresholds=(1.35, 2.13)),
}


# -- inputs, made from seeds with numpy (the ranks make the same) ------------------

def _sketch(shape):
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


def _smooth(x, axes, passes):
    for _ in range(passes):
        y = x.copy()
        for ax in axes:
            y = y + np.roll(x, 1, ax) + np.roll(x, -1, ax)
        x = y / (1 + 2 * len(axes))
    return x


def smooth_movie(rank, dims, seed, noise):
    """(T, d1, d2) smooth rank-``rank`` signal plus white noise."""
    rng = np.random.default_rng(seed)
    t, d1, d2 = dims
    spatial = _smooth(rng.random((d1, d2, rank)), (0, 1), 4).reshape(d1 * d2, rank)
    temporal = _smooth(rng.random((rank, t)), (1,), 3)
    movie = (spatial @ temporal).T.reshape(t, d1, d2) / spatial.std() / temporal.std()
    return (movie + noise * rng.standard_normal(movie.shape)).astype(np.float32)


def gram_inputs():
    """Three Gram cases (grid, block, right's columns, col_chunk): 20x20
    with col_chunk below m; 18x19 = 342 pixels, not divisible by 4, also
    with col_chunk below m; 22x22 with 25 blocks, not divisible by 2 or 4
    (through ``_gram_quadratic_mesh``). JAX computes the last two."""
    rng = np.random.default_rng(8)
    out = {}
    for name, (d1, d2, blk, m, cc) in {"chunked": (20, 20, 8, 20, 7), "pixels_342": (18, 19, 9, 5, 3),
                                        "blocks_25": (22, 22, 8, 9, 9)}.items():
        from localmd_tpu_torch.ops.tiling import BlockGrid

        grid = BlockGrid(d1, d2, (blk, blk))
        panels = rng.standard_normal((grid.n_blocks, blk * blk, 4)).astype(np.float32)
        dense = rng.standard_normal((d1 * d2, 2)).astype(np.float32)
        right = rng.standard_normal((grid.n_blocks * 4 + 2, m)).astype(np.float32)
        out[name] = dict(grid=grid, panels=panels, dense=dense, right=right, col_chunk=cc)
    return out


def vproj_inputs():
    rng = np.random.default_rng(9)
    from localmd_tpu_torch.ops.tiling import BlockGrid

    grid = BlockGrid(24, 16, (12, 8))
    panels = rng.standard_normal((grid.n_blocks, 96, 4)).astype(np.float32)
    dense = rng.standard_normal((24 * 16, 2)).astype(np.float32)
    p = rng.standard_normal((grid.n_blocks * 4 + 2, 5)).astype(np.float32)
    chunk = rng.standard_normal((24 * 16, 18)).astype(np.float32) + 3.0
    mean = rng.standard_normal(24 * 16).astype(np.float32) + 3.0
    std = (0.5 + rng.random(24 * 16)).astype(np.float32)
    return dict(grid=grid, panels=panels, dense=dense, p=p, chunk=chunk, mean=mean, std=std)


def block_inputs():
    """A (30, 30, 80) field of smooth rank-2 signal in unit noise and its 16
    overlapping 12x12 blocks: with 3 slots some components pass and some
    fail."""
    from localmd_tpu_torch.ops.tiling import BlockGrid

    data = smooth_movie(2, (80, 30, 30), seed=10, noise=1.0).transpose(1, 2, 0).copy()
    grid = BlockGrid(30, 30, (12, 12))
    patches = np.stack([data[a : a + 12, b : b + 12] for a, b in grid.starts])
    return dict(data=data, starts=grid.starts, patches=patches,
                sketch=_sketch((80 // TAF, MAX_RANK + 10)))


def windowed_inputs():
    """8 blocks of (16, 16, 240): blocks 0-3 carry a smooth rank-6 signal of
    distinct strengths that fills all 6 slots in window 0 (with two ranks, rank 0's blocks are
    full after window 0 and it would stop alone); blocks 4-7 a rank-2
    signal that changes every 80 frames and fill 3 slots in window 0."""
    rng = np.random.default_rng(11)
    n = 8
    blocks = np.empty((n, WB, WB, WT), np.float32)
    for b in range(n):
        if b < 4:
            u = _smooth(rng.standard_normal((WB, WB, W_RANK)), (0, 1), 4)
            v = _smooth(rng.standard_normal((W_RANK, WT)), (1,), 3)
            v *= np.linspace(12.0, 4.0, W_RANK)[:, None] / v.std(axis=1, keepdims=True)
            sig = np.einsum("ijr,rt->ijt", u / u.std(), v)
        else:  # the construction of test_torch_windowed.windowed_blocks
            parts = []
            for _ in range(WT // WL):
                u = _smooth(rng.standard_normal((WB, WB, 2)), (0, 1), 6)
                v = _smooth(rng.standard_normal((2, WL)), (1,), 4)
                u /= u.reshape(-1, 2).std(axis=0)
                v /= v.std(axis=1, keepdims=True)
                parts.append(np.einsum("ijr,rt->ijt", u, v))
            sig = np.concatenate(parts, axis=-1)
        blocks[b] = sig + rng.standard_normal((WB, WB, WT))
    return blocks


def pipeline_movie():
    return smooth_movie(4, (500, 40, 36), seed=3, noise=0.3)


def volumetric_planes():
    return [smooth_movie(2, (280, 20, 20), seed=20 + z, noise=0.3) for z in range(2)]


VOLUMETRIC = dict(frame_range=280, max_components=3, background_rank=1, temporal_avg_factor=4,
                  sim_iters=10, seed=0)


# -- one rank: run under __main__; imports torch and the port only ------------------

def _port_bsm(grid, panels, dense):
    from localmd_tpu_torch.blocksparse import BlockSparseMatrix

    return BlockSparseMatrix(
        panels=torch.as_tensor(panels), rows=torch.as_tensor(grid.rows, dtype=torch.long),
        n_pixels=grid.d1 * grid.d2, dense_basis=torch.as_tensor(dense), starts=grid.starts,
        block_shape=grid.block_sizes, cosets=tuple(ids for ids, _ in grid.cosets()),
    )


def _pmd_arrays(pmd) -> dict:
    t = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return dict(recon=pmd[:, :, :], panels=t(pmd._blocksparse.panels), r=t(pmd._r_padded),
                s=t(pmd._s_src), v=t(pmd._v_src), mean=t(pmd.mean_img), var=t(pmd.var_img))


def rank_main(rank: int, world: int, port: int, out_prefix: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch import engine, factorization, volumetric_decomposition
    from localmd_tpu_torch.loader import PMDLoader
    from localmd_tpu_torch.parallel import (
        make_mesh,
        sharded_block_decomposition,
        sharded_gram_quadratic,
        sharded_v_projection_chunk,
    )
    from localmd_tpu_torch.parallel.sharded import sharded_window0_chunk_step
    from localmd_tpu_torch.utils.random import sketch_override

    mesh = make_mesh(device="cpu")
    arrays, meta = {}, {}

    for name, case in gram_inputs().items():
        grid, right = case["grid"], torch.as_tensor(case["right"])
        if name == "blocks_25":
            u = _port_bsm(grid, case["panels"], case["dense"])
            got = factorization._gram_quadratic_mesh(u, right, mesh, col_chunk=case["col_chunk"])
        else:
            got = sharded_gram_quadratic(
                mesh, torch.as_tensor(case["panels"]), torch.as_tensor(grid.rows, dtype=torch.long),
                torch.as_tensor(case["dense"]), right, grid.d1 * grid.d2,
                col_chunk=case["col_chunk"])
        arrays[f"gram_{name}"] = got.numpy()

    vp = vproj_inputs()
    for t_c in (16, 18):
        arrays[f"vproj_{t_c}"] = sharded_v_projection_chunk(
            mesh, torch.as_tensor(vp["panels"]), torch.as_tensor(vp["grid"].rows, dtype=torch.long),
            torch.as_tensor(vp["dense"]), torch.as_tensor(vp["p"]),
            torch.as_tensor(vp["chunk"][:, :t_c]), torch.as_tensor(vp["mean"]),
            torch.as_tensor(vp["std"])).numpy()

    bl = block_inputs()
    n = len(bl["starts"])
    sketches = torch.as_tensor(bl["sketch"]).expand(n, -1, -1)
    acc, counts, v_fit = sharded_window0_chunk_step(
        mesh, torch.as_tensor(bl["data"]), bl["starts"], sketches, 12, 12, MAX_RANK, TAF, SAF,
        *BLOCK_THRESHOLDS, 1)
    arrays.update(w0_acc=acc.numpy(), w0_counts=counts.numpy(), w0_v=v_fit.numpy())
    local_fn = partial(engine.single_block_md_batched, max_rank=MAX_RANK, temporal_avg_factor=TAF,
                       spatial_avg_factor=SAF, spatial_threshold=BLOCK_THRESHOLDS[0],
                       temporal_threshold=BLOCK_THRESHOLDS[1])
    u, dec, v = sharded_block_decomposition(mesh, local_fn, torch.as_tensor(bl["patches"]), sketches)
    arrays.update(bd_u=u.numpy(), bd_dec=dec.numpy(), bd_v=v.numpy())

    blocks = windowed_inputs()
    n_windows = WT // WL
    w_sketches = torch.as_tensor(_sketch((WL // TAF, W_RANK + 10))).expand(n_windows, len(blocks), -1, -1)
    res = engine.windowed_pmd_batched(torch.as_tensor(blocks), w_sketches, WL, W_RANK,
                                      *W_THRESHOLDS, 1, TAF, SAF, mesh=mesh)
    arrays.update(win_acc=res.spatial.numpy(), win_counts=res.counts.numpy(),
                  win_temporal=res.temporal.numpy())
    meta["windows_run"] = int(res.windows_run)

    movie = pipeline_movie()
    for name, case in PIPE_CASES.items():
        port_pipeline.threshold_heuristic = lambda *a, _t=case["thresholds"], **k: _t
        with sketch_override(_sketch):
            pmd = port_pipeline.localmd_decomposition(
                movie, (16, 16), window_chunks=case["window_chunks"], mesh=mesh, device="cpu", **PIPE)
        arrays.update({f"pipe_{name}_{k}": x for k, x in _pmd_arrays(pmd).items()})
        meta[f"pipe_{name}"] = dict(ranks=pmd.pipeline_ranks, rank=pmd.rank,
                                    windows=pmd.pipeline_windows)

    port_pipeline.threshold_heuristic = lambda *a, **k: PIPE_CASES["one_window"]["thresholds"]
    if world == 1:
        # aot_warm with a mesh: accepted, and nothing is warmed
        pmd = port_pipeline.localmd_decomposition(movie, (16, 16), mesh=mesh, device="cpu",
                                                  aot_warm=True, **PIPE)
        meta["aot"] = dict(warm=pmd.pipeline_warm, aot=pmd.pipeline_aot)
    with sketch_override(_sketch):
        vol = volumetric_decomposition(volumetric_planes(), (10, 10), mesh=mesh, device="cpu",
                                       **VOLUMETRIC)
    arrays["volumetric"] = vol[0:280]

    meta.update(raised={}, stats_runs=0)
    if world > 1:
        meta.update(_misconfigured_calls(world, mesh, movie, out_prefix))
    np.savez(out_prefix + ".npz", **arrays)
    with open(out_prefix + ".json", "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _misconfigured_calls(world, mesh, movie, out_prefix) -> dict:
    """Each misconfigured call's exception type (None if it ran) and how
    many calls reached the statistics pass. The short mesh is a mesh of
    rank 0 alone (every rank builds it: making its group is collective)."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from torch.distributed.device_mesh import DeviceMesh

    from localmd_tpu_torch import volumetric_decomposition
    from localmd_tpu_torch.loader import PMDLoader
    from localmd_tpu_torch.parallel import make_mesh

    stats_runs = []
    run_stats = PMDLoader._run_stats_with_oom_retry
    PMDLoader._run_stats_with_oom_retry = lambda self: stats_runs.append(1) or run_stats(self)
    cases = {
        "no_mesh": dict(mesh=None),
        "short_mesh": dict(mesh=DeviceMesh("cpu", [0])),
        "checkpoint": dict(mesh=mesh, checkpoint_path=out_prefix + "_ckpt"),
        "devices_and_mesh": "volumetric",
        "make_mesh_n": "make_mesh",
    }
    raised = {}
    for name, kw in cases.items():
        try:
            if kw == "volumetric":
                volumetric_decomposition(volumetric_planes(), (10, 10), mesh=mesh,
                                         devices=["cpu", "cpu"], **VOLUMETRIC)
            elif kw == "make_mesh":
                make_mesh(n_devices=world + 1, device="cpu")
            else:
                port_pipeline.localmd_decomposition(movie, (16, 16), device="cpu", **kw, **PIPE)
            raised[name] = None
        except (TypeError, ValueError) as e:
            raised[name] = type(e).__name__
    PMDLoader._run_stats_with_oom_retry = run_stats
    return dict(raised=raised, stats_runs=len(stats_runs))


# -- the launches ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world: int, out_dir: str) -> list:
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, HERE, os.environ.get("PYTHONPATH", "")])}
    port = _free_port()
    return [
        (subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), str(port),
                           os.path.join(out_dir, f"w{world}_r{r}")],
                          env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), r)
        for r in range(world)
    ]


def _finish(procs: list, deadline: float, world: int) -> list:
    """Wait for every rank until ``deadline``; on a timeout or a failed rank
    kill them all and raise with the logs."""
    logs = []
    try:
        for proc, _ in procs:
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for proc, _ in procs:
            proc.kill()
            proc.communicate()
        raise AssertionError(f"world {world}: a rank did not finish in {LAUNCH_TIMEOUT} s")
    bad = [(r, log) for (proc, r), log in zip(procs, logs) if proc.returncode != 0]
    if bad:
        raise AssertionError(f"world {world}: rank {bad[0][0]} failed:\n{bad[0][1][-4000:]}")
    return logs


def _jax_side() -> dict:
    """Every JAX result on make_mesh(JAX_MESH), with the inputs the ranks use."""
    import jax
    import jax.numpy as jnp

    import localmd_tpu.pipeline as jax_pipeline
    from localmd_tpu import engine as je
    from localmd_tpu.blocksparse import BlockSparseMatrix
    from localmd_tpu.factorization import _gram_quadratic_mesh
    from localmd_tpu.ops.linalg import sketch_override
    from localmd_tpu.parallel.mesh import make_mesh
    from localmd_tpu.parallel.sharded import (
        sharded_block_decomposition,
        sharded_gram_quadratic,
        sharded_v_projection_chunk,
        sharded_window0_chunk_step,
    )

    mesh = make_mesh(JAX_MESH)
    out = {}
    for name, case in gram_inputs().items():
        grid = case["grid"]
        if name == "chunked":
            continue
        if name == "blocks_25":
            u = BlockSparseMatrix(panels=jnp.asarray(case["panels"]), rows=jnp.asarray(grid.rows),
                                  n_pixels=grid.d1 * grid.d2, dense_basis=jnp.asarray(case["dense"]))
            got = _gram_quadratic_mesh(u, jnp.asarray(case["right"]), mesh, col_chunk=case["col_chunk"])
        else:
            got = sharded_gram_quadratic(mesh, jnp.asarray(case["panels"]), jnp.asarray(grid.rows),
                                         jnp.asarray(case["dense"]), jnp.asarray(case["right"]),
                                         grid.d1 * grid.d2, col_chunk=case["col_chunk"])
        out[f"gram_{name}"] = np.asarray(got)
    vp = vproj_inputs()
    out["vproj_16"] = np.asarray(sharded_v_projection_chunk(
        mesh, jnp.asarray(vp["panels"]), jnp.asarray(vp["grid"].rows), jnp.asarray(vp["dense"]),
        jnp.asarray(vp["p"]), jnp.asarray(vp["chunk"][:, :16]), jnp.asarray(vp["mean"]),
        jnp.asarray(vp["std"])))

    def jax_sketch():
        return sketch_override(lambda shape: jnp.asarray(_sketch(shape)))

    bl = block_inputs()
    n = len(bl["starts"])
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    with jax_sketch():
        acc, counts, v_fit = sharded_window0_chunk_step(
            mesh, jnp.asarray(bl["data"]), jnp.asarray(bl["starts"]), keys, 12, 12, MAX_RANK, TAF,
            SAF, *BLOCK_THRESHOLDS, 1)
        local_fn = partial(je.single_block_md_batched, max_rank=MAX_RANK, temporal_avg_factor=TAF,
                           spatial_avg_factor=SAF, spatial_threshold=BLOCK_THRESHOLDS[0],
                           temporal_threshold=BLOCK_THRESHOLDS[1])
        u, dec, v = sharded_block_decomposition(mesh, local_fn, jnp.asarray(bl["patches"]), keys)
        res = je.windowed_pmd_batched(jnp.asarray(windowed_inputs()), jax.random.PRNGKey(3), WL,
                                      W_RANK, *W_THRESHOLDS, 1, TAF, SAF, mesh=mesh)
    out.update(w0_acc=np.asarray(acc), w0_counts=np.asarray(counts), w0_v=np.asarray(v_fit),
               bd_u=np.asarray(u), bd_dec=np.asarray(dec), bd_v=np.asarray(v),
               win_acc=np.asarray(res.spatial), win_counts=np.asarray(res.counts),
               win_temporal=np.asarray(res.temporal))

    movie = pipeline_movie()
    saved = jax_pipeline.threshold_heuristic
    try:
        for name, case in PIPE_CASES.items():
            jax_pipeline.threshold_heuristic = lambda *a, _t=case["thresholds"], **k: _t
            with jax_sketch():
                pmd = jax_pipeline.localmd_decomposition(
                    movie, (16, 16), window_chunks=case["window_chunks"],
                    mesh=make_mesh(JAX_PIPE_MESH), **PIPE)
            out[f"pipe_{name}"] = pmd
    finally:
        jax_pipeline.threshold_heuristic = saved
    return out


def _port_single() -> dict:
    """The port's single-device runs of the pipeline and volumetric cases."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch import volumetric_decomposition
    from localmd_tpu_torch.utils.random import sketch_override

    out = {}
    movie = pipeline_movie()
    saved = port_pipeline.threshold_heuristic
    try:
        for name, case in PIPE_CASES.items():
            port_pipeline.threshold_heuristic = lambda *a, _t=case["thresholds"], **k: _t
            with sketch_override(_sketch):
                out[f"pipe_{name}"] = port_pipeline.localmd_decomposition(
                    movie, (16, 16), window_chunks=case["window_chunks"], device="cpu", **PIPE)
        port_pipeline.threshold_heuristic = lambda *a, **k: PIPE_CASES["one_window"]["thresholds"]
        with sketch_override(_sketch):
            out["volumetric"] = volumetric_decomposition(volumetric_planes(), (10, 10),
                                                         device="cpu", **VOLUMETRIC)[0:280]
    finally:
        port_pipeline.threshold_heuristic = saved
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch 1, 2 and 4 ranks at once, compute the JAX side and the port's
    single-device runs meanwhile, then collect every rank's results."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    started = time.monotonic()
    launches = {w: _start(w, out_dir) for w in WORLDS}
    try:
        jax_out = _jax_side()
        single = _port_single()
    except BaseException:
        for procs in launches.values():
            for proc, _ in procs:
                proc.kill()
                proc.communicate()
        raise
    ranks = {}
    for w, procs in launches.items():
        try:
            _finish(procs, started + LAUNCH_TIMEOUT, w)
        except AssertionError as e:
            ranks[w] = e
            continue
        ranks[w] = [(dict(np.load(os.path.join(out_dir, f"w{w}_r{r}.npz"))),
                     json.load(open(os.path.join(out_dir, f"w{w}_r{r}.json"))))
                    for r in range(w)]
    return jax_out, single, ranks


def _rank0(runs, world):
    got = runs[2][world]
    if isinstance(got, AssertionError):
        raise got
    return got


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _proj(u):
    u = np.asarray(u, np.float64)
    return u @ np.swapaxes(u, -1, -2)


# -- tests -------------------------------------------------------------------------

PARTITION_SWEEP = [(320, 128, 2), (320, 128, 3), (1100, 1024, 4), (10, 1, 4), (5, 1, 8),
                   (2048, 1024, 4), (30000, 1024, 8), (0, 1024, 2)]


@pytest.mark.parametrize("t,chunk,hosts", PARTITION_SWEEP)
def test_partitions_match_jax(t, chunk, hosts):
    """Both partitions over every rank, trailing empty stripes included,
    equal the JAX package's; the frame stripes tile the movie in order."""
    from localmd_tpu import loader as jl
    from localmd_tpu_torch import loader as tl

    for merge in (True, False):
        ranges = tl._chunk_ranges(t, chunk, merge_tail=merge) if t else []
        assert ranges == jl._chunk_ranges(t, chunk, merge_tail=merge) or not t
        frames, chunks = [], []
        for h in range(hosts):
            got_f = tl.partition_ranges_for_host(ranges, h, hosts)
            got_c = tl.partition_chunks_for_host(ranges, h, hosts)
            assert got_f == jl.partition_ranges_for_host(ranges, h, hosts)
            assert got_c == jl.partition_chunks_for_host(ranges, h, hosts)
            frames += got_f
            chunks += got_c
        assert chunks == ranges
        assert sum(b - a for a, b in frames) == t
        assert all(frames[i][1] == frames[i + 1][0] for i in range(len(frames) - 1))
    with pytest.raises(ValueError):
        tl.partition_ranges_for_host([(0, 10)], hosts, hosts)


def test_stage_warms_on_a_one_rank_mesh(runs):
    """``aot_warm=True`` with a mesh reports what the JAX package reports
    with its warms off: the port runs no stage warm."""
    meta = _rank0(runs, 1)[0][1]["aot"]
    assert meta["warm"] == {"completed": [], "errors": {}}
    assert meta["aot"] == {"enabled": False, "used": False}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["chunked", "pixels_342", "blocks_25"])
def test_sharded_gram_quadratic(runs, world, case):
    """Against the port's ``gram_quadratic`` and JAX's on its mesh, <= 1e-5."""
    got = _rank0(runs, world)[0][0][f"gram_{case}"]
    inputs = gram_inputs()[case]
    u = _port_bsm(inputs["grid"], inputs["panels"], inputs["dense"])
    if case != "chunked":
        assert _rel(got, runs[0][f"gram_{case}"]) <= 1e-5
    want = u.gram_quadratic(torch.as_tensor(inputs["right"])).numpy()
    assert _rel(got, want) <= 1e-5
    if world == 1 and case == "blocks_25":   # U's cosets, one column slice: the same sums
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_v_projection_chunk(runs, world):
    """16 frames against JAX's on its mesh; 18 frames (ragged stripes)
    against P^T U^T standardize(X) made with the port's ``rmatmul``."""
    arrays = _rank0(runs, world)[0][0]
    assert _rel(arrays["vproj_16"], runs[0]["vproj_16"]) <= 1e-5
    vp = vproj_inputs()
    u = _port_bsm(vp["grid"], vp["panels"], vp["dense"])
    x = (vp["chunk"] - vp["mean"][:, None]) / vp["std"][:, None]
    want = vp["p"].T @ u.rmatmul(torch.as_tensor(x)).numpy()
    assert _rel(arrays["vproj_18"], want) <= 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_window0_chunk_step(runs, world):
    arrays = _rank0(runs, world)[0][0]
    jax_out = runs[0]
    np.testing.assert_array_equal(arrays["w0_counts"], jax_out["w0_counts"])
    assert 0 < arrays["w0_counts"].min() and arrays["w0_counts"].max() <= MAX_RANK
    assert _rel(_proj(arrays["w0_acc"]), _proj(jax_out["w0_acc"])) <= 1e-4
    assert _rel(arrays["w0_acc"] @ arrays["w0_v"], jax_out["w0_acc"] @ jax_out["w0_v"]) <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_block_decomposition(runs, world):
    arrays = _rank0(runs, world)[0][0]
    jax_out = runs[0]
    np.testing.assert_array_equal(arrays["bd_dec"], jax_out["bd_dec"])
    assert 0 < arrays["bd_dec"].sum() < arrays["bd_dec"].size      # kept and dropped components
    assert _rel(_proj(arrays["bd_u"]), _proj(jax_out["bd_u"])) <= 1e-4
    assert _rel(arrays["bd_u"] @ arrays["bd_v"], jax_out["bd_u"] @ jax_out["bd_v"]) <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_windowed_pmd(runs, world):
    """Blocks 0-3 fill in window 0 and blocks 4-7 do not: every rank runs
    the same windows (more than one) and the result is JAX's."""
    from localmd_tpu_torch import engine

    results = _rank0(runs, world)
    arrays, meta = results[0]
    jax_out = runs[0]
    window0 = engine.windowed_pmd_batched(
        torch.as_tensor(windowed_inputs()[..., :WL].copy()),
        torch.as_tensor(_sketch((WL // TAF, W_RANK + 10))).expand(1, 8, -1, -1),
        WL, W_RANK, *W_THRESHOLDS, 1, TAF, SAF)
    assert (window0.counts[:4] == W_RANK).all() and (window0.counts[4:] < W_RANK).all()
    np.testing.assert_array_equal(arrays["win_counts"], jax_out["win_counts"])
    assert {m["windows_run"] for _, m in results} == {meta["windows_run"]}
    assert meta["windows_run"] > 1
    assert _rel(_proj(arrays["win_acc"]), _proj(jax_out["win_acc"])) <= 1e-4
    assert _rel(arrays["win_acc"] @ arrays["win_temporal"],
                jax_out["win_acc"] @ jax_out["win_temporal"]) <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_matches_jax_mesh(runs, world, case):
    arrays, meta = _rank0(runs, world)[0]
    ref = runs[0][f"pipe_{case}"]
    assert _rel(arrays[f"pipe_{case}_recon"], ref[:, :, :]) <= 1e-4
    np.testing.assert_allclose(arrays[f"pipe_{case}_var"], ref.var_img, rtol=1e-4)
    assert meta[f"pipe_{case}"]["ranks"] == ref.pipeline_ranks
    assert meta[f"pipe_{case}"]["rank"] == ref.rank


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_matches_own_single_device_and_ranks_agree(runs, world, case):
    results = _rank0(runs, world)
    arrays, meta = results[0]
    single = runs[1][f"pipe_{case}"]
    assert _rel(arrays[f"pipe_{case}_recon"], single[:, :, :]) <= 1e-5
    assert meta[f"pipe_{case}"]["ranks"] == single.pipeline_ranks
    assert meta[f"pipe_{case}"]["rank"] == single.rank
    if case == "multi_window":
        assert max(meta[f"pipe_{case}"]["windows"]["run_per_batch"]) > 1
    for other, other_meta in results[1:]:
        for key in ("recon", "panels", "r", "s", "v", "mean", "var"):
            np.testing.assert_array_equal(other[f"pipe_{case}_{key}"], arrays[f"pipe_{case}_{key}"])
        assert other_meta[f"pipe_{case}"] == meta[f"pipe_{case}"]


@pytest.mark.parametrize("world", WORLDS)
def test_volumetric_with_mesh_matches_single_device(runs, world):
    results = _rank0(runs, world)
    assert _rel(results[0][0]["volumetric"], runs[1]["volumetric"]) <= 1e-5
    if world > 1:
        assert results[0][1]["raised"]["devices_and_mesh"] == "ValueError"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["no_mesh", "short_mesh", "checkpoint", "make_mesh_n"])
def test_misconfigured_mesh_raises_before_the_statistics_pass(runs, world, case):
    """No mesh, a mesh of rank 0 alone, ``checkpoint_path`` with a mesh,
    and ``make_mesh`` for another size each raise on every rank, and no
    call reached the statistics pass."""
    for _, meta in _rank0(runs, world):
        assert meta["raised"][case] == "ValueError"
        assert meta["stats_runs"] == 0


def test_mesh_must_be_a_device_mesh():
    from localmd_tpu_torch.parallel.multihost import validate_multihost_mesh

    with pytest.raises(TypeError):
        validate_multihost_mesh(object())
    validate_multihost_mesh(None)


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
