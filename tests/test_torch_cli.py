"""The port's CLI, checkpoint/resume and volumetric runs
(localmd_tpu_torch/cli.py, checkpoint.py, volumetric.py): the five cases of
tests/test_cli.py with ``--device cpu`` and an injected sketch, a resumed
run that may not recompute the statistics or the block stage (it must
match the first run to 1e-6), a block stage resumed from its per-batch
parts, plane-parallel runs on a list of devices, and every .npz the port
writes loaded by the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_util import rel_fro

import localmd_tpu_torch.pipeline as port_pipeline
from localmd_tpu_torch.cli import main as cli_main
from localmd_tpu_torch.io.tiff import write_tiff
from localmd_tpu_torch.utils.random import sketch_override

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sketch(shape):
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


def _cli(args, capsys):
    with sketch_override(_sketch):
        cli_main(args + ["--device", "cpu"] if args[0] != "info" else args)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_loads(path):
    from localmd_tpu import load_decomposition

    return load_decomposition(path)


def _smooth_movie(rng, t, d1, d2, k=3):
    spatial = rng.random((d1, d2, k))
    for _ in range(4):
        spatial = 0.2 * (spatial + np.roll(spatial, 1, 0) + np.roll(spatial, -1, 0)
                         + np.roll(spatial, 1, 1) + np.roll(spatial, -1, 1))
    temporal = rng.random((k, t))
    for _ in range(3):
        temporal = 0.5 * temporal + 0.25 * (np.roll(temporal, 1, 1) + np.roll(temporal, -1, 1))
    return (np.tensordot(spatial, temporal, axes=(2, 0)) * 2000).transpose(2, 0, 1)


SMALL = ["--max-components", "4", "--background-rank", "1", "--temporal-avg-factor", "4",
         "--seed", "0"]


def test_compress_info_export_roundtrip(tmp_path, capsys):
    movie_u16 = _smooth_movie(np.random.default_rng(0), 300, 24, 24).astype(np.uint16)
    tif = str(tmp_path / "m.tif")
    write_tiff(tif, movie_u16)
    npz = str(tmp_path / "out.npz")
    out = _cli(["compress", tif, npz, "--blocks", "12", "12", "--frame-range", "300",
                "--max-components", "5", "--background-rank", "1",
                "--temporal-avg-factor", "4", "--seed", "0"], capsys)
    assert out["rank"] >= 1 and out["shape"] == [300, 24, 24]
    info = _cli(["info", npz], capsys)
    assert info["fov_shape"] == [24, 24] and info["frames"] == 300
    npy = str(tmp_path / "recon.npy")
    res = _cli(["export", npz, npy, "--frames", "0", "20"], capsys)
    rec = np.load(npy)
    assert rec.shape == (20, 24, 24) and res["shape"] == [20, 24, 24]
    assert rel_fro(rec, movie_u16[:20]) < 0.05
    # the JAX package loads the port's file and reconstructs the same frames
    jpmd = _jax_loads(npz)
    assert jpmd.rank == out["rank"]
    assert rel_fro(rec, jpmd[0:20]) <= 1e-5


@pytest.mark.parametrize("order", ["F", "C"])
def test_npz_reconstruct_frames_on_a_device_equals_the_host_path(tmp_path, order):
    """``PMDArray.from_npz(..., device=)`` reconstructs through a sparse CSR
    product on that device (what ``export`` runs); it must equal the host
    CSR path of the same file, in chunks of 512 frames and across them."""
    from localmd_tpu_torch import PMDArray, localmd_decomposition

    movie = _smooth_movie(np.random.default_rng(7), 600, 20, 24, k=2).astype(np.float32)
    npz = str(tmp_path / "d.npz")
    with sketch_override(_sketch):
        localmd_decomposition(movie, (10, 12), frame_range=600, max_components=3,
                              background_rank=1, temporal_avg_factor=4, sim_iters=10, seed=0,
                              order=order, device="cpu").to_npz(npz)
    host, dev = PMDArray.from_npz(npz, device=None), PMDArray.from_npz(npz, device="cpu")
    frames = np.r_[5:600, 0:5, 7]                 # two chunks of 512
    got = dev.reconstruct_frames(frames)
    assert got.shape == (len(frames), 20, 24) and dev._csr_dev is not None
    assert rel_fro(got.numpy(), host.reconstruct_frames(frames).numpy()) <= 1e-5
    assert rel_fro(got.numpy(), host[frames]) <= 1e-5
    dev.close()
    assert dev._csr_dev is None
    assert rel_fro(dev.reconstruct_frames([3]).numpy(), host[[3]][None]) <= 1e-5


def test_raw_binary_input(tmp_path, capsys):
    rng = np.random.default_rng(1)
    movie = (rng.random((300, 20, 20)) * 3000 + 100).astype(np.uint16)
    raw = str(tmp_path / "m.bin")
    movie.tofile(raw)
    npz = str(tmp_path / "out.npz")
    out = _cli(["compress", raw, npz, "--raw-shape", "300", "20", "20", "--raw-dtype", "uint16",
                "--blocks", "10", "10", "--frame-range", "300", "--welch-compat", "reference",
                "--no-cache-movie"] + SMALL, capsys)
    assert out["shape"] == [300, 20, 20] and out["cache"]["cached_frames"] == 0
    info = _cli(["info", npz], capsys)
    assert info["frames"] == 300 and info["fov_shape"] == [20, 20]
    assert _jax_loads(npz).shape == (300, 20, 20)


def _ckpt_args(tmp_path, out):
    return ["compress", str(tmp_path / "m.bin"), str(tmp_path / out), "--raw-shape", "280", "20",
            "20", "--blocks", "10", "10", "--frame-range", "280",
            "--checkpoint", str(tmp_path / "ck")] + SMALL


def test_checkpoint_resume(tmp_path, capsys, monkeypatch):
    """A rerun loads every stage: the statistics pass and the block stage
    are patched to raise, and the result equals the first run's."""
    from localmd_tpu_torch.loader import PMDLoader

    movie = (np.random.default_rng(2).random((280, 20, 20)) * 3000).astype(np.uint16)
    movie.tofile(str(tmp_path / "m.bin"))
    _cli(_ckpt_args(tmp_path, "a.npz"), capsys)
    for stage in ("stats", "background", "thresholds", "blocks", "projector", "v"):
        assert os.path.exists(str(tmp_path / f"ck.{stage}.npz")), stage

    def boom(*a, **k):
        raise AssertionError("a resumed stage ran")

    monkeypatch.setattr(PMDLoader, "_initialize_normalizers", boom)
    monkeypatch.setattr(port_pipeline, "window0_chunk_step", boom)
    out2 = _cli(_ckpt_args(tmp_path, "b.npz"), capsys)
    assert out2["timings_s"]["block_decomposition"] < 1.0
    a, b = np.load(str(tmp_path / "a.npz")), np.load(str(tmp_path / "b.npz"))
    np.testing.assert_allclose(b["s"], a["s"], rtol=1e-6)
    assert rel_fro(b["Vt"], a["Vt"]) <= 1e-6
    assert rel_fro(_jax_loads(str(tmp_path / "b.npz"))[:, :, :],
                   _jax_loads(str(tmp_path / "a.npz"))[:, :, :]) <= 1e-6


def test_block_stage_resumes_from_its_parts(tmp_path, monkeypatch):
    """A run killed in the block stage leaves per-batch parts; the rerun
    computes only the missing blocks and equals an uninterrupted run."""
    from localmd_tpu_torch import localmd_decomposition

    movie = _smooth_movie(np.random.default_rng(3), 280, 30, 30).astype(np.float32)
    kw = dict(frame_range=280, max_components=4, background_rank=1, temporal_avg_factor=4,
              sim_iters=15, seed=0, block_batch_size=8, device="cpu")
    with sketch_override(_sketch):
        clean = localmd_decomposition(movie, (10, 10), **kw)
    real = port_pipeline.window0_chunk_step
    calls = []

    def dies_on_the_third(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("killed")
        return real(*a, **k)

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(port_pipeline, "window0_chunk_step", dies_on_the_third)
    with sketch_override(_sketch), pytest.raises(RuntimeError, match="killed"):
        localmd_decomposition(movie, (10, 10), checkpoint_path=ck, **kw)
    parts = [f for f in os.listdir(tmp_path) if ".blocks.part" in f]
    assert len(parts) == 2
    calls.clear()
    monkeypatch.setattr(port_pipeline, "window0_chunk_step", lambda *a, **k: calls.append(1) or real(*a, **k))
    with sketch_override(_sketch):
        resumed = localmd_decomposition(movie, (10, 10), checkpoint_path=ck, **kw)
    n_blocks = resumed._blocksparse.n_blocks
    assert len(calls) == -(-(n_blocks - 16) // 8)
    assert not [f for f in os.listdir(tmp_path) if ".blocks.part" in f]
    assert resumed.pipeline_ranks == clean.pipeline_ranks
    assert rel_fro(resumed[:, :, :], clean[:, :, :]) <= 1e-6


def test_error_paths(tmp_path, capsys):
    bad = str(tmp_path / "movie.xyz")
    with open(bad, "wb") as f:
        f.write(b"not a movie")
    with pytest.raises((ValueError, OSError)):
        cli_main(["compress", bad, str(tmp_path / "o.npz"), "--frame-range", "10", "--device", "cpu"])
    short = str(tmp_path / "short.bin")
    np.zeros(100, np.uint16).tofile(short)
    with pytest.raises(ValueError):
        cli_main(["compress", short, str(tmp_path / "o.npz"), "--raw-shape", "300", "20", "20",
                  "--frame-range", "300", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_main([])
    with pytest.raises(FileNotFoundError):
        cli_main(["export", str(tmp_path / "nope.npz"), str(tmp_path / "r.npy"), "--device", "cpu"])
    some = str(tmp_path / "some.bin")
    np.zeros(10 * 20 * 20, np.uint16).tofile(some)
    with pytest.raises(SystemExit):
        cli_main(["compress", some, str(tmp_path / "o.npz"), "--raw-shape", "10", "20", "20",
                  "--z-planes", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match="fewer than n_planes"):
        cli_main(["compress", some, str(tmp_path / "o.npz"), "--raw-shape", "10", "20", "20",
                  "--z-planes", "11", "--device", "cpu"])


def test_z_planes_volumetric(tmp_path, capsys):
    rng = np.random.default_rng(4)
    t_per, d1, d2 = 280, 20, 20
    planes = [_smooth_movie(rng, t_per, d1, d2, k=2).astype(np.uint16) for _ in range(2)]
    interleaved = np.empty((2 * t_per, d1, d2), np.uint16)
    interleaved[0::2], interleaved[1::2] = planes
    raw = str(tmp_path / "stack.bin")
    interleaved.tofile(raw)
    res = _cli(["compress", raw, str(tmp_path / "vol.npz"), "--blocks", "10", "10",
                "--frame-range", "280", "--z-planes", "2", "--raw-shape", str(2 * t_per),
                str(d1), str(d2), "--raw-dtype", "uint16"] + SMALL, capsys)
    assert res["n_planes"] == 2 and res["shape"] == [t_per, 2, d1, d2]
    for z, path in enumerate(res["outputs"]):
        pmd = _jax_loads(path)
        assert pmd.shape == (t_per, d1, d2)
        rec = pmd[0:20]
        own, other = planes[z][0:20].astype(np.float32), planes[1 - z][0:20].astype(np.float32)
        assert rel_fro(rec, own) < 0.2
        assert rel_fro(rec, own) < rel_fro(rec, other)


def test_volumetric_devices_equal_the_sequential_run(tmp_path):
    """Planes on a list of devices, one thread each, equal the sequential
    run; each plane checkpoints at its own path; mesh raises."""
    from localmd_tpu_torch import ZStackArray, volumetric_decomposition

    rng = np.random.default_rng(5)
    planes = [_smooth_movie(rng, 280, 20, 20, k=2).astype(np.float32) for _ in range(3)]
    kw = dict(frame_range=280, max_components=3, background_rank=1, temporal_avg_factor=4,
              sim_iters=10, seed=0)
    with sketch_override(_sketch):
        seq = volumetric_decomposition(ZStackArray(planes), (10, 10), device="cpu", **kw)
        par = volumetric_decomposition(planes, (10, 10), devices=["cpu", "cpu"],
                                       checkpoint_path=str(tmp_path / "ck"), **kw)
    assert seq.shape == par.shape == (280, 3, 20, 20)
    assert rel_fro(par[0:10], seq[0:10]) <= 1e-6
    for z in range(3):
        assert os.path.exists(str(tmp_path / f"ck_plane{z}.v.npz"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        volumetric_decomposition(planes, (10, 10), mesh=object(), device="cpu", **kw)
    par.close()
    assert all(p._blocksparse is None for p in par.planes)


def test_module_entry_point_runs(tmp_path):
    """``python -m localmd_tpu_torch.cli`` works (``info`` needs no device)."""
    npz = str(tmp_path / "tiny.npz")
    from localmd_tpu_torch import localmd_decomposition

    movie = _smooth_movie(np.random.default_rng(6), 280, 20, 20, k=2).astype(np.float32)
    localmd_decomposition(movie, (10, 10), frame_range=280, max_components=3, background_rank=1,
                          temporal_avg_factor=4, sim_iters=10, seed=0, device="cpu").to_npz(npz)
    proc = subprocess.run([sys.executable, "-m", "localmd_tpu_torch.cli", "info", npz],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["frames"] == 280


# -- the console script ----------------------------------------------------------

def _resolve(spec):
    import importlib

    module, attr = spec.split(":")
    return getattr(importlib.import_module(module), attr)


def _setup_console_scripts():
    """``entry_points["console_scripts"]`` of setup.py's ``setup(...)`` call,
    read from its source."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "setup.py")).read())
    call = next(n for n in ast.walk(tree)
                if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "setup")
    entry_points = ast.literal_eval(next(k.value for k in call.keywords if k.arg == "entry_points"))
    return dict(s.replace(" ", "").split("=") for s in entry_points["console_scripts"])


def test_console_script_resolves_to_the_cli_main():
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["localmd-tpu-torch"] == "localmd_tpu_torch.cli:main"
    assert _resolve(scripts["localmd-tpu-torch"]) is cli_main
    # setup.py names both scripts as pyproject.toml does
    assert _setup_console_scripts() == scripts


def test_setup_finds_both_packages():
    from setuptools import find_packages

    found = set(find_packages(where=ROOT, exclude=("tests",)))
    assert {"localmd_tpu", "localmd_tpu_torch", "localmd_tpu_torch.ops"} <= found


# -- demos/demo_torch.py -----------------------------------------------------------

DEMO_SIZE = ["--d1", "40", "--d2", "36", "--t", "500"]


def _demo_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "demo_torch", os.path.join(ROOT, "demos", "demo_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The demo run once at a tiny size on the CPU, with the sketch injected
    and the thresholds pinned to the JAX package's, beside the JAX package's
    ``localmd_decomposition`` on the same sim movie with demos/demo.py's
    arguments (demo.py:39-50)."""
    import contextlib
    import io

    import jax.numpy as jnp

    import localmd_tpu.pipeline as jax_pipeline
    from localmd_tpu.ops.linalg import sketch_override as jax_sketch_override
    from localmd_tpu_torch import sim

    movie = sim.two_photon_movie(40, 36, 500, n_cells=40, seed=0, device="cpu").numpy()
    mp = pytest.MonkeyPatch()
    thresholds = []
    real = jax_pipeline.threshold_heuristic
    try:
        mp.setattr(jax_pipeline, "threshold_heuristic",
                   lambda *a, **k: thresholds.append(tuple(float(x) for x in real(*a, **k)))
                   or thresholds[-1])
        with jax_sketch_override(lambda shape: jnp.asarray(_sketch(shape))):
            ref = jax_pipeline.localmd_decomposition(
                movie, block_sizes=(32, 32), frame_range=min(5000, movie.shape[0]),
                max_components=20, background_rank=15, temporal_avg_factor=10, seed=0)
        mp.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: thresholds[0])
        out_dir = str(tmp_path_factory.mktemp("demo"))
        stdout = io.StringIO()
        with sketch_override(_sketch), contextlib.redirect_stdout(stdout):
            summary = _demo_module().main(["", out_dir, *DEMO_SIZE, "--device", "cpu",
                                           "--no-plots"])
    finally:
        mp.undo()
    return dict(movie=movie, ref=ref, summary=summary, stdout=stdout.getvalue(),
                out_dir=out_dir, thresholds=thresholds)


def test_demo_writes_the_npz_and_the_tiff(demo):
    from localmd_tpu_torch import TiffArray, load_decomposition

    summary = demo["summary"]
    assert summary["npz"] == os.path.join(demo["out_dir"], "decomposition.npz")
    pmd = load_decomposition(summary["npz"], device=None)
    assert pmd.shape == (500, 40, 36) and pmd.rank == summary["rank"]
    tif = TiffArray(summary["tiff"])
    assert tif.shape == (500, 40, 36)
    want = np.clip(np.rint(pmd[0:500]), 0, 65535)
    assert rel_fro(tif[0:500], want) <= 1e-5
    assert 0.3 < summary["residual_noise_ratio"] < 3.0
    assert set(summary["launches"]) == {"decomposition", "qc_images", "export_tiff"}


def test_demo_no_plots_skips_only_the_renderings(demo):
    assert "--no-plots: skipped the QC panel and the component browser" in demo["stdout"]
    assert not demo["summary"]["plots"]
    assert sorted(os.listdir(demo["out_dir"])) == ["decomposition.npz", "denoised.tif"]
    assert json.loads(demo["stdout"].strip().splitlines()[-1]) == json.loads(
        json.dumps(demo["summary"]))


def test_demo_matches_the_jax_decomposition(demo):
    """Equal kept ranks and the reconstruction within the pipeline bar."""
    from localmd_tpu_torch import load_decomposition

    assert len(demo["thresholds"]) == 1
    ours = load_decomposition(demo["summary"]["npz"], device=None)
    assert ours.rank == demo["ref"].rank
    assert rel_fro(ours[:, :, :], demo["ref"][:, :, :]) <= 1e-4


def test_console_script_main_reads_the_demo_npz(demo, capsys):
    """The declared entry point, called as the installed script would call
    it, on the demo's file."""
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        spec = tomllib.load(f)["project"]["scripts"]["localmd-tpu-torch"]
    _resolve(spec)(["info", demo["summary"]["npz"]])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["rank"] == demo["summary"]["rank"] and info["frames"] == 500


def test_demo_without_matplotlib_is_an_error(tmp_path, monkeypatch):
    """Without ``--no-plots`` the renderers need matplotlib: its absence
    raises, as in the JAX demo, and is never skipped quietly."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with sketch_override(_sketch), pytest.raises(ImportError):
        _demo_module().main(["", str(tmp_path), "--d1", "24", "--d2", "24", "--t", "200",
                             "--device", "cpu"])
    assert os.path.exists(str(tmp_path / "decomposition.npz"))
    assert not os.path.exists(str(tmp_path / "denoised.tif"))


def test_demo_defaults_to_the_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _demo_module().main(["", str(tmp_path)])
