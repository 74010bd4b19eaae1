"""The port stands alone: no module under localmd_tpu_torch/ imports jax or
the localmd_tpu package (checked on the source, since sys.modules proves
nothing where jax is pre-imported), none imports matplotlib at its top (the
machine with the card has none), the CUDA wrappers raise on a non-CPU
tensor they cannot launch on rather than falling back, and every entry
point runs on the card unless it is given ``device="cpu"``."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "localmd_tpu_torch")
# the scripts that drive the port on the card, where jax is not installed,
# and the numpy-only case tables chip_smoke.py phases 14, 15 and 16 read from
# tests/
SCRIPTS = ("chip_smoke.py", "bench_torch.py", "kernel_variants.py", "demos/demo_torch.py",
           "tests/torch_parity_cases.py", "tests/torch_parity_full.py",
           "tests/torch_parity_cells.py")
PARITY_CASES = os.path.join(ROOT, "tests", "torch_parity_cases.py")
PARITY_FULL = os.path.join(ROOT, "tests", "torch_parity_full.py")
PARITY_CELLS = os.path.join(ROOT, "tests", "torch_parity_cells.py")
FORBIDDEN = ("jax", "jaxlib", "localmd_tpu")


def _py_files():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_package_has_the_ported_modules():
    names = {os.path.relpath(p, PKG) for p in _py_files()}
    for mod in [
        "__init__.py", "config.py", "utils/random.py", "ops/tiling.py", "ops/pooling.py",
        "ops/roughness.py", "ops/noise.py", "ops/linalg.py", "ops/kernels.py", "ops/_build.py",
        "dataset.py", "loader.py", "engine.py", "blocksparse.py", "factorization.py",
        "pipeline.py", "pmd_array.py", "serialization.py", "checkpoint.py", "volumetric.py",
        "cli.py", "io/__init__.py", "io/tiff.py", "io/native.py", "utils/device.py",
        "metrics.py", "sim.py", "diagnostics.py", "diagnostic_plots.py", "compat.py",
        "decomposition.py", "evaluation.py", "preprocessing_utils.py", "pmd_loader.py",
        "pmdarray.py", "utils/keys.py", "parallel/__init__.py", "parallel/mesh.py",
        "parallel/multihost.py", "parallel/sharded.py",
    ]:
        assert mod in names, mod
    from localmd_tpu_torch.ops import _build

    for src in ("movie_stats.cu", "v_projection.cu", "block_reconstruct.cu", "jacobi_eigh.cu",
                "fastio.cpp", *_build.SOURCES, *_build.HEADERS):
        assert os.path.exists(os.path.join(PKG, "csrc", src)), src


def test_native_reader_builds_from_the_port_source_into_its_build_dir():
    """io/native.py compiles the port's own csrc/fastio.cpp into
    localmd_tpu_torch/_build/, never the JAX package's cpp/libfastio.so."""
    from localmd_tpu_torch.io import native

    assert native.SRC == os.path.join(PKG, "csrc", "fastio.cpp")
    assert native.BUILD_DIR == os.path.join(PKG, "_build")
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert "cpp" not in os.path.relpath(native.library_path(), ROOT).split(os.sep)[:1]


@pytest.mark.parametrize(
    "path", sorted(_py_files()) + [os.path.join(ROOT, s) for s in SCRIPTS],
    ids=lambda p: os.path.relpath(p, PKG if p.startswith(PKG + os.sep) else ROOT),
)
def test_module_imports_no_jax(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_parity_cases_import_only_numpy():
    """chip_smoke.py phase 14 and the JAX fixture generator read
    tests/torch_parity_cases.py: numpy and nothing else (no jax, torch or
    conftest, which imports jax), wherever in the module."""
    assert set(_imported_roots(PARITY_CASES)) == {"numpy"}


def test_full_width_cases_import_only_numpy_and_the_case_table():
    """chip_smoke.py phase 15 reads tests/torch_parity_full.py on the
    machine with the card: numpy and tests/torch_parity_cases.py, nothing
    else (no jax, no localmd_tpu, no torch), wherever in the module."""
    assert set(_imported_roots(PARITY_FULL)) == {"numpy", "torch_parity_cases"}


def test_cell_cases_import_only_numpy_the_standard_library_and_the_case_tables():
    """chip_smoke.py phase 16 reads tests/torch_parity_cells.py on the
    machine with the card: numpy, the standard library and the two case
    tables, nothing else (no jax, no localmd_tpu, no torch), wherever in
    the module."""
    assert set(_imported_roots(PARITY_CELLS)) == {
        "numpy", "torch_parity_cases", "torch_parity_full", "hashlib", "os", "shutil", "time",
        "concurrent"}


def test_chip_smoke_reads_the_parity_cases_and_nothing_of_jax():
    """Phases 14, 15 and 16 import the case tables from tests/ and neither
    jax nor the JAX package, nor the generators that need them, in any
    function."""
    roots = set(_imported_roots(os.path.join(ROOT, "chip_smoke.py")))
    assert {"torch_parity_cases", "torch_parity_full", "torch_parity_cells"} <= roots
    assert not roots & set(FORBIDDEN)
    assert not roots & {"generate_torch_parity", "generate_torch_parity_full",
                        "generate_torch_parity_cells"}


def _top_level_imports(path):
    """Roots imported by the module's own top-level statements (not inside
    a function or class body)."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(_py_files()) + [os.path.join(ROOT, s) for s in SCRIPTS],
    ids=lambda p: os.path.relpath(p, PKG if p.startswith(PKG + os.sep) else ROOT),
)
def test_module_imports_no_matplotlib_at_its_top(path):
    assert "matplotlib" not in set(_top_level_imports(path))


def test_pipeline_reads_only_the_loaders_public_names():
    """The pipeline reaches the loader only through its public methods and
    attributes: no ``load_obj._<name>`` anywhere in ``pipeline.py`` (the
    movie cache, its OOM retry, the V regression's route and the call's
    record are the loader's own)."""
    path = os.path.join(PKG, "pipeline.py")
    tree = ast.parse(open(path).read(), filename=path)
    private = sorted({node.attr for node in ast.walk(tree)
                      if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                      and node.value.id == "load_obj" and node.attr.startswith("_")})
    assert private == []


def test_no_mesh_leaves_dtensor_unimported():
    """``import localmd_tpu_torch`` and a decomposition without a mesh, at
    golden size on the CPU, never import ``torch.distributed.tensor``
    (seconds of a cold process on the card): ``parallel`` is imported only
    in the mesh branches, and imports DTensor only where it builds
    placements."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import numpy as np\n"
        "import localmd_tpu_torch\n"
        "after_import = 'torch.distributed.tensor' in sys.modules\n"
        "movie = np.random.default_rng(0).standard_normal((600, 40, 36)).astype(np.float32)\n"
        "pmd = localmd_tpu_torch.localmd_decomposition(\n"
        "    movie, (20, 20), frame_range=600, max_components=5, background_rank=2,\n"
        "    sim_iters=20, seed=0, aot_warm=True, device='cpu')\n"
        "print(after_import, 'torch.distributed.tensor' in sys.modules, pmd.rank > 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=240, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False False True", out.stdout[-2000:]


def test_importing_the_package_loads_no_matplotlib():
    import subprocess
    import sys

    code = "import sys, localmd_tpu_torch; print('matplotlib' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "False", out.stderr


K2_DTYPE_SOURCES = tuple(f"v_projection_{dt}.cu"
                         for dt in ("f32", "u16", "i16", "u8", "i8", "f16", "bf16"))


def test_kernel_build_targets_sm90a():
    """Every kernel source is built for sm_90a; K2 is its entry points'
    source plus one translation unit per movie dtype, all in the digest."""
    from localmd_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert set(_build.SOURCES) == {
        "movie_stats.cu", "v_projection.cu", "block_reconstruct.cu", "jacobi_eigh.cu",
        *K2_DTYPE_SOURCES,
    }
    assert len(_build.SOURCES) == len(set(_build.SOURCES)) == 11
    assert "v_projection.cuh" in _build.HEADERS


@pytest.mark.parametrize("dtype_source", K2_DTYPE_SOURCES)
def test_k2_dtype_sources_instantiate_their_own_dtype(dtype_source):
    """Each of K2's dtype sources defines, from the shared header, the
    dispatch of the one dtype its file name says, and the entry point sends
    that dtype's code (``kernels._DTYPE_CODES``) to it."""
    import re

    from localmd_tpu_torch.ops import kernels

    text = open(os.path.join(PKG, "csrc", dtype_source)).read()
    defined = re.findall(r"LMD_VP_DEFINE_DISPATCH\((\w+), (\w+)\)", text)
    assert '#include "v_projection.cuh"' in text and len(defined) == 1
    name, ctype = defined[0]
    short = {"float32": "f32", "uint16": "u16", "int16": "i16", "uint8": "u8", "int8": "i8",
             "float16": "f16", "bfloat16": "bf16"}[name]
    assert dtype_source == f"v_projection_{short}.cu"
    assert ctype == {"float32": "float", "float16": "__half",
                     "bfloat16": "__nv_bfloat16"}.get(name, f"{name}_t")
    entry = open(os.path.join(PKG, "csrc", "v_projection.cu")).read()
    code = kernels._DTYPE_CODES[getattr(torch, name)]
    assert re.findall(r"LMD_VP_DTYPE\((\d), (\w+)\)", entry).count((str(code), name)) == 1
    header = open(os.path.join(PKG, "csrc", "v_projection.cuh")).read()
    assert f"cudaError_t dispatch_{name}(LMD_VP_DISPATCH_PARAMS);" in header



def test_build_compiles_each_source_at_once_then_links(tmp_path, monkeypatch):
    """One nvcc per source, all started before any is waited on, then one
    link into the shared library (a stand-in nvcc records the calls)."""
    from localmd_tpu_torch.ops import _build

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    path = _build.build()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(_build.SOURCES) == 11
    # every listed source exactly once
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == sorted(_build.SOURCES)
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert calls[-1].startswith("-shared -o ") and os.path.exists(path)
    assert sorted(os.listdir(tmp_path / "build")) == sorted([os.path.basename(path), "build.lock"])
    assert set(_build.last_build["source_seconds"]) == set(_build.SOURCES)
    assert _build.build() == path and _build.last_build["cached"]


def test_processes_starting_cold_together_build_once(tmp_path):
    """Two processes call ``build()`` on an empty build directory at once
    (a stand-in nvcc takes a second a call): one compiles, the other waits
    on the lock and loads its library."""
    import subprocess
    import sys

    from localmd_tpu_torch.ops import _build

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "sleep 1\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done\n'
    )
    fake.chmod(0o755)
    code = (
        "from localmd_tpu_torch.ops import _build\n"
        f"_build._nvcc = lambda: {str(fake)!r}\n"
        f"_build.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        "print(_build.build(), _build.last_build['cached'])\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120)[0].strip().splitlines()[-1])
    finally:
        for proc in procs:
            proc.kill()
    assert all(proc.returncode == 0 for proc in procs), outs
    paths, cached = zip(*(line.split() for line in outs))
    assert paths[0] == paths[1] and sorted(cached) == ["False", "True"]
    calls = log.read_text().splitlines()
    compiled = [c.split()[-1].rsplit("/", 1)[-1] for c in calls if " -c " in f" {c} "]
    # one build: every listed source compiled exactly once, then one link
    assert sorted(compiled) == sorted(_build.SOURCES) and len(calls) == len(_build.SOURCES) + 1


@pytest.mark.parametrize("call", ["movie_stats", "v_projection", "prepare_projector",
                                  "block_reconstruct", "jacobi_eigh"])
def test_wrappers_raise_on_non_cpu_tensors_without_cuda(call):
    """A tensor off the CPU goes to the CUDA kernel or raises; the plain
    version is never taken for it (meta tensors stand in for a device
    here that has no card)."""
    from localmd_tpu_torch.ops import kernels

    meta = dict(device="meta")
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        if call == "movie_stats":
            kernels.movie_stats(torch.empty(300, 64, **meta), 300)
        elif call == "jacobi_eigh":
            kernels.jacobi_eigh(torch.empty(4, 30, 30, **meta))
        elif call == "v_projection":
            kernels.v_projection(torch.empty(8, 16, **meta), torch.empty(16, 4, **meta),
                                 torch.empty(4, **meta))
        elif call == "prepare_projector":
            kernels.prepare_projector(torch.empty(16, 4, **meta))
        else:
            kernels.block_reconstruct(
                torch.empty(1, 100, 2, **meta), torch.empty(1, 2, 5, **meta),
                torch.zeros(1, 2, dtype=torch.int32, **meta), [np.array([0])], (10, 10), (10, 10),
            )
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("entry", ["cli_compress", "cli_export", "volumetric"])
def test_cli_and_volumetric_default_to_the_card(entry, tmp_path, monkeypatch):
    """The CLI (``--device cuda`` by default) and ``volumetric_decomposition``
    raise without CUDA instead of running on the CPU."""
    from localmd_tpu_torch import volumetric_decomposition
    from localmd_tpu_torch.cli import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    movie = np.zeros((300, 20, 20), np.uint16)
    raw = str(tmp_path / "m.bin")
    movie.tofile(raw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "cli_compress":
            cli_main(["compress", raw, str(tmp_path / "o.npz"), "--raw-shape", "300", "20", "20",
                      "--frame-range", "300"])
        elif entry == "cli_export":
            cli_main(["export", str(tmp_path / "o.npz"), str(tmp_path / "r.npy")])
        else:
            volumetric_decomposition([movie], (10, 10), frame_range=300)


def test_pipeline_device_is_explicit(monkeypatch):
    from localmd_tpu_torch import localmd_decomposition

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    movie = np.zeros((300, 20, 20), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        localmd_decomposition(movie, (10, 10), frame_range=300)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        localmd_decomposition(movie, (10, 10), frame_range=300, device="cuda")


ENTRY_POINTS = ["from_reference_state", "threshold_heuristic", "load_decomposition", "from_npz",
                "reconstruction_error", "make_correlation_image", "two_photon_movie"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """The entry points that once ran on the CPU by default, and this
    slice's new ones, take the card and raise without CUDA;
    ``device="cpu"`` runs them here."""
    from localmd_tpu_torch import PMDArray, diagnostics, engine, load_decomposition, metrics, sim
    from localmd_tpu_torch.ops.tiling import BlockGrid

    grid = BlockGrid(20, 20, (10, 10))
    n, k, t = grid.n_blocks, 2, 30
    state = dict(
        panels=np.zeros((n, 100, k), np.float32), rows=grid.rows, dense_basis=np.zeros((400, 0)),
        starts=grid.starts, block_shape=(10, 10), counts=np.full(n, k), r=np.eye(n * k, 3),
        s=np.ones(3), v=np.zeros((3, t)), k2_keep=None, mean_img=np.zeros((20, 20)),
        std_img=np.ones((20, 20)),
    )
    npz = str(tmp_path / "d.npz")
    on_cpu = PMDArray.from_reference_state(state, device="cpu")
    on_cpu.to_npz(npz)
    movie = np.random.default_rng(0).standard_normal((t, 20, 20)).astype(np.float32)
    call = {
        "from_reference_state": lambda **kw: PMDArray.from_reference_state(state, **kw),
        "threshold_heuristic": lambda **kw: engine.threshold_heuristic((10, 10, t), iters=4,
                                                                       sim_batch=4, **kw),
        "load_decomposition": lambda **kw: load_decomposition(npz, **kw),
        "from_npz": lambda **kw: PMDArray.from_npz(npz, **kw),
        "reconstruction_error": lambda **kw: metrics.reconstruction_error(on_cpu, movie, **kw),
        "make_correlation_image": lambda **kw: diagnostics.make_correlation_image(movie, **kw),
        "two_photon_movie": lambda **kw: sim.two_photon_movie(20, 20, t, n_cells=3, **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, dict(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(**kwargs)
    out = call(device="cpu")
    if entry == "from_reference_state":
        assert out.shape == (t, 20, 20) and out._blocksparse.panels.device.type == "cpu"
    elif entry == "threshold_heuristic":
        assert all(np.isfinite(x) for x in out)
    elif entry in ("load_decomposition", "from_npz"):
        assert out.device.type == "cpu" and out._csr_device is not None
        assert tuple(out.reconstruct_frames([0, 3]).shape) == (2, 20, 20) and out._csr_dev is not None
    elif entry == "reconstruction_error":
        assert out["frames"] == t and np.isfinite(out["rel_error"])
    elif entry == "make_correlation_image":
        assert out.shape == (20, 20) and np.isfinite(out).all()
    else:
        assert tuple(out.shape) == (t, 20, 20) and out.device.type == "cpu"


def test_numerics_policy_has_tf32_off():
    import localmd_tpu_torch  # noqa: F401  (applies the policy)

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


ROUTES = [("engine", "COSET_STAGE", ("coset_stage_supported", "coset_stage_eligible",
                                     "coset_stage_transient_bytes", "coset_stage_plan",
                                     "window0_coset_stage")),
          ("blocksparse", "BANDED_GRAM", ("_banded_gram_quad",)),
          ("blocksparse", "COSET_VPROJ", ("coset_vproj_eligible", "build_vproj_cells",
                                          "coset_vproj_chunk"))]


@pytest.mark.parametrize("module,flag,names", ROUTES, ids=[r[1] for r in ROUTES])
def test_accelerator_routes_are_the_ports_own_and_auto_means_the_card(module, flag, names):
    """Each of the JAX package's accelerator routes has its flag, at "auto",
    and its functions in the port (whose sources the import scan above
    covers); "auto" is on for a CUDA device and off on the CPU, and a flag
    other than True, False or "auto" raises."""
    import importlib

    from localmd_tpu_torch.config import route_enabled

    mod = importlib.import_module(f"localmd_tpu_torch.{module}")
    assert getattr(mod, flag) == "auto"
    for name in names:
        assert callable(getattr(mod, name)), name
    assert route_enabled("auto", torch.device("cuda", 0)) and not route_enabled("auto", "cpu")
    assert route_enabled(True, "cpu") and not route_enabled(False, torch.device("cuda", 0))
    with pytest.raises(ValueError):
        route_enabled("yes", "cpu")
