"""Build and load the hand-written CUDA kernels (``localmd_tpu_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` for ``sm_90a`` (all
started together; K2 is split into one source per movie dtype so that no
one process holds the build), and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``localmd_tpu_torch/_build/`` (git-ignored), keyed on a
hash of the sources and flags, so a fresh checkout builds once and later
processes reuse the library. Processes that start cold together (one rank
per device) build once: the build holds an ``fcntl`` lock on
``_build/build.lock``, and the others wait on it and then load the first
one's library. ``torch.utils.cpp_extension`` is not used:
including PyTorch's headers makes a build take minutes instead of seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# K2 is one translation unit per movie dtype (each instantiates its eleven
# tile widths) beside its entry points: in one source its nvcc was the
# build's wall
V_PROJECTION_DTYPE_SOURCES = tuple(
    f"v_projection_{dt}.cu" for dt in ("f32", "u16", "i16", "u8", "i8", "f16", "bf16"))
SOURCES = ("movie_stats.cu", "v_projection.cu", *V_PROJECTION_DTYPE_SOURCES,
           "block_reconstruct.cu", "jacobi_eigh.cu")
HEADERS = ("tf32_common.cuh", "wgmma_tf32.cuh", "v_projection.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every entry point returns cudaGetLastError() as an int
SIGNATURES = {
    # x, dtype, t, P, w_hi, w_lo, cos1, sin1, nperseg, nper_pad, n_segs,
    # divisor, scale, mean, sigma, stream
    "lmd_movie_stats": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P),
    # a, d, r, bt, d_pad, bn, n_tiles, stream
    "lmd_projector_t": (_P, _I, _I, _P, _I, _I, _I, _P),
    # raw, dtype, t, d, bt, d_pad, r, bn, n_tiles, c, splits, k_chunk, ctas,
    # ws, out, stream
    "lmd_v_projection": (_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P),
    # panels, temporal, starts, tile_offsets, tile_blocks, d1, d2, b1, b2,
    # S, f, out, stream
    "lmd_block_reconstruct": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # sym, n, k, sweeps, vals, vecs, stream
    "lmd_jacobi_eigh": (_P, _I, _I, _I, _P, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; return its path. ``last_build`` records the seconds spent (in
    all, and until each source's nvcc finished) and the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills per kernel). The
    check and the build run under the build directory's lock; an ``flock``
    ends with its process, so a killed build leaves no stale lock."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"liblocalmd_kernels_{_digest()}.so")
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            last_build.update(path=path, seconds=0.0, cached=True)
            return path
        return _compile(path)


def _compile(path: str) -> str:
    """One nvcc per source, all started together, then the link into
    ``path`` (written under a temporary name and renamed)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.splitext(name)[0]}.o" for name in SOURCES]
    t0 = time.perf_counter()
    compiles = []
    for name, obj in zip(SOURCES, objs):
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, name)]
        log = open(f"{obj}.log", "w+")   # a file, not a pipe: nothing blocks on output
        compiles.append((name, cmd, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    source_seconds: dict = {}
    while len(source_seconds) < len(compiles):
        for name, _, _, proc in compiles:
            if name not in source_seconds and proc.poll() is not None:
                source_seconds[name] = time.perf_counter() - t0
        time.sleep(0.02)
    logs, failed = [], []
    for name, cmd, log, proc in compiles:
        log.seek(0)
        out = log.read()
        log.close()
        os.remove(log.name)
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        link = [_nvcc(), "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{' '.join(link)}\n{logs[-1]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)
    last_build.update(path=path, seconds=seconds, cached=False, log="".join(logs),
                      source_seconds=source_seconds)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's ``argtypes`` and ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
