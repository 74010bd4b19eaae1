"""ctypes bindings for the native fastio library (threaded scatter reads).

A copy of localmd_tpu/io/native.py. ``csrc/fastio.cpp`` is built with
``g++`` at first use into ``localmd_tpu_torch/_build/`` (git-ignored),
keyed on a hash of the source and flags like the CUDA kernels
(``ops/_build.py``), and exposes :class:`FastReader`. Callers check
``native_available()`` and take the numpy/mmap path when it is False.

``FastReader.read_scatter(offsets, sizes, out)`` writes into any
C-contiguous numpy array; the loader gives it the numpy view of a pinned
staging buffer, so a frame chunk goes from disk into pinned memory with no
extra host copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "csrc", "fastio.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libfastio_{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    """Compile ``csrc/fastio.cpp`` unless the library for its hash exists;
    None when g++ is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        so = _build()
        try:
            lib = ctypes.CDLL(so) if so else None
        except OSError:
            lib = None
        if lib is None:
            _LIB_FAILED = True
            return None
        i64 = ctypes.c_int64
        p64 = ctypes.POINTER(ctypes.c_int64)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        lib.fastio_open.argtypes = [ctypes.c_char_p]
        lib.fastio_open.restype = i64
        lib.fastio_close.argtypes = [i64]
        lib.fastio_close.restype = i64
        lib.fastio_read_scatter.argtypes = [i64, p64, p64, i64, pu8, i64, i64]
        lib.fastio_read_scatter.restype = i64
        lib.fastio_prefetch_submit.argtypes = [i64, p64, p64, i64, pu8, i64, i64]
        lib.fastio_prefetch_submit.restype = i64
        lib.fastio_prefetch_wait.argtypes = [i64]
        lib.fastio_prefetch_wait.restype = i64
        lib.fastio_lzw_decode.argtypes = [pu8, i64, pu8, i64]
        lib.fastio_lzw_decode.restype = i64
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def lzw_decode(data: bytes, expected_bytes: int) -> Optional[bytes]:
    """TIFF-variant LZW decode via the native library; None if unavailable
    (callers fall back to the pure-Python decoder in ``io.tiff``)."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(expected_bytes, dtype=np.uint8)
    n = lib.fastio_lzw_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(src),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        expected_bytes,
    )
    if n < 0:
        raise ValueError(f"LZW decode failed (rc={n})")
    return dst[:n].tobytes()


class FastReader:
    """Threaded positioned reads of equal-or-variable-size records."""

    def __init__(self, path: str, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("fastio native library unavailable")
        self._lib = lib
        self._handle = lib.fastio_open(path.encode())
        if self._handle < 0:
            raise OSError(-self._handle, f"fastio_open failed for {path}")
        self.n_threads = n_threads

    def close(self):
        if getattr(self, "_handle", -1) >= 0:
            self._lib.fastio_close(self._handle)
            self._handle = -1

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def _prep(self, offsets: Sequence[int], sizes: Sequence[int], out: np.ndarray):
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        szs = np.ascontiguousarray(sizes, dtype=np.int64)
        if not out.flags.c_contiguous:
            raise ValueError("output buffer must be C-contiguous")
        if len(offs) != len(szs):
            raise ValueError("offsets/sizes length mismatch")
        stride = out.strides[0] if out.ndim > 1 else (szs[0] if len(szs) else 0)
        if len(szs) and (szs > stride).any():
            raise ValueError("record size exceeds output stride")
        if len(szs) and (len(szs) - 1) * stride + szs[-1] > out.nbytes:
            raise ValueError("records overrun the output buffer")
        return (
            offs,
            szs,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            szs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(stride),
        )

    def read_scatter(self, offsets, sizes, out: np.ndarray) -> np.ndarray:
        """Read record i from byte offset offsets[i] (sizes[i] bytes) into
        row i of ``out`` (first-axis stride apart). Blocking."""
        offs, szs, offs_p, szs_p, out_p, stride = self._prep(offsets, sizes, out)
        rc = self._lib.fastio_read_scatter(
            self._handle, offs_p, szs_p, len(offs), out_p, stride, self.n_threads
        )
        if rc != 0:
            raise OSError(-rc, "fastio_read_scatter failed")
        return out

    def prefetch(self, offsets, sizes, out: np.ndarray) -> "PrefetchTicket":
        """Start an async scatter read; returns a ticket to wait on. The
        ``out`` buffer must stay alive until the ticket is waited."""
        offs, szs, offs_p, szs_p, out_p, stride = self._prep(offsets, sizes, out)
        ticket = self._lib.fastio_prefetch_submit(
            self._handle, offs_p, szs_p, len(offs), out_p, stride, self.n_threads
        )
        if ticket < 0:
            raise OSError(-ticket, "fastio_prefetch_submit failed")
        return PrefetchTicket(self._lib, ticket, out)


class PrefetchTicket:
    def __init__(self, lib, ticket: int, out: np.ndarray):
        self._lib = lib
        self._ticket = ticket
        self._out = out
        self._done = False

    def wait(self) -> np.ndarray:
        if not self._done:
            rc = self._lib.fastio_prefetch_wait(self._ticket)
            self._done = True
            if rc != 0:
                raise OSError(-rc, "fastio prefetch failed")
        return self._out
