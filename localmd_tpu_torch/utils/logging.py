"""Stage banners (counterpart of localmd_tpu/utils/logging.py), and the
port's program spans: ``span`` (host seconds into a counter record) and
``DeviceSpans`` (device seconds of the work a span encloses), each a range
of the torch profiler's trace while the profiler runs (``profiler_range``),
so it lands in the trace on the clock of the kernels and copies."""

from __future__ import annotations

import contextlib
import logging
import sys
import threading
import time
from typing import Optional

import torch

_LOGGER_NAME = "localmd_tpu_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s localmd_tpu_torch]: %(message)s", "%y-%m-%d %H:%M:%S"
            )
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def display(msg: str) -> None:
    """Timestamped stage banner."""
    get_logger().info(msg)


class StageTimer:
    """Context manager that logs the wall-clock duration of a pipeline stage
    (utils/logging.py:37-56)."""

    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.verbose:
            display(f"{self.name}...")
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            display(f"{self.name} done in {self.elapsed:.3f}s")
        return False


_COUNT_LOCK = threading.Lock()


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is running: the profiler's own
    process-wide flag, set while it runs whichever thread started it."""
    return torch.autograd.profiler._is_profiler_enabled


def profiler_range(name: str):
    """A range of the running profiler's trace: a host event (``cpu_op``)
    ``name`` on the thread that enters it, enclosing the launches made
    inside it. Not ``record_function``: the profiler also projects such a
    user annotation onto the device's timeline (``gpu_user_annotation``),
    where a reading of the device's busy time would count a span as work."""
    return torch._C._profiler._RecordFunctionFast(name)


def count(counters: dict, key: str, amount) -> None:
    """``counters[key] += amount`` (from 0) under one lock: the loader's
    prefetch workers count into the caller's record too."""
    with _COUNT_LOCK:
        counters[key] = counters.get(key, 0) + amount


@contextlib.contextmanager
def span(counters: Optional[dict], key: Optional[str], name: str):
    """A program span: its host seconds (``time.perf_counter``) are added
    to ``counters[key]`` (nothing is counted when either is None), and
    while the torch profiler runs it is also a ``profiler_range`` ``name``
    in the profiler's trace. The range lands in the trace when the
    profiler traces the thread the span runs on: the thread that started
    it, or every thread with ``profile_all_threads``. With the profiler
    off: two clock reads and a dict add."""
    on = profiling()
    with profiler_range(name) if on else contextlib.nullcontext():
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if counters is not None and key is not None:
                count(counters, key, time.perf_counter() - t0)


class DeviceSpans:
    """Device seconds of the work inside spans named ``name``, for a stage
    whose caller fences the device. While the profiler runs, each ``span()``
    is a ``profiler_range`` and, on the card, a pair of CUDA events
    on the device's current stream around its body (on the CPU, its host
    seconds); ``settle``, called after the caller's own fence, adds their
    seconds to ``counters[key]`` and needs no synchronize of its own. With
    the profiler off a span creates no event and the key stays absent."""

    def __init__(self, counters: dict, key: str, name: str, device: torch.device):
        self._counters = counters
        self._key = key
        self._name = name
        self._device = device
        self._pending: list = []

    @contextlib.contextmanager
    def span(self):
        if not profiling():
            yield
            return
        with profiler_range(self._name):
            if self._device.type != "cuda":
                t0 = time.perf_counter()
                yield
                self._pending.append(time.perf_counter() - t0)
                return
            stream = torch.cuda.current_stream(self._device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._pending.append((start, end))

    def settle(self) -> None:
        """Add the settled spans' seconds to the counter; every event pair
        must have completed (the caller's fence has passed)."""
        if not self._pending:
            return
        seconds = sum(p if isinstance(p, float) else p[0].elapsed_time(p[1]) / 1e3
                      for p in self._pending)
        self._pending.clear()
        count(self._counters, self._key, seconds)
