"""The port's program spans and counters (``utils.logging.span``,
``DeviceSpans``): the loader's per-pass read and wait counters in
``pipeline_cache`` (reads split over ``NumpyArray``'s copy threads too), the ``localmd.<stage>`` spans, the cell route's
``vreg.layout`` span and the K2 route's ``vreg.k2`` span in the torch
profiler's trace, the route counters (``vreg.k2_calls``, ``vreg.cell_calls``,
``vreg.k2_width``, ``vreg.k2_frames``, ``fsvd.banded``,
``blocks.remainder``), the V prefetch's counters (``vreg.prefetched``,
``vreg.prefetch_lead_s``, ``vreg.streamed_frames``), the multi-window
block stage's ``engine.window``, ``engine.window_wait`` and
``blocks.residual`` spans and its counters
(``blocks.batches``, ``blocks.windows_run``, ``blocks.fallback``,
``blocks.residual_s``), and no span or device counter with the profiler off.

CPU tests, but for one case marked ``gpu`` that skips (in a fixture, not at
import) unless ``torch.cuda.is_available()``. Run it on a machine with the
card: ``python -m pytest -m gpu --noconftest tests/test_torch_spans.py``."""

import glob
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from localmd_tpu_torch import blocksparse, localmd_decomposition
from localmd_tpu_torch import dataset as port_dataset
from localmd_tpu_torch.dataset import NumpyArray
from localmd_tpu_torch.pipeline import STAGES
from localmd_tpu_torch.utils import logging as port_logging

SETTINGS = dict(block_sizes=(16, 16), frame_range=300, max_components=4, background_rank=1,
                sim_iters=10, seed=0)
SPAN_PREFIXES = ("localmd.", "loader.", "vreg.", "engine.", "blocks.")
BLOCK_KEYS = ("blocks.batches", "blocks.windows_run", "blocks.fallback")
PASS_KEYS = ("host_read_s", "host_read_bytes", "host_reads", "host_read_split", "slot_wait_s",
             "chunk_wait_s")


def _movie(t=600, d1=32, d2=32):
    rng = np.random.default_rng(3)
    low = (rng.standard_normal((d1 * d2, 3)) @ rng.standard_normal((3, t))).T.reshape(t, d1, d2)
    return np.clip(np.rint(low * 30 + 500 + 10 * rng.standard_normal((t, d1, d2))), 0,
                   65535).astype(np.uint16)


@pytest.fixture(scope="module")
def movie():
    return _movie()


@pytest.fixture
def cell_route(monkeypatch):
    """The V regression's cell route (``vreg.layout``'s site), off on the
    CPU by default."""
    monkeypatch.setattr(blocksparse, "COSET_VPROJ", True)


def _call(source, **kw):
    return localmd_decomposition(source, device="cpu", **{**SETTINGS, **kw})


def _factors(pmd) -> dict:
    u = pmd.u
    return dict(indptr=u.indptr, indices=u.indices, data=u.data, r=pmd.r, s=pmd.s, v=pmd.v,
                mean=pmd.mean_img, std=pmd.var_img)


def test_host_source_counts_the_statistics_pass_read(movie, cell_route):
    pmd = _call(NumpyArray(movie))
    cache = pmd.pipeline_cache
    assert cache["stats.host_read_bytes"] == movie.nbytes
    assert cache["stats.host_read_s"] > 0
    assert cache["stats.chunk_wait_s"] > 0
    assert cache["vreg.host_read_bytes"] == movie.nbytes
    assert "stats.slot_wait_s" not in cache          # no pinned ring on the CPU
    assert "vreg.layout_s" not in cache              # the profiler is off
    assert tuple(pmd.pipeline_timings) == STAGES
    assert set(pmd.pipeline_timings) == {
        "stats_and_background", "thresholds", "block_decomposition",
        "factorized_svd", "v_regression", "final_reformat",
    }


def test_device_resident_source_counts_nothing(movie, cell_route):
    pmd = _call(torch.from_numpy(movie.astype(np.float32)))
    cache = pmd.pipeline_cache
    for stage in ("stats", "crop", "background", "vreg"):
        for key in PASS_KEYS:
            assert f"{stage}.{key}" not in cache
    assert "vreg.layout_s" not in cache
    assert len(pmd.pipeline_timings) == 6


class _CountingArray(NumpyArray):
    """A ``NumpyArray`` whose ``read_into`` counts the bytes it hands out
    through ``super()``, as the benchmark's dataset does."""

    def __init__(self, array):
        super().__init__(array)
        self._lock = threading.Lock()
        self.bytes_read = 0

    def read_into(self, frames, out):
        got = super().read_into(frames, out)
        with self._lock:
            self.bytes_read += out.nbytes
        return got


@pytest.fixture(scope="module")
def split_reads(movie):
    """Two calls with the copy threads' split size cut to 4 KiB: the
    counting subclass at ``num_workers=4`` with the movie cached (the
    statistics pass reads the movie once, as the benchmark's stream cell
    does), and a plain ``NumpyArray`` at ``num_workers=1``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_dataset, "READ_SPLIT_BYTES", 1 << 12)
        counted = _CountingArray(movie)
        four = _call(counted, num_workers=4, cache_movie=True).pipeline_cache
        one = _call(NumpyArray(movie), num_workers=1).pipeline_cache
    return dict(four=four, one=one, bytes_read=counted.bytes_read)


def _split_four_workers(runs, movie):
    cache = runs["four"]
    assert cache["stats.host_reads"] >= 1
    assert cache["stats.host_read_split"] == cache["stats.host_reads"]
    assert cache["stats.host_read_bytes"] == movie.nbytes


def _split_one_worker(runs, movie):
    cache = runs["one"]
    assert cache["stats.host_reads"] >= 1
    assert cache["stats.host_read_split"] == 0 and cache["vreg.host_read_split"] == 0
    assert cache["stats.host_read_bytes"] == cache["vreg.host_read_bytes"] == movie.nbytes


def _split_k2_route_counters(runs, movie):
    # the K2 route with the profiler off: its chunks, width and frames are
    # counted, its device seconds are not; the canvas Gram (the card's
    # routes are off on the CPU) and no coset stage
    cache = runs["one"]
    assert "vreg.k2_s" not in cache
    assert cache["vreg.k2_calls"] >= 1 and cache["vreg.cell_calls"] == 0
    assert cache["vreg.k2_frames"] == movie.shape[0]
    assert cache["vreg.k2_width"] >= 1
    assert cache["fsvd.banded"] == 0 and cache["blocks.remainder"] == 0


def _split_counted_once(runs, movie):
    assert runs["bytes_read"] == movie.nbytes
    assert not [k for k in runs["four"] if k.startswith(("vreg.host", "crop.host"))]


SPLIT_CASES = {"four_workers": _split_four_workers, "one_worker": _split_one_worker,
               "counted_once": _split_counted_once, "k2_route_counters": _split_k2_route_counters}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_host_reads_are_counted(split_reads, movie, case):
    """``<pass>.host_read_split`` counts the reads ``NumpyArray`` copied on
    more than one thread: every statistics read at ``num_workers=4``, none
    at 1; the bytes stay the movie's, and a subclass that counts in
    ``read_into`` through ``super()`` counts them once."""
    SPLIT_CASES[case](split_reads, movie)


@pytest.fixture(scope="module")
def prefetch_calls():
    """Three calls on a 2600-frame movie: wholly cached, with the cache
    planned to its first 2048 frames (the free bytes set to hold 80% of
    it), and resident on the device."""
    from localmd_tpu_torch import loader as port_loader

    movie = _movie(t=2600)
    with pytest.MonkeyPatch.context() as mp:
        cached = _call(NumpyArray(movie), cache_movie=True).pipeline_cache
        free = int(0.8 * movie.nbytes / port_loader.CACHE_FRACTION)
        mp.setattr(port_loader, "device_free_bytes", lambda device, *a, **k: free)
        prefix = _call(NumpyArray(movie), cache_movie=True).pipeline_cache
    resident = _call(torch.from_numpy(movie)).pipeline_cache
    return dict(cached=cached, prefix=prefix, resident=resident, movie=movie)


def _prefetch_cached(runs):
    cache = runs["cached"]
    assert cache["cached_frames"] == cache["total_frames"] == 2600
    assert cache["vreg.prefetched"] == 0 and cache["vreg.prefetch_lead_s"] == 0.0
    assert cache["vreg.streamed_frames"] == 0


def _prefetch_prefix(runs):
    # on the CPU as on the card, start_v_prefetch opens the V pass's stream
    # (a prefetch worker, no pinned ring) before the factorized SVD
    cache, frame_bytes = runs["prefix"], runs["movie"][0].nbytes
    assert cache["cached_frames"] == 2048
    assert cache["vreg.streamed_frames"] == 2600 - 2048
    assert cache["vreg.host_read_bytes"] == (2600 - 2048) * frame_bytes
    assert cache["vreg.prefetched"] == 1 and cache["vreg.prefetch_lead_s"] > 0


def _prefetch_resident(runs):
    cache = runs["resident"]
    assert cache["cached_frames"] == 0
    assert cache["vreg.streamed_frames"] == 0 and cache["vreg.prefetched"] == 0
    assert cache["vreg.prefetch_lead_s"] == 0.0


PREFETCH_CASES = {"cached": _prefetch_cached, "prefix": _prefetch_prefix,
                  "resident": _prefetch_resident}


@pytest.mark.parametrize("case", list(PREFETCH_CASES))
def test_v_prefetch_counters(prefetch_calls, case):
    """``vreg.prefetched``, ``vreg.prefetch_lead_s`` and
    ``vreg.streamed_frames``: nothing streamed where the cache or the
    device holds every frame; the uncached tail streamed, through the
    stream opened before the factorized SVD, where the cache holds a
    prefix."""
    PREFETCH_CASES[case](prefetch_calls)


def _threads_by_span(events) -> dict:
    """{span name: set of thread ids} of the program's spans."""
    out: dict = {}
    for name, tid in events:
        if name.startswith(SPAN_PREFIXES):
            out.setdefault(name, set()).add(tid)
    return out


@pytest.mark.parametrize("how", ["profile", "profile_dir"])
def test_spans_land_in_the_profilers_trace(movie, cell_route, tmp_path, how):
    """Under ``torch.profiler.profile`` the six stage spans, the consumer's
    chunk waits and the layout copy are host events on the caller's thread;
    ``profile_dir``'s Chrome trace, which traces every thread, also has the
    prefetch worker's reads on a thread of their own."""
    if how == "profile":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pmd = _call(NumpyArray(movie))
        spans = _threads_by_span((e.name(), e.start_thread_id())
                                 for e in prof.profiler.kineto_results.events())
    else:
        pmd = _call(NumpyArray(movie), profile_dir=str(tmp_path))
        (path,) = glob.glob(str(tmp_path / "*.json"))
        with open(path) as fh:
            trace = json.load(fh)
        spans = _threads_by_span((e.get("name", ""), e.get("tid"))
                                 for e in trace["traceEvents"] if e.get("ph") == "X")
    (caller,) = spans["localmd.stats_and_background"]
    for stage in STAGES:
        assert spans[f"localmd.{stage}"] == {caller}, stage
    assert spans["vreg.layout"] == {caller}
    assert caller in spans["loader.chunk_wait"]
    if how == "profile_dir":
        assert spans["loader.host_read"] - {caller}, spans["loader.host_read"]
    assert pmd.pipeline_cache["vreg.layout_s"] > 0
    assert pmd.pipeline_cache["stats.host_read_bytes"] == movie.nbytes
    # the cell route counts its chunks and records nothing of K2's
    assert "vreg.k2" not in spans
    cache = pmd.pipeline_cache
    assert not {"vreg.k2_s", "vreg.k2_width", "vreg.k2_frames"} & set(cache)
    assert cache["vreg.k2_calls"] == 0 and cache["vreg.cell_calls"] >= 1


@pytest.fixture(scope="module")
def k2_profiled(movie):
    """One call on the K2 route (the CPU's default: the card's routes are
    off there) under the profiler: (cache, spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cache = _call(NumpyArray(movie)).pipeline_cache
    return cache, _threads_by_span((e.name(), e.start_thread_id())
                                   for e in prof.profiler.kineto_results.events())


def _k2_span(run, movie):
    cache, spans = run
    assert spans["vreg.k2"] == spans["localmd.v_regression"]      # the caller's thread
    assert 0 < cache["vreg.k2_s"]


def _k2_no_layout(run, movie):
    cache, spans = run
    assert "vreg.layout" not in spans and "vreg.layout_s" not in cache
    assert cache["vreg.k2_calls"] >= 1 and cache["vreg.cell_calls"] == 0


K2_CASES = {"span": _k2_span, "no_layout": _k2_no_layout}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_span_lands_in_the_profilers_trace(k2_profiled, movie, case):
    """On the K2 route each K2 call is a ``vreg.k2`` span on the caller's
    thread, settled into ``vreg.k2_s``; the cell route's span is absent."""
    K2_CASES[case](k2_profiled, movie)


@pytest.fixture(scope="module")
def windowed(movie):
    """One call in three 100-frame init windows with the profiler off and
    one under it: {"off": cache, "on": cache, "spans": ..., "events": ...}."""
    settings = dict(window_chunks=100)
    off = _call(NumpyArray(movie), **settings)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _call(NumpyArray(movie), **settings)
    events = [(e.name(), e.start_thread_id(), e.device_type())
              for e in prof.profiler.kineto_results.events()]
    return dict(off=dict(off.pipeline_cache), on=dict(on.pipeline_cache),
                timings=dict(on.pipeline_timings),
                spans=_threads_by_span((n, tid) for n, tid, _ in events), events=events)


def _window_spans_host_only(run):
    # one engine.window span per window run, one engine.window_wait per
    # blocking read (before each residual window), one blocks.residual per
    # residual window, all host ranges on the caller's thread
    cache, spans = run["on"], run["spans"]
    assert cache["blocks.windows_run"] == 3 * cache["blocks.batches"]
    caller = spans["localmd.block_decomposition"]
    named = {}
    for name, tid, device in run["events"]:
        if name in ("engine.window", "engine.window_wait", "blocks.residual"):
            named[name] = named.get(name, 0) + 1
            assert device == torch.autograd.DeviceType.CPU, name
    for name in named:
        assert spans[name] == caller, name
    residual = cache["blocks.windows_run"] - cache["blocks.batches"]
    assert named == {"engine.window": cache["blocks.windows_run"],
                     "engine.window_wait": residual, "blocks.residual": residual}


def _residual_seconds_only_profiled(run):
    assert "blocks.residual_s" not in run["off"]
    assert 0 < run["on"]["blocks.residual_s"] <= run["timings"]["block_decomposition"]


def _block_counters_either_way(run):
    for key in BLOCK_KEYS:
        assert run["off"][key] == run["on"][key], key
    assert run["off"]["blocks.fallback"] == 0


WINDOW_CASES = {"spans_host_only": _window_spans_host_only,
                "residual_seconds_only_profiled": _residual_seconds_only_profiled,
                "block_counters_either_way": _block_counters_either_way}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_loop_spans_and_counters(windowed, case):
    """The multi-window block stage: ``engine.window`` and
    ``engine.window_wait`` host spans, the ``blocks.residual`` device span
    settled into ``blocks.residual_s`` only while the profiler runs, and
    the block counters kept with it off and on."""
    WINDOW_CASES[case](windowed)


def test_profiler_off_enters_no_profiler_range(movie, cell_route, monkeypatch):
    """With the profiler off no span enters a range of the profiler's (the
    port's own ``_RecordFunctionFast`` or ``record_function``); with it on,
    the spans do, through the host-only range."""
    entered = []

    def counting(module, name):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            entered.append((name, args[0]))
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    counting(torch._C._profiler, "_RecordFunctionFast")
    counting(torch.autograd.profiler, "record_function")
    pmd = _call(NumpyArray(movie))
    assert entered == []
    assert "vreg.layout_s" not in pmd.pipeline_cache
    with profile(activities=[ProfilerActivity.CPU]):
        _call(NumpyArray(movie))
    names = {span for kind, span in entered if kind == "_RecordFunctionFast"}
    assert {"localmd.v_regression", "vreg.layout", "loader.chunk_wait"} <= names
    assert not [span for kind, span in entered if kind == "record_function"]


def test_factors_are_bit_identical_with_the_profiler_on(movie, cell_route):
    off = _factors(_call(NumpyArray(movie)))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _factors(_call(NumpyArray(movie)))
    for name in off:
        np.testing.assert_array_equal(np.asarray(on[name]), np.asarray(off[name]), err_msg=name)


def test_count_loses_no_update_across_threads():
    """More threads than cores adding to one record, with a short switch
    interval: every add lands."""
    counters: dict = {}
    n_threads, n_adds = 16, 2000

    def work():
        for _ in range(n_adds):
            port_logging.count(counters, "n", 1)
            with port_logging.span(counters, "s", "test.span"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counters["n"] == n_threads * n_adds
    assert counters["s"] >= 0


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "on"])
def test_device_spans_settle_only_what_the_profiler_saw(profiled):
    counters: dict = {}
    spans = port_logging.DeviceSpans(counters, "k_s", "test.device_span", torch.device("cpu"))
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                with spans.span():
                    torch.ones(64).sum()
    else:
        with spans.span():
            torch.ones(64).sum()
    spans.settle()
    assert ("k_s" in counters) is profiled
    if profiled:
        assert counters["k_s"] > 0
        before = counters["k_s"]
        spans.settle()                               # settled spans are not counted again
        assert counters["k_s"] == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_layout_span_on_the_card(cuda, monkeypatch):
    """A profiled call of a 512²×2048 uint16 movie on the card: the layout
    copy's device seconds lie inside the V regression's, the spans add no
    ``torch.cuda.synchronize`` and no event on the device's timeline."""
    g = torch.Generator(cuda).manual_seed(0)
    t, d = 2048, 512 * 512
    low = torch.randn(d, 3, generator=g, device=cuda) @ torch.randn(3, t, generator=g, device=cuda)
    noisy = low.T * 30 + 500 + 10 * torch.randn(t, d, generator=g, device=cuda)
    movie = noisy.round().clamp(0, 65535).to(torch.int32).to(torch.uint16).reshape(t, 512, 512)
    settings = dict(SETTINGS, block_sizes=(32, 32), frame_range=2048, max_components=10)
    syncs = []
    real = torch.cuda.synchronize

    def counting(*args, **kwargs):
        syncs.append(1)
        return real(*args, **kwargs)

    localmd_decomposition(movie, device=cuda, **settings)       # builds and warms
    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    plain = localmd_decomposition(movie, device=cuda, **settings)
    unprofiled = len(syncs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        del syncs[:]
        pmd = localmd_decomposition(movie, device=cuda, **settings)
        profiled = len(syncs)
    # the spans are host events only: none is projected onto the device's
    # timeline, where the device's busy time is read
    device = {e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert not {n for n in device if n.startswith(SPAN_PREFIXES)}
    assert "vreg.layout_s" not in plain.pipeline_cache
    assert 0 < pmd.pipeline_cache["vreg.layout_s"] < pmd.pipeline_timings["v_regression"]
    assert profiled <= unprofiled


@pytest.mark.gpu
def test_window_spans_on_the_card(cuda, monkeypatch):
    """A profiled call of a 256²×4000 float32 movie in four 1000-frame init
    windows on the card: the residual windows' device seconds lie inside
    the block stage's, the window spans are host events only and add no
    ``torch.cuda.synchronize``."""
    g = torch.Generator(cuda).manual_seed(1)
    t, d = 4000, 256 * 256
    low = torch.randn(d, 3, generator=g, device=cuda) @ torch.randn(3, t, generator=g, device=cuda)
    movie = (low.T * 30 + 500 + 10 * torch.randn(t, d, generator=g, device=cuda)).reshape(
        t, 256, 256)
    settings = dict(SETTINGS, block_sizes=(32, 32), frame_range=4000, window_chunks=1000,
                    max_components=10)
    syncs = []
    real = torch.cuda.synchronize

    def counting(*args, **kwargs):
        syncs.append(1)
        return real(*args, **kwargs)

    localmd_decomposition(movie, device=cuda, **settings)       # builds and warms
    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    plain = localmd_decomposition(movie, device=cuda, **settings)
    unprofiled = len(syncs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        del syncs[:]
        pmd = localmd_decomposition(movie, device=cuda, **settings)
        profiled = len(syncs)
    events = list(prof.profiler.kineto_results.events())
    device = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert not {n for n in device if n.startswith(SPAN_PREFIXES)}
    host = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CPU}
    assert {"engine.window", "engine.window_wait", "blocks.residual"} <= host
    cache = pmd.pipeline_cache
    assert "blocks.residual_s" not in plain.pipeline_cache
    assert cache["blocks.windows_run"] > cache["blocks.batches"]
    assert 0 < cache["blocks.residual_s"] < pmd.pipeline_timings["block_decomposition"]
    for key in BLOCK_KEYS:
        assert cache[key] == plain.pipeline_cache[key], key
    assert profiled <= unprofiled
