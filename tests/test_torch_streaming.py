"""Streaming in the port's loader (localmd_tpu_torch/loader.py) on the CPU:
the prefetch iterator's lifecycle (tests/test_loader.py:42-92, 401-496),
file sources against the in-memory source (``torch.equal``) and against the
JAX loader (1e-5), the V-regression prefetch handle, the movie cache
against streaming (tests/test_pipeline.py:1170), the three device-OOM
retries with ``torch.cuda.OutOfMemoryError`` raised by a monkeypatch
(tests/test_pipeline.py:1120-1165, 1536-1602), and chunk sizing from the
device's transient budget."""

import threading
import time

import numpy as np
import pytest
import torch

from _torch_util import rel_fro, to_np

import localmd_tpu_torch.loader as port_loader
from localmd_tpu_torch.blocksparse import BlockSparseMatrix
from localmd_tpu_torch.dataset import NpyArray, RawBinaryArray, TensorMovie, TiffArray
from localmd_tpu_torch.io.tiff import write_tiff
from localmd_tpu_torch.loader import PMDLoader, _PrefetchIter
from localmd_tpu_torch.ops.tiling import BlockGrid

from conftest import make_low_rank_movie

CPU = torch.device("cpu")


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")


# -- _PrefetchIter ----------------------------------------------------------------


def test_prefetch_order_preserved():
    items = list(range(20))
    assert list(_PrefetchIter(items, lambda x: x * 2)) == [x * 2 for x in items]


def test_prefetch_errors_propagate():
    def bad(x):
        if x == 3:
            raise RuntimeError("boom")
        return x

    with pytest.raises(RuntimeError, match="boom"):
        list(_PrefetchIter(range(10), bad))


def test_abandoned_iterator_stops_worker():
    produced = []

    def load(i):
        produced.append(i)
        return i

    it = _PrefetchIter(range(1000), load, depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.5)
    n = len(produced)
    assert n < 10
    time.sleep(0.3)
    assert len(produced) == n


def test_eager_start_produces_before_first_next():
    produced = []
    it = _PrefetchIter(range(3), lambda i: produced.append(i) or i, eager=True)
    deadline = time.time() + 5
    while not produced and time.time() < deadline:
        time.sleep(0.01)
    assert produced, "eager worker did not start before the first next()"
    assert list(it) == [0, 1, 2]


def test_next_after_close_raises_stopiteration():
    it = _PrefetchIter([1, 2, 3], lambda x: x, depth=1)
    assert next(it) == 1
    it.close()
    with pytest.raises(StopIteration):
        next(it)


def test_cross_thread_close_unblocks_consumer():
    release = threading.Event()

    def slow(x):
        if x > 0:
            release.wait(10)
        return x

    it = _PrefetchIter([0, 1, 2], slow, depth=1)
    assert next(it) == 0
    got = []

    def consume():
        try:
            next(it)
            got.append("item")
        except StopIteration:
            got.append("stop")

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.2)
    it.close()
    t.join(5)
    release.set()
    assert not t.is_alive()
    assert got == ["stop"]


def test_staged_chunks_close_releases_the_ring():
    """An abandoned staged stream drops its ring (the pinned buffers on the
    card) as well as its queued chunks."""

    class Ring:
        released = False

        def release(self):
            self.released = True

    ring = Ring()
    it = port_loader._StagedChunks(range(50), lambda i: (torch.zeros(2), None), ring, depth=2)
    assert next(it).shape == (2,)
    it.close()
    assert ring.released and it._stop.is_set()


# -- file sources through the loader -------------------------------------------------


def _movie():
    movie = make_low_rank_movie(3, (1100, 20, 18), rng=np.random.default_rng(8), noise=0.2)
    return np.clip(np.rint(movie * 900 + 2000), 0, 65535).astype(np.uint16)


def _sources(movie, tmp_path):
    raw = str(tmp_path / "m.bin")
    movie.tofile(raw)
    tif = str(tmp_path / "m.tif")
    write_tiff(tif, movie)
    npy = str(tmp_path / "m.npy")
    np.save(npy, movie)
    return {
        "raw": RawBinaryArray(raw, movie.shape, "uint16"),
        "tiff": TiffArray(tif),
        "npy": NpyArray(npy),
    }


def _u_and_p(d1, d2, rng):
    grid = BlockGrid(d1, d2, (10, 10))
    panels = torch.as_tensor(rng.standard_normal((grid.n_blocks, 100, 3)).astype(np.float32))
    u = BlockSparseMatrix(
        panels=panels, rows=torch.as_tensor(grid.rows, dtype=torch.long), n_pixels=d1 * d2,
        dense_basis=torch.as_tensor(rng.standard_normal((d1 * d2, 2)).astype(np.float32)),
        starts=grid.starts, block_shape=(10, 10), cosets=tuple(ids for ids, _ in grid.cosets()),
    )
    p = torch.as_tensor(rng.standard_normal((u.shape[1], 5)).astype(np.float32))
    return u, p


@pytest.fixture(scope="module")
def in_memory():
    movie = _movie()
    loader = PMDLoader(movie, device=CPU, background_rank=2, seed=0, np_rng=np.random.RandomState(0))
    u, p = _u_and_p(20, 18, np.random.default_rng(1))
    return movie, loader, u, p, loader.v_projection(u, p)


@pytest.mark.parametrize("kind", ["raw", "tiff", "npy"])
@pytest.mark.parametrize("cache", [False, True])
def test_file_sources_equal_the_in_memory_source(kind, cache, in_memory, tmp_path):
    movie, ref, u, p, v_ref = in_memory
    src = _sources(movie, tmp_path)[kind]
    loader = PMDLoader(src, device=CPU, background_rank=2, seed=0, np_rng=np.random.RandomState(0),
                       num_workers=3, cache_movie=cache)
    assert loader.stream_dtype == torch.uint16
    assert loader._cache_frames == (movie.shape[0] if cache else 0)
    assert torch.equal(loader.mean_img, ref.mean_img)
    assert torch.equal(loader.std_img, ref.std_img)
    assert torch.equal(loader.spatial_basis, ref.spatial_basis)
    assert torch.equal(loader.v_projection(u, p), v_ref)
    frames = list(range(100, 300)) + list(range(700, 800))
    got, want = loader.temporal_crop_with_filter(frames), ref.temporal_crop_with_filter(frames)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["raw", "tiff", "npy"])
def test_file_sources_match_the_jax_loader(kind, in_memory, tmp_path):
    import jax.numpy as jnp

    from localmd_tpu import dataset as jd
    from localmd_tpu.blocksparse import BlockSparseMatrix as JaxBSM
    from localmd_tpu.loader import PMDLoader as JaxLoader

    movie, _, u, p, _ = in_memory
    path = {"raw": "m.bin", "tiff": "m.tif", "npy": "m.npy"}[kind]
    src = _sources(movie, tmp_path)[kind]
    jsrc = {"raw": lambda f: jd.RawBinaryArray(f, movie.shape, "uint16"),
            "tiff": jd.TiffArray, "npy": jd.NpyArray}[kind](str(tmp_path / path))
    ours = PMDLoader(src, device=CPU, background_rank=0, num_workers=2)
    theirs = JaxLoader(jsrc, background_rank=0, num_workers=2)
    assert rel_fro(ours.mean_img, np.asarray(theirs.mean_img)) <= 1e-5
    assert rel_fro(ours.std_img, np.asarray(theirs.std_img)) <= 1e-5
    ju = JaxBSM(jnp.asarray(to_np(u.panels)), jnp.asarray(to_np(u.rows)), u.n_pixels,
                jnp.asarray(to_np(u.dense_basis)))
    v_jax = np.asarray(theirs.v_projection(ju, jnp.asarray(to_np(p))))
    assert rel_fro(ours.v_projection(u, p), v_jax) <= 1e-5


def test_v_regression_does_not_depend_on_the_chunking(in_memory, tmp_path, monkeypatch):
    movie, ref, u, p, v_ref = in_memory
    monkeypatch.setattr(port_loader, "transient_budget_bytes", lambda device: 1 << 18)
    monkeypatch.setattr(port_loader, "STREAM_CHUNK_BYTES", 1 << 16)
    loader = PMDLoader(_sources(movie, tmp_path)["raw"], device=CPU, background_rank=2, seed=0,
                       np_rng=np.random.RandomState(0))
    assert loader._stream_chunk_frames() == (1 << 18) // (20 * 18 * 4)
    chunks = [c.shape[0] for c in loader._iter_raw_chunks()]
    assert len(chunks) > 3 and sum(chunks) == movie.shape[0]
    assert rel_fro(loader.v_projection(u, p), v_ref) <= 1e-6


@pytest.mark.parametrize("budget,batch,want", [
    (1 << 29, 10 ** 7, (1 << 30) // (20 * 18 * 4)),     # the 1 GiB floor binds
    (5 << 30, 10000, 10000),                           # batch_size caps
    (5 << 30, 10 ** 7, (5 << 30) // (20 * 18 * 4)),     # the device budget binds
])
def test_stream_chunk_frames_from_the_transient_budget(budget, batch, want, monkeypatch):
    monkeypatch.setattr(port_loader, "transient_budget_bytes", lambda device: budget)
    loader = PMDLoader(np.zeros((300, 20, 18), np.float32), device=CPU, background_rank=0,
                       batch_size=batch)
    assert loader._stream_chunk_frames() == want


# -- the V-regression prefetch (tests/test_loader.py:401-496) ----------------------


@pytest.fixture()
def raw_loader(in_memory, tmp_path):
    movie, _, u, p, v_ref = in_memory
    src = _sources(movie, tmp_path)["raw"]
    return PMDLoader(src, device=CPU, background_rank=0, seed=0), u, p, v_ref, movie


def test_prefetched_v_projection_identical(raw_loader, in_memory):
    loader, u, p, _, movie = raw_loader
    base = PMDLoader(movie, device=CPU, background_rank=0, seed=0)
    v_ref = base.v_projection(u, p)
    assert loader.start_v_prefetch() is True
    assert loader.start_v_prefetch() is False          # one already pending
    v = loader.v_projection(u, p)
    assert loader._v_prefetch is None
    assert torch.equal(v, v_ref)


def test_release_cache_invalidates_pending_prefetch(raw_loader):
    loader, u, p, _, movie = raw_loader
    assert loader.start_v_prefetch() is True
    it = loader._v_prefetch["iter"]
    loader.release_cache()
    assert loader._v_prefetch is None and it._stop.is_set()
    base = PMDLoader(movie, device=CPU, background_rank=0, seed=0)
    assert torch.equal(loader.v_projection(u, p), base.v_projection(u, p))


def test_resident_or_cached_movie_skips_prefetch(in_memory):
    movie = in_memory[0]
    resident = PMDLoader(TensorMovie(torch.from_numpy(movie)), device=CPU, background_rank=0)
    assert resident._device_resident and resident.start_v_prefetch() is False
    cached = PMDLoader(movie, device=CPU, background_rank=0, cache_movie=True)
    assert cached._cache_frames == movie.shape[0] and cached.start_v_prefetch() is False
    # cache-served ranges are views of the cache, not copies
    chunk = cached._load_raw(slice(10, 50))
    assert chunk.data_ptr() == cached._cache[10].data_ptr()


# -- the movie cache and the OOM retries in the pipeline ---------------------------

KW = dict(block_sizes=(12, 12), frame_range=300, max_components=4, background_rank=2,
          temporal_avg_factor=4, sim_iters=15, seed=0, device="cpu")


@pytest.fixture(scope="module")
def clean_run():
    from localmd_tpu_torch import localmd_decomposition

    movie = make_low_rank_movie(3, (300, 24, 24), rng=np.random.default_rng(9), noise=0.1)
    return movie, localmd_decomposition(movie, cache_movie=False, **KW)


def test_cache_movie_end_to_end_identical(clean_run):
    from localmd_tpu_torch import localmd_decomposition

    movie, plain = clean_run
    cached = localmd_decomposition(movie, cache_movie=True, **KW)
    assert cached.pipeline_cache["cached_frames"] == 300
    assert plain.pipeline_cache["cached_frames"] == 0
    np.testing.assert_allclose(cached.s, plain.s, rtol=1e-5)
    np.testing.assert_allclose(cached[7], plain[7], atol=1e-5)


def test_stats_pass_oom_drops_cache_and_retries(monkeypatch):
    movie = (np.random.default_rng(10).standard_normal((300, 20, 20)) * 2 + 5).astype(np.float32)
    clean = PMDLoader(movie, device=CPU, background_rank=1, seed=0, cache_movie=False)
    calls = []
    real = PMDLoader._initialize_normalizers

    def flaky(self):
        calls.append(1)
        if len(calls) == 1:
            self._cache_building = True          # mid-build when the OOM lands
            raise _oom()
        return real(self)

    monkeypatch.setattr(PMDLoader, "_initialize_normalizers", flaky)
    loader = PMDLoader(movie, device=CPU, background_rank=1, seed=0, cache_movie=True)
    assert len(calls) == 2
    assert loader._cache is None and loader._cache_policy is False
    assert torch.equal(loader.mean_img, clean.mean_img)
    assert torch.equal(loader.std_img, clean.std_img)


@pytest.mark.parametrize("stage", ["temporal_crop_with_filter", "v_projection"])
def test_oom_drops_the_cache_and_retries(stage, clean_run, monkeypatch):
    from localmd_tpu_torch import localmd_decomposition

    movie, clean = clean_run
    calls, held = [], []
    real = getattr(PMDLoader, stage)

    def flaky(self, *a, **k):
        calls.append(1)
        held.append(self._cache is not None)
        if len(calls) == 1:
            raise _oom()
        return real(self, *a, **k)

    monkeypatch.setattr(PMDLoader, stage, flaky)
    retried = localmd_decomposition(movie, cache_movie=True, **KW)
    assert len(calls) == 2 and held == [True, False]
    assert retried.pipeline_cache["cached_frames"] == 0
    np.testing.assert_allclose(retried[:, :, :], clean[:, :, :], atol=1e-4)


def test_oom_without_cache_propagates(monkeypatch):
    from localmd_tpu_torch import localmd_decomposition

    def dead(self, *a, **k):
        raise _oom()

    monkeypatch.setattr(PMDLoader, "v_projection", dead)
    movie = make_low_rank_movie(2, (300, 24, 24), rng=np.random.default_rng(11), noise=0.1)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        localmd_decomposition(movie, cache_movie=False, **KW)


def test_non_oom_error_propagates(monkeypatch):
    import localmd_tpu_torch.pipeline as pl

    released = []
    monkeypatch.setattr(PMDLoader, "release_cache", lambda self: released.append(1))

    def broken(*a, **k):
        raise ValueError("not an OOM")

    monkeypatch.setattr(pl, "compute_lowrank_factorized_svd", broken)
    movie = make_low_rank_movie(2, (300, 24, 24), rng=np.random.default_rng(12), noise=0.1)
    with pytest.raises(ValueError, match="not an OOM"):
        pl.localmd_decomposition(movie, cache_movie=True, **KW)
    assert not released


# -- the movie-cache plan ---------------------------------------------------------


class _Source:
    """What the two loaders' cache plans read of a dataset."""

    def __init__(self, t, dtype, raw_dtype=None):
        self.shape = (t, 512, 512)
        self.dtype = np.dtype(dtype)
        if raw_dtype is not None:
            self.raw_dtype = np.dtype(raw_dtype)


class _FakeDevice:
    """What the JAX loader's cache plan reads of a device."""

    def __init__(self, limit, in_use):
        self.stats = {"bytes_limit": limit, "bytes_in_use": in_use}

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("free,reserved,allocated", [
    (70 << 30, 0, 0), (30 << 30, 40 << 30, 0), (30 << 30, 40 << 30, 16 << 30), (1 << 30, 0, 0),
    (0, 3 << 30, 1 << 30), (5 << 30, 2 << 30, 2 << 30)])
@pytest.mark.parametrize("t", [1000, 2124, 30000, 120000])
@pytest.mark.parametrize("dtype,raw_dtype", [
    ("uint16", None), ("float32", None),
    ("float32", "uint16"),      # a TIFF of uint16 read as float32: cached as uint16
    ("int16", None), ("uint8", None), ("int8", None)])   # cached at their native width
@pytest.mark.parametrize("policy", ["auto", True])
@pytest.mark.parametrize("cache_fraction", [0.5, 0.25])
def test_cache_plan_matches_jax(free, reserved, allocated, t, dtype, raw_dtype, policy,
                                cache_fraction, monkeypatch):
    """The movie-cache plan counts the caching allocator's reserved but
    unallocated bytes as free, as JAX's ``bytes_limit - bytes_in_use``
    (loader.py:535-583): a warm call in one process, whose free memory is
    what the cold call's cache left cached, plans the cold call's cache.
    Equal to JAX's own plan for the same source on a device reporting the
    same free bytes: both cache the stored dtype (the port's stream dtype),
    at the same ``cache_fraction``."""
    from localmd_tpu import loader as jl

    total = 80 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, total))
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda dev=None: {
        "reserved_bytes": {"all": {"current": reserved}},
        "allocated_bytes": {"all": {"current": allocated}}})
    ours = PMDLoader.__new__(PMDLoader)
    ours.dataset, ours.device, ours._cache_policy = _Source(t, dtype, raw_dtype), torch.device("cuda", 0), policy
    ours.shape, ours.frame_constant = ours.dataset.shape, port_loader.STATS_CHUNK_FRAMES
    ours.stream_dtype, ours._cache_fraction = ours._stream_dtype(), cache_fraction
    cached = np.dtype(str(ours.stream_dtype).removeprefix("torch."))
    assert cached == np.dtype(raw_dtype or dtype)
    ref = jl.PMDLoader.__new__(jl.PMDLoader)
    ref.dataset, ref.shape, ref._cache_policy = _Source(t, dtype, raw_dtype), (t, 512, 512), policy
    ref._cache_fraction, ref._cache_reserve_bytes = cache_fraction, int(7.5e9)
    ref.frame_constant = jl.STATS_CHUNK_FRAMES
    ref._device = _FakeDevice(total, total - (free + reserved - allocated))
    assert ours._plan_cache_frames() == ref._plan_cache_frames()


def test_cache_plan_reads_cached_blocks_as_free(monkeypatch):
    """The fault the plan had: 40 GiB the caching allocator holds unallocated
    (a cold call's cache, freed) were counted as taken, and a warm call
    cached about half as many frames of a 1024^2 x 30000 uint16 movie."""
    total = 80 << 30
    plans = []
    for free, reserved in ((70 << 30, 0), (30 << 30, 40 << 30)):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None, f=free: (f, total))
        monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda dev=None, r=reserved: {
            "reserved_bytes": {"all": {"current": r}}, "allocated_bytes": {"all": {"current": 0}}})
        loader = PMDLoader.__new__(PMDLoader)
        loader.dataset, loader.device, loader._cache_policy = (
            _Source(30000, "uint16"), torch.device("cuda", 0), "auto")
        loader.dataset.shape = (30000, 1024, 1024)
        loader.shape, loader.frame_constant = loader.dataset.shape, port_loader.STATS_CHUNK_FRAMES
        loader.stream_dtype, loader._cache_fraction = torch.uint16, port_loader.CACHE_FRACTION
        plans.append(loader._plan_cache_frames())
    assert plans[0] == plans[1] == 17408
