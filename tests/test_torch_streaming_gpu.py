"""Streaming on the card: the loader's pinned ring and copy stream, the
device movie cache and device slicing, against the same movie resident on
the card; an in-memory movie's copy threads against one thread.

Marked ``gpu``; each test skips (in a fixture, not at import) unless
``torch.cuda.is_available()``. Run on a machine with the card:
``python -m pytest -m gpu --noconftest tests/test_torch_streaming_gpu.py``.
The from-file loader must equal the card-resident one exactly (the same
chunks go through the same kernels); slicing holds 1e-5 relative Frobenius
against the host path."""

import gc
import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _movie(t=2100, d1=64, d2=60):
    rng = np.random.default_rng(0)
    low = (rng.standard_normal((d1 * d2, 4)) @ rng.standard_normal((4, t))).T.reshape(t, d1, d2)
    return np.clip(np.rint(low * 300 + 2000 + 40 * rng.standard_normal((t, d1, d2))), 0,
                   65535).astype(np.uint16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    movie = _movie()
    path = str(tmp_path_factory.mktemp("stream") / "m.bin")
    movie.tofile(path)
    return movie, path


def _source(kind, movie, path):
    from localmd_tpu_torch import NpyArray, RawBinaryArray, TensorMovie, TiffArray
    from localmd_tpu_torch.io.tiff import write_tiff

    if kind == "raw":
        return RawBinaryArray(path, movie.shape, "uint16")
    if kind == "npy":
        np.save(path + ".npy", movie)
        return NpyArray(path + ".npy")
    if kind == "tiff":
        write_tiff(path + ".tif", movie)
        return TiffArray(path + ".tif")
    return TensorMovie(torch.from_numpy(movie))     # a host tensor


def _u_and_p(d1, d2, device):
    from localmd_tpu_torch.blocksparse import BlockSparseMatrix
    from localmd_tpu_torch.ops.tiling import BlockGrid

    g = torch.Generator().manual_seed(3)
    grid = BlockGrid(d1, d2, (16, 16))
    u = BlockSparseMatrix(
        panels=torch.randn(grid.n_blocks, 256, 5, generator=g).to(device),
        rows=torch.as_tensor(grid.rows, dtype=torch.long, device=device), n_pixels=d1 * d2,
        dense_basis=torch.randn(d1 * d2, 2, generator=g).to(device), starts=grid.starts,
        block_shape=(16, 16), cosets=tuple(ids for ids, _ in grid.cosets()),
    )
    return u, torch.randn(u.shape[1], 7, generator=g).to(device)


@pytest.mark.parametrize("kind,cache", [("raw", False), ("raw", True), ("npy", False),
                                        ("tiff", False), ("host_tensor", False)])
def test_file_loader_equals_the_resident_loader(cuda, files, kind, cache, monkeypatch):
    import localmd_tpu_torch.loader as port_loader
    from localmd_tpu_torch.loader import PMDLoader

    movie, path = files
    # small stream chunks, so the V pass runs several copies through the ring
    monkeypatch.setattr(port_loader, "transient_budget_bytes", lambda device: 1 << 20)
    monkeypatch.setattr(port_loader, "STREAM_CHUNK_BYTES", 1 << 20)
    resident = PMDLoader(torch.from_numpy(movie).to(cuda), device=cuda, background_rank=2, seed=0,
                         np_rng=np.random.RandomState(0))
    loader = PMDLoader(_source(kind, movie, path), device=cuda, background_rank=2, seed=0,
                       np_rng=np.random.RandomState(0), num_workers=4, cache_movie=cache)
    assert loader.stream_dtype == torch.uint16
    assert loader._cache_frames == (movie.shape[0] if cache else 0)
    assert loader.transfers["pinned_copies"] >= 3
    assert torch.equal(loader.mean_img, resident.mean_img)
    assert torch.equal(loader.std_img, resident.std_img)
    assert torch.equal(loader.spatial_basis, resident.spatial_basis)
    u, p = _u_and_p(64, 60, cuda)
    copies = loader.transfers["pinned_copies"]
    assert loader.start_v_prefetch() is (not cache)
    v = loader.v_projection(u, p)
    assert torch.equal(v, resident.v_projection(u, p))
    assert (loader.transfers["pinned_copies"] > copies) is (not cache)


def test_cache_fill_waits_for_work_queued_on_the_consumer_stream(cuda, files):
    """The stats pass copies into the movie cache on the copy stream. The
    cache is allocated on the consumer's stream and may reuse a block whose
    last writer is still queued there: the copies must wait for it."""
    from localmd_tpu_torch import RawBinaryArray
    from localmd_tpu_torch.loader import PMDLoader

    movie, path = files
    torch.cuda.synchronize()
    block = torch.empty(movie.nbytes, dtype=torch.uint8, device=cuda)
    ptr = block.data_ptr()
    torch.cuda._sleep(int(2e9))          # about a second of spinning, then
    block.fill_(255)                     # a late write into the block
    del block
    loader = PMDLoader(RawBinaryArray(path, movie.shape, "uint16"), device=cuda, background_rank=0,
                       cache_movie=True)
    assert loader._cache.data_ptr() == ptr      # the cache took the freed block
    assert loader._cache_frames == movie.shape[0]
    assert torch.equal(loader._cache.cpu(), torch.from_numpy(movie))
    want = torch.from_numpy(movie.astype(np.float64).mean(axis=0)).to(cuda, torch.float32)
    assert torch.allclose(loader.mean_img, want, rtol=1e-6, atol=1e-3)


def test_abandoned_stream_releases_ring_and_chunks(cuda, files):
    from localmd_tpu_torch import RawBinaryArray
    from localmd_tpu_torch.loader import PMDLoader

    movie, path = files
    loader = PMDLoader(RawBinaryArray(path, movie.shape, "uint16"), device=cuda, background_rank=0,
                       cache_movie=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    it = loader._iter_raw_chunks(256)
    first = next(it)
    assert first.is_cuda and first.dtype == torch.uint16
    assert torch.equal(first.cpu(), torch.from_numpy(movie[:256]))
    it.close()
    del first
    it._thread.join(10)
    assert not it._thread.is_alive()
    assert it._stager is None
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base


def test_worker_thread_runs_on_the_loader_device(cuda, files):
    from localmd_tpu_torch import RawBinaryArray
    from localmd_tpu_torch.loader import PMDLoader

    movie, path = files
    loader = PMDLoader(RawBinaryArray(path, movie.shape, "uint16"), device=cuda, background_rank=0,
                       cache_movie=False)
    seen = []
    real = loader._read_into

    def spy(frames, out):
        seen.append((threading.current_thread() is not threading.main_thread(),
                     torch.cuda.current_device()))
        return real(frames, out)

    loader._read_into = spy
    chunks = list(loader._iter_raw_chunks(512))
    assert sum(c.shape[0] for c in chunks) == movie.shape[0]
    assert seen and all(worker and dev == cuda.index for worker, dev in seen)


def test_pipeline_from_file_equals_resident_and_slices(cuda, files):
    from localmd_tpu_torch import RawBinaryArray, localmd_decomposition

    movie, path = files
    kw = dict(frame_range=1000, max_components=6, background_rank=2, temporal_avg_factor=5,
              sim_iters=40, seed=0, device=cuda)
    resident = localmd_decomposition(torch.from_numpy(movie).to(cuda), (16, 16), **kw)
    on_disk = localmd_decomposition(RawBinaryArray(path, movie.shape, "uint16"), (16, 16),
                                    num_workers=4, **kw)
    assert on_disk.pipeline_cache["cached_frames"] == movie.shape[0]
    assert on_disk.pipeline_cache["pinned_copies"] > 0
    assert resident.pipeline_cache["pinned_copies"] == 0
    assert on_disk.pipeline_ranks == resident.pipeline_ranks
    frames = np.arange(0, movie.shape[0], 97)
    a, b = on_disk.reconstruct_frames(frames), resident.reconstruct_frames(frames)
    assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-5
    for key in [(slice(0, 50), slice(3, 40), slice(5, 59)), (slice(None), 10, 11),
                ([1, 5, 2099], [0, 63], [2, 59]), (7,)]:
        got, want = on_disk[key], on_disk._getitem_host(key).squeeze()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert on_disk.slice_device(slice(0, 3)).is_cuda


def test_copy_threads_equal_one_thread_through_the_ring(cuda):
    """A 512²×2048 uint16 movie in host memory, every pass streamed through
    the pinned ring (no cache): ``num_workers=4`` splits each 256 MiB piece's
    copy over four threads and gives the bits and byte counts of
    ``num_workers=1``'s single copy."""
    from localmd_tpu_torch import NumpyArray, localmd_decomposition

    g = torch.Generator(cuda).manual_seed(1)
    t, d = 2048, 512 * 512
    low = torch.randn(d, 3, generator=g, device=cuda) @ torch.randn(3, t, generator=g, device=cuda)
    noisy = low.T * 30 + 500 + 10 * torch.randn(t, d, generator=g, device=cuda)
    movie = noisy.round().clamp(0, 65535).to(torch.int32).to(torch.uint16).reshape(t, 512, 512)
    movie = movie.cpu().numpy()
    del low, noisy
    kw = dict(frame_range=2048, max_components=10, background_rank=1, sim_iters=10, seed=0,
              cache_movie=False, device=cuda)
    runs = {n: localmd_decomposition(NumpyArray(movie), (32, 32), num_workers=n, **kw)
            for n in (1, 4)}
    one, four = runs[1], runs[4]
    np.testing.assert_array_equal(np.asarray(four.mean_img), np.asarray(one.mean_img))
    np.testing.assert_array_equal(np.asarray(four.var_img), np.asarray(one.var_img))
    counts = [k for k in one.pipeline_cache
              if k.endswith(("_bytes", "_copies", ".host_reads")) or k == "cached_frames"]
    assert {"stats.host_read_bytes", "vreg.host_read_bytes", "pinned_bytes"} <= set(counts)
    assert {k: four.pipeline_cache[k] for k in counts} == {k: one.pipeline_cache[k] for k in counts}
    assert one.pipeline_cache["stats.host_read_bytes"] == movie.nbytes
    for name in ("stats", "vreg"):
        reads = one.pipeline_cache[f"{name}.host_reads"]
        assert reads >= 4
        assert one.pipeline_cache[f"{name}.host_read_split"] == 0
        assert four.pipeline_cache[f"{name}.host_read_split"] == reads


def test_checkpoint_resume_and_planes_on_the_card(cuda, files, tmp_path):
    """A resumed run equals the first; two plane threads on one card equal
    the sequential run."""
    from localmd_tpu_torch import RawBinaryArray, localmd_decomposition, volumetric_decomposition

    movie, path = files
    kw = dict(frame_range=1000, max_components=5, background_rank=2, temporal_avg_factor=5,
              sim_iters=40, seed=0)
    ck = str(tmp_path / "ck")
    src = RawBinaryArray(path, movie.shape, "uint16")
    first = localmd_decomposition(src, (16, 16), checkpoint_path=ck, device=cuda, **kw)
    again = localmd_decomposition(src, (16, 16), checkpoint_path=ck, device=cuda, **kw)
    np.testing.assert_array_equal(again.s, first.s)
    frames = np.arange(0, movie.shape[0], 211)
    assert torch.equal(again.reconstruct_frames(frames), first.reconstruct_frames(frames))
    planes = [movie[0::2][:1000], movie[1::2][:1000]]
    seq = volumetric_decomposition(planes, (16, 16), device=cuda, **dict(kw, frame_range=800))
    par = volumetric_decomposition(planes, (16, 16), devices=[cuda, cuda], **dict(kw, frame_range=800))
    for a, b in zip(seq.planes, par.planes):
        assert a.pipeline_ranks == b.pipeline_ranks
        assert torch.equal(a.reconstruct_frames(frames[:4]), b.reconstruct_frames(frames[:4]))


def test_int16_cache_prefix_equals_the_wholly_cached_call(cuda, monkeypatch):
    """A 512²×4096 int16 movie with negative samples in host memory, the
    movie cache planned to half of it (the free bytes set to the movie's,
    at the default ``cache_fraction``), against the same call with the
    movie wholly cached: the statistics pass reads the same chunks, so the
    images are equal; the V pass takes 2048 frames from the cache and
    streams the other 2048 through the stream opened before the factorized
    SVD, and gives V within 1e-5 of the wholly cached call's."""
    import localmd_tpu_torch.loader as port_loader
    from localmd_tpu_torch import NumpyArray, localmd_decomposition

    g = torch.Generator(cuda).manual_seed(2)
    t, d = 4096, 512 * 512
    low = torch.randn(d, 3, generator=g, device=cuda) @ torch.randn(3, t, generator=g, device=cuda)
    noisy = low.T * 30 + 40 + 40 * torch.randn(t, d, generator=g, device=cuda)
    movie = noisy.round().clamp(-32768, 32767).to(torch.int16).reshape(t, 512, 512).cpu().numpy()
    del low, noisy
    assert (movie < 0).mean() > 0.1
    kw = dict(frame_range=2048, max_components=10, background_rank=1, sim_iters=10, seed=0,
              num_workers=4, cache_movie=True, device=cuda)
    whole = localmd_decomposition(NumpyArray(movie), (32, 32), **kw)
    monkeypatch.setattr(port_loader, "device_free_bytes", lambda device, *a, **k: movie.nbytes)
    half = localmd_decomposition(NumpyArray(movie), (32, 32), **kw)
    assert whole.pipeline_cache["cached_frames"] == t
    cache = half.pipeline_cache
    assert (cache["cached_frames"], cache["stream_dtype"]) == (t // 2, "int16")
    assert cache["vreg.streamed_frames"] == t // 2
    assert cache["vreg.host_read_bytes"] == movie.nbytes // 2
    assert cache["vreg.prefetched"] == 1 and cache["vreg.prefetch_lead_s"] > 0
    assert whole.pipeline_cache["vreg.streamed_frames"] == 0
    np.testing.assert_array_equal(np.asarray(half.mean_img), np.asarray(whole.mean_img))
    np.testing.assert_array_equal(np.asarray(half.var_img), np.asarray(whole.var_img))
    assert half.pipeline_ranks == whole.pipeline_ranks
    v_half, v_whole = np.asarray(half.v), np.asarray(whole.v)
    assert np.linalg.norm(v_half - v_whole) <= 1e-5 * np.linalg.norm(v_whole)
