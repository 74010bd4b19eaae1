"""The port's movie sources (localmd_tpu_torch/dataset.py) against the JAX
package's (localmd_tpu/dataset.py) on the same files: every source gives
exactly the JAX source's frames for int, slice, list, negative and
out-of-bounds keys, ``read_into`` (the loader's path into a staging buffer)
gives the stored frames (``NumpyArray``'s on its copy threads byte for byte
as one ``np.copyto``), and the PlaneView/ZStackArray cases of
tests/test_io_and_dataset.py:518-620 hold for the port."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import localmd_tpu.dataset as jd
import localmd_tpu_torch.dataset as pd
from localmd_tpu.io.tiff import write_tiff

SOURCES = ["numpy", "raw", "npy", "tiff", "tiff_multistrip"]
KEYS = {
    "int": 3,
    "negative_int": -1,
    "slice": slice(2, 9),
    "open_slice": slice(None, 4),
    "strided_slice": slice(1, 11, 3),
    "list": [0, 5, 2],
    "array": np.array([7, 1]),
    "range": range(3, 6),
    "spatial": (slice(0, 4), slice(2, 7), 3),
    "spatial_pair": ([1, 4], 5),
}


def _movie():
    rng = np.random.default_rng(21)
    return (rng.random((12, 9, 8)) * 60000).astype(np.uint16)


def _pair(kind, path, movie):
    """(port source, JAX source) over the same data."""
    if kind == "numpy":
        return pd.NumpyArray(movie), jd.NumpyArray(movie)
    if kind == "raw":
        movie.tofile(path)
        return (pd.RawBinaryArray(path, movie.shape, "uint16"),
                jd.RawBinaryArray(path, movie.shape, "uint16"))
    if kind == "npy":
        path = path + ".npy"
        np.save(path, movie)
        return pd.NpyArray(path), jd.NpyArray(path)
    path = path + ".tif"
    write_tiff(path, movie, rows_per_strip=4 if kind == "tiff_multistrip" else 0)
    return pd.TiffArray(path), jd.TiffArray(path)


@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("key", list(KEYS))
def test_sources_give_the_jax_frames(kind, key, tmp_path):
    movie = _movie()
    ours, theirs = _pair(kind, str(tmp_path / "m"), movie)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    got, want = ours[KEYS[key]], theirs[KEYS[key]]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", SOURCES)
def test_out_of_bounds_keys_raise_like_jax(kind, tmp_path):
    movie = _movie()
    ours, theirs = _pair(kind, str(tmp_path / "m"), movie)
    for key in (slice(0, 20), slice(13, None), (0, 1, 2, 3)):
        with pytest.raises(IndexError):
            theirs[key]
        with pytest.raises(IndexError):
            ours[key]
    for key in ([0, 12], 12):
        try:
            theirs[key]
        except (IndexError, ValueError) as e:
            with pytest.raises(type(e)):
                ours[key]


@pytest.mark.parametrize("kind", SOURCES)
def test_read_into_gives_the_stored_frames(kind, tmp_path):
    movie = _movie()
    ours, _ = _pair(kind, str(tmp_path / "m"), movie)
    raw = np.dtype(getattr(ours, "raw_dtype", None) or ours.dtype)
    for frames in (slice(2, 7), [0, 3, 11], [5]):
        ids = list(range(12))[frames] if isinstance(frames, slice) else frames
        out = np.empty((len(ids), 9, 8), raw)
        ours.read_into(frames, out)
        np.testing.assert_array_equal(out, movie[ids])


# -- NumpyArray.read_into on copy threads --------------------------------------

SPLIT_KEYS = {
    "slice": slice(0, 600),
    "offset_slice": slice(37, 551),
    "strided_slice": slice(5, 590, 3),
    "reversed_slice": slice(590, 5, -2),
    "frame_list": [int(i) for i in np.random.default_rng(8).permutation(600)[:301]],
    "negative_ids": [-1, -600, 17, -3, 250, 8, 499, -42],
}
# the casts the loader makes: (stored dtype, the stream dtype it reads into)
SPLIT_CASTS = {"u16": (np.uint16, np.uint16), "f64_f32": (np.float64, np.float32),
               "i16_f32": (np.int16, np.float32)}


def _split_movie(dtype, layout):
    """A golden-sized (600, 32, 32) movie: C-ordered, or a transposed view
    of a (32, 32, 600) array."""
    rng = np.random.default_rng(9)
    movie = (rng.standard_normal((600, 32, 32)) * 9000).astype(dtype)
    if layout == "transposed":
        movie = np.ascontiguousarray(movie.transpose(2, 1, 0)).transpose(2, 1, 0)
        assert not movie.flags.c_contiguous
    return movie


def _one_copy(movie, key, dtype):
    want = np.empty((len(np.arange(600)[key]),) + movie.shape[1:], dtype)
    np.copyto(want, movie[key], casting="unsafe")
    return want


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("cast", list(SPLIT_CASTS))
@pytest.mark.parametrize("layout", ["c_order", "transposed"])
@pytest.mark.parametrize("key", list(SPLIT_KEYS))
def test_read_into_gives_the_stored_frames_on_copy_threads(key, layout, cast, threads,
                                                           monkeypatch):
    """With the split size cut to 4 KiB a golden-sized read splits over
    ``set_io_threads`` threads; the bytes are a single ``np.copyto``'s."""
    monkeypatch.setattr(pd, "READ_SPLIT_BYTES", 1 << 12)
    stored, stream = SPLIT_CASTS[cast]
    movie = _split_movie(stored, layout)
    ours = pd.NumpyArray(movie)
    ours.set_io_threads(threads)
    want = _one_copy(movie, SPLIT_KEYS[key], stream)
    pools = []
    real = pd._copy_pool
    monkeypatch.setattr(pd, "_copy_pool", lambda n: pools.append(n) or real(n))
    out = np.full_like(want, 7)
    assert ours.read_into(SPLIT_KEYS[key], out) is out
    np.testing.assert_array_equal(out, want)
    assert out.tobytes() == want.tobytes()
    # as many threads as asked, but never more than frames or 4 KiB parts
    split = min(threads, len(want), len(want) * movie[:1].nbytes // (1 << 12))
    assert ours.read_threads(len(want)) == split
    assert pools == ([split] if split > 1 else [])


class _FaultyFrames:
    """An array whose reads of the frames starting at ``bad`` raise, each
    with its start in the message; the other reads take ``delay`` seconds."""

    def __init__(self, array, bad, delay=0.0):
        self._a, self._bad, self._delay = array, set(bad), delay
        self.dtype, self.shape = array.dtype, array.shape

    def __getitem__(self, key):
        start = key.start if isinstance(key, slice) else int(key[0])
        if start in self._bad:
            raise RuntimeError(f"part at {start}")
        time.sleep(self._delay)
        return self._a[key]


def _edge_under_split_size(ours, movie, monkeypatch, tmp_path):
    monkeypatch.setattr(pd, "_copy_pool", lambda n: pytest.fail("a small read took a pool"))
    frame_bytes = movie[0].nbytes
    n = pd.READ_SPLIT_BYTES // frame_bytes * 2 - 1      # under two parts' bytes
    assert ours.read_threads(n) == 1 and ours.read_threads(1) == 1
    for key, count in ((slice(0, n), n), ([4], 1), (slice(9, 10), 1)):
        out = np.empty((count,) + movie.shape[1:], movie.dtype)
        ours.read_into(key, out)
        np.testing.assert_array_equal(out, _one_copy(movie, key, movie.dtype))
    np.testing.assert_array_equal(ours[3], movie[3])
    np.testing.assert_array_equal(ours[0:300], movie[0:300])


def _edge_fault_in_a_part(ours, movie, monkeypatch, tmp_path):
    ours._array = _FaultyFrames(movie, bad={150, 450})  # the second and fourth of 4 parts
    out = np.zeros_like(movie)
    with pytest.raises(RuntimeError, match="part at 150"):
        ours.read_into(slice(0, 600), out)
    # every part had ended: the sound ones are written
    np.testing.assert_array_equal(out[:150], movie[:150])
    np.testing.assert_array_equal(out[300:450], movie[300:450])
    # the caller's own part fails at once; the others, slower, have ended
    # before the exception leaves read_into
    ours._array = _FaultyFrames(movie, bad={0}, delay=0.2)
    out = np.zeros_like(movie)
    with pytest.raises(RuntimeError, match="part at 0"):
        ours.read_into(slice(0, 600), out)
    np.testing.assert_array_equal(out[150:], movie[150:])


def _edge_plane_view(ours, movie, monkeypatch, tmp_path):
    """A plane of an interleaved in-memory movie reports its source's
    threads (its reads are the source's); a file source's plane one."""
    plane = pd.ZStackArray.from_interleaved(movie, 2).planes[1]
    plane.set_io_threads(3)
    assert plane.read_threads(300) == 3 and plane.read_threads(1) == 1
    out = np.empty((300, 32, 32), movie.dtype)
    plane.read_into(slice(0, 300), out)
    np.testing.assert_array_equal(out, movie[1::2])
    path = str(tmp_path / "m.bin")
    movie.tofile(path)
    raw = pd.PlaneView(pd.RawBinaryArray(path, movie.shape, "uint16"), 0, 2)
    assert raw.read_threads(300) == 1


def _edge_wrong_out_shape(ours, movie, monkeypatch, tmp_path):
    with pytest.raises(ValueError):
        ours.read_into(slice(0, 300), np.empty((600, 32, 32), movie.dtype))
    with pytest.raises(IndexError):
        ours.read_into([0, 600], np.empty((2, 32, 32), movie.dtype))


def _edge_concurrent_callers(ours, movie, monkeypatch, tmp_path):
    """More callers than cores, a short switch interval, pools made while
    others read: every read lands whole, and each thread count has one
    pool, the one every caller got."""
    monkeypatch.setattr(pd, "_COPY_POOLS", {})
    got = []
    real = pd._copy_pool
    monkeypatch.setattr(pd, "_copy_pool", lambda n: got.append((n, real(n))) or got[-1][1])
    errors = []

    def work(i):
        ds = pd.NumpyArray(movie)
        ds.set_io_threads(2 + i % 4)
        out = np.empty((400, 32, 32), np.float32)
        for _ in range(20):
            ds.read_into(slice(i, i + 400), out)
            if not np.array_equal(out, movie[i:i + 400].astype(np.float32)):
                errors.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(got) == 16 * 20
    assert {n: {id(p) for m, p in got if m == n} for n, _ in got} == \
        {n: {id(pd._COPY_POOLS[n])} for n in (2, 3, 4, 5)}
    for pool in pd._COPY_POOLS.values():
        pool.shutdown()


SPLIT_EDGES = {"under_split_size": _edge_under_split_size, "fault_in_a_part": _edge_fault_in_a_part,
               "wrong_out_shape": _edge_wrong_out_shape, "plane_view": _edge_plane_view,
               "concurrent_callers": _edge_concurrent_callers}


@pytest.mark.parametrize("edge", list(SPLIT_EDGES))
def test_read_into_copy_threads_edges(edge, monkeypatch, tmp_path):
    """Reads under the split size take one thread and no pool; the first
    failing part's exception reaches the caller after every part ended; a
    key that does not fit ``out`` raises as the single copy does; a plane
    view reports its source's threads; concurrent callers share one pool
    per thread count."""
    monkeypatch.setattr(pd, "READ_SPLIT_BYTES", 1 << 14)
    movie = _split_movie(np.uint16, "c_order")
    ours = pd.NumpyArray(movie)
    assert ours._io_threads == 4                       # the class default
    SPLIT_EDGES[edge](ours, movie, monkeypatch, tmp_path)


def test_as_dataset_accepts_paths_tensors_and_duck_types(tmp_path):
    movie = _movie()
    np.save(str(tmp_path / "m.npy"), movie)
    write_tiff(str(tmp_path / "m.tif"), movie)
    assert isinstance(pd.as_dataset(str(tmp_path / "m.npy")), pd.NpyArray)
    assert isinstance(pd.as_dataset(str(tmp_path / "m.tif")), pd.TiffArray)
    assert isinstance(pd.as_dataset(movie), pd.NumpyArray)
    assert isinstance(pd.as_dataset(torch.from_numpy(movie.astype(np.float32))), pd.DeviceMovie)
    with pytest.raises(ValueError):
        pd.as_dataset(str(tmp_path / "m.xyz"))

    class Duck:
        shape = movie.shape

        def __getitem__(self, k):
            return movie[k]

    duck = Duck()
    assert pd.as_dataset(duck) is duck
    with pytest.raises(TypeError):
        pd.as_dataset(3)
    assert pd.lazy_data_loader is pd.PMDDataset


def test_tensor_movie_indexes_like_device_movie():
    import jax.numpy as jnp

    movie = np.random.default_rng(2).standard_normal((10, 4, 5)).astype(np.float32)
    ours, theirs = pd.TensorMovie(torch.from_numpy(movie)), jd.DeviceMovie(jnp.asarray(movie))
    for key in (3, slice(2, 6), [1, 4, 9], np.array([0, -1]), range(2, 4)):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]))
    for key in ([0, 10], [-11]):
        with pytest.raises(IndexError):
            theirs[key]
        with pytest.raises(IndexError):
            ours[key]
    u16 = pd.TensorMovie(torch.from_numpy(_movie()))
    np.testing.assert_array_equal(u16[[4, 0]].numpy(), _movie()[[4, 0]])


def test_tiff_raw_dtype_and_io_threads(tmp_path):
    movie = _movie()
    path = str(tmp_path / "m.tif")
    write_tiff(path, movie)
    ours = pd.TiffArray(path)
    assert ours.raw_dtype == jd.TiffArray(path).raw_dtype == np.uint16
    ours.set_io_threads(3)
    ours[0:2]
    assert ours._reader._io_threads == 3 and ours._reader._fast_reader.n_threads == 3


# -- PlaneView / ZStackArray (tests/test_io_and_dataset.py:518-620) ------------


def test_deinterleave_matches_numpy_striding_and_jax():
    t_total, d1, d2, z_n = 23, 6, 5, 3
    movie = np.random.default_rng(3).standard_normal((t_total, d1, d2)).astype(np.float32)
    ours = pd.ZStackArray.from_interleaved(movie, z_n)
    theirs = jd.ZStackArray.from_interleaved(movie, z_n)
    assert ours.n_planes == z_n and ours.shape == theirs.shape
    for z in range(z_n):
        expect = movie[z::z_n][: t_total // z_n]
        view = ours.planes[z]
        assert view.shape == expect.shape
        for key in (slice(0, 4), [0, 2], 1, (slice(0, 3), slice(1, 4), 2)):
            np.testing.assert_array_equal(view[key], theirs.planes[z][key])
        np.testing.assert_array_equal(view[0:4], expect[0:4])


def test_plane_view_raw_dtype_passthrough_and_bounds(tmp_path):
    movie = (np.random.default_rng(4).random((20, 4, 4)) * 1000).astype(np.uint16)
    path = str(tmp_path / "m.bin")
    movie.tofile(path)
    src = pd.RawBinaryArray(path, (20, 4, 4), dtype="uint16")
    view = pd.PlaneView(src, 1, 2)
    assert view.shape == (10, 4, 4)
    np.testing.assert_array_equal(view[0:10], movie[1::2])
    out = np.empty((3, 4, 4), np.uint16)
    view.read_into([0, 4, 9], out)
    np.testing.assert_array_equal(out, movie[1::2][[0, 4, 9]])
    with pytest.raises(ValueError):
        pd.PlaneView(src, 2, 2)
    tif = str(tmp_path / "m.tif")
    write_tiff(tif, movie)
    assert pd.PlaneView(pd.TiffArray(tif), 0, 2).raw_dtype == np.uint16


def test_negative_and_oob_indices_stay_on_plane():
    t_total, z_n = 23, 3
    movie = np.random.default_rng(5).standard_normal((t_total, 4, 4)).astype(np.float32)
    stack = pd.ZStackArray.from_interleaved(movie, z_n)
    n = t_total // z_n
    for z in range(z_n):
        view = stack.planes[z]
        expect = movie[z::z_n][:n]
        np.testing.assert_array_equal(np.asarray(view[-1]), expect[-1])
        np.testing.assert_array_equal(view[[0, -1]], expect[[0, -1]])
        for key in (n, [0, n], -n - 1):
            with pytest.raises(IndexError):
                view[key]


def test_from_interleaved_validates_n_planes():
    movie = np.zeros((5, 4, 4), np.float32)
    for bad in (0, -2, 8):
        with pytest.raises(ValueError):
            pd.ZStackArray.from_interleaved(movie, bad)


def test_from_interleaved_shares_one_source(tmp_path):
    movie = (np.random.default_rng(6).random((12, 6, 6)) * 1000).astype(np.uint16)
    path = str(tmp_path / "inter.tif")
    write_tiff(path, movie)
    stack = pd.ZStackArray.from_interleaved(path, 3)
    assert len({id(p._source) for p in stack.planes}) == 1
    np.testing.assert_array_equal(stack.planes[1][0:4], movie[1::3][:4].astype(np.float32))


def test_from_interleaved_tensor_source_stays_a_tensor():
    movie = torch.from_numpy(np.random.default_rng(7).standard_normal((10, 4, 4)).astype(np.float32))
    stack = pd.ZStackArray.from_interleaved(movie, 2)
    for z, plane in enumerate(stack.planes):
        assert isinstance(plane, pd.DeviceMovie)
        np.testing.assert_array_equal(plane[0:5].numpy(), movie.numpy()[z::2])
