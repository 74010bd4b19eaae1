"""The port's movie sources (localmd_tpu_torch/dataset.py) against the JAX
package's (localmd_tpu/dataset.py) on the same files: every source gives
exactly the JAX source's frames for int, slice, list, negative and
out-of-bounds keys, ``read_into`` (the loader's path into a staging buffer)
gives the stored frames, and the PlaneView/ZStackArray cases of
tests/test_io_and_dataset.py:518-620 hold for the port."""

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
