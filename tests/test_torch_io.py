"""The port's TIFF module and native reader (localmd_tpu_torch/io) against the
JAX package's (localmd_tpu/io): the writers give byte-identical files from
the same frames, the port's reader reads what the JAX writer made in every
layout the JAX tests cover, and the native scatter reader (built with g++
into localmd_tpu_torch/_build/) reads what numpy reads."""

import os

import numpy as np
import pytest

import localmd_tpu.io.tiff as jax_tiff
import localmd_tpu_torch.io.tiff as port_tiff
from localmd_tpu_torch.io import native

from test_io_and_dataset import _craft_tiff

WRITES = {
    "u16": ("write_tiff", "uint16", {}),
    "f32": ("write_tiff", "float32", {}),
    "u16_multistrip": ("write_tiff", "uint16", dict(rows_per_strip=7)),
    "f32_multistrip": ("write_tiff", "float32", dict(rows_per_strip=8)),
    "stream_u16": ("write_tiff_stream", "uint16", {}),
    "stream_bigtiff_u16": ("write_tiff_stream", "uint16", dict(bigtiff=True)),
    "stream_bigtiff_f32": ("write_tiff_stream", "float32", dict(bigtiff=True)),
    "stream_bigtiff_multistrip": ("write_tiff_stream", "uint16", dict(bigtiff=True, rows_per_strip=6)),
    "lzw_p1": ("write_tiff_compressed", "uint16", dict(compression="lzw", rows_per_strip=12)),
    "lzw_p2": ("write_tiff_compressed", "uint16", dict(compression="lzw", predictor=2)),
    "deflate_p1": ("write_tiff_compressed", "uint16", dict(compression="deflate", rows_per_strip=12)),
    "deflate_p2": ("write_tiff_compressed", "uint16", dict(compression="deflate", predictor=2)),
    "deflate_f32": ("write_tiff_compressed", "float32", dict(compression="deflate")),
    "packbits": ("write_tiff_compressed", "uint16", dict(compression="packbits", rows_per_strip=12)),
    "zstd": ("write_tiff_compressed", "uint16", dict(compression="zstd")),
    "lzma": ("write_tiff_compressed", "uint16", dict(compression="lzma")),
    "none_p2": ("write_tiff_compressed", "uint16", dict(compression="none", predictor=2)),
    "tiled_deflate": ("write_tiff_compressed", "uint16", dict(compression="deflate", tile=(32, 16),
                                                               predictor=2)),
}


def _frames(dtype, shape=(5, 70, 55)):
    rng = np.random.default_rng(11)
    return (rng.random(shape) * 3000).astype(dtype)


def _write(module, name, path, movie):
    writer, _, opts = WRITES[name]
    fn = getattr(module, writer)
    if writer == "write_tiff_stream":
        fn(path, iter(movie), movie.shape, movie.dtype, **opts)
    else:
        fn(path, movie, **opts)


@pytest.mark.parametrize("name", list(WRITES))
def test_writers_are_byte_identical_and_read_back(name, tmp_path):
    movie = _frames(WRITES[name][1])
    ours, theirs = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    _write(port_tiff, name, ours, movie)
    _write(jax_tiff, name, theirs, movie)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    reader = port_tiff.TiffReader(theirs)
    np.testing.assert_array_equal(reader.read_frames(range(len(movie))), movie)
    reader.close()


def _big_endian(path, frame):
    import struct

    h, w = frame.shape
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 16), (259, 3, 1, 1),
            (273, 4, 1, 0), (278, 4, 1, h), (279, 4, 1, h * w * 2), (339, 3, 1, 1)]
    ifd_off = 8
    data_off = ifd_off + 2 + len(tags) * 12 + 4
    with open(path, "wb") as f:
        f.write(b"MM\x00\x2a" + struct.pack(">I", ifd_off) + struct.pack(">H", len(tags)))
        for tag, typ, cnt, val in tags:
            val = data_off if tag == 273 else val
            f.write(struct.pack(">HHI", tag, typ, cnt))
            f.write(struct.pack(">HH", val, 0) if typ == 3 else struct.pack(">I", val))
        f.write(struct.pack(">I", 0))
        f.write(frame.astype(">u2").tobytes())


LAYOUTS = ["big_endian", "imagej_hyperstack", "imagej_truncated", "ome", "plain_pages"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reader_reads_the_layouts_both_packages_read(layout, tmp_path):
    """tests/test_io_and_dataset.py:38-345's hand-built layouts: the port's
    reader gives the JAX reader's frames and page count."""
    movie = _frames(np.uint16, (12, 9, 7))
    path = str(tmp_path / f"{layout}.tif")
    if layout == "big_endian":
        _big_endian(path, movie[0])
        movie = movie[:1]
    elif layout == "imagej_hyperstack":
        _craft_tiff(path, movie, single_ifd=True,
                    description="ImageJ=1.54f\nimages=12\nframes=12\nunit=um\n")
    elif layout == "imagej_truncated":
        _craft_tiff(path, movie[:6], single_ifd=True, description="ImageJ=1.54f\nimages=10\n")
        movie = movie[:6]
    elif layout == "ome":
        _craft_tiff(path, movie, description='<?xml version="1.0"?><OME><Image/></OME>')
    else:
        _craft_tiff(path, movie)
    ours, theirs = port_tiff.TiffReader(path), jax_tiff.TiffReader(path)
    assert len(ours.pages) == len(theirs.pages) == len(movie)
    got = ours.read_frames(range(len(movie)))
    np.testing.assert_array_equal(got.astype(np.uint16), movie)
    np.testing.assert_array_equal(got, theirs.read_frames(range(len(movie))))
    assert ours.description == theirs.description
    ours.close()
    theirs.close()


def test_codecs_match_the_jax_codecs():
    rng = np.random.default_rng(5)
    for data in [b"", b"A", b"TOBEORNOTTOBEORTOBEORNOT",
                 rng.integers(0, 4, 30000).astype(np.uint8).tobytes()]:
        enc = port_tiff._lzw_encode(data)
        assert enc == jax_tiff._lzw_encode(data)
        assert port_tiff._lzw_decode_py(enc, len(data)) == data
        assert native.lzw_decode(enc, len(data)) == data
        pb = port_tiff._packbits_encode(data)
        assert pb == jax_tiff._packbits_encode(data)
        assert port_tiff._packbits_decode(pb, len(data)) == data


def test_unsupported_codec_names_the_fallback(tmp_path, monkeypatch):
    import builtins

    from localmd_tpu_torch.dataset import TiffArray

    path = str(tmp_path / "odd.tif")
    _craft_tiff(path, _frames(np.uint16, (2, 6, 5)), compression_id=7)
    real_import = builtins.__import__

    def no_tifffile(name, *a, **k):
        if name == "tifffile":
            raise ImportError("no tifffile")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tifffile)
    with pytest.raises(ValueError, match="tifffile"):
        TiffArray(path)


# -- the native reader (tests/test_native_io.py) ------------------------------


def test_library_is_built_under_the_port_build_dir():
    assert native.native_available()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "_build"
    )
    assert not path.startswith(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(native.__file__))), "cpp"))


def test_scatter_read(tmp_path):
    data = np.random.default_rng(1).integers(0, 255, size=(10, 64), dtype=np.uint8)
    path = str(tmp_path / "f.bin")
    data.tofile(path)
    reader = native.FastReader(path, n_threads=3)
    out = np.empty((4, 64), dtype=np.uint8)
    reader.read_scatter([0, 128, 256, 576], [64] * 4, out)
    np.testing.assert_array_equal(out, data[[0, 2, 4, 9]])
    reader.close()


def test_scatter_read_into_a_pinned_buffer_view(tmp_path):
    """The loader's use: uint16 frames straight into a tensor's numpy view."""
    import torch

    movie = np.random.default_rng(2).integers(0, 60000, size=(30, 16, 12), dtype=np.uint16)
    path = str(tmp_path / "m.bin")
    movie.tofile(path)
    buf = torch.empty((5, 16, 12), dtype=torch.uint16)
    reader = native.FastReader(path, n_threads=4)
    fb = 16 * 12 * 2
    reader.read_scatter([i * fb for i in range(7, 12)], [fb] * 5, buf.numpy().reshape(5, -1).view(np.uint8))
    np.testing.assert_array_equal(buf.numpy(), movie[7:12])
    with pytest.raises(ValueError, match="overrun"):
        reader.read_scatter([0, fb], [fb, fb], np.empty(fb, np.uint8))
    reader.close()


def test_prefetch(tmp_path):
    data = np.random.default_rng(3).integers(0, 65535, size=(20, 32), dtype=np.uint16)
    path = str(tmp_path / "f.bin")
    data.tofile(path)
    reader = native.FastReader(path)
    out = np.empty((5, 64), dtype=np.uint8)
    result = reader.prefetch([i * 64 for i in range(5)], [64] * 5, out).wait()
    np.testing.assert_array_equal(result.view(np.uint16).reshape(5, 32), data[:5])
    reader.close()


def test_bad_file():
    with pytest.raises(OSError):
        native.FastReader("/nonexistent/file.bin")


def test_tiff_uses_native_path(tmp_path):
    movie = _frames(np.uint16, (16, 40, 30))
    path = str(tmp_path / "m.tif")
    port_tiff.write_tiff(path, movie)
    reader = port_tiff.TiffReader(path)
    np.testing.assert_array_equal(reader.read_frames(list(range(16))), movie)
    assert isinstance(reader._fast_reader, native.FastReader)


def test_large_parallel_read_consistency(tmp_path):
    rng = np.random.default_rng(4)
    t, h, w = 200, 64, 48
    movie = rng.integers(0, 60000, size=(t, h, w), dtype=np.uint16)
    path = str(tmp_path / "big.bin")
    movie.tofile(path)
    frame_bytes = h * w * 2
    reader = native.FastReader(path, n_threads=8)
    idx = rng.permutation(t)[:77]
    out = np.empty((77, frame_bytes), dtype=np.uint8)
    reader.read_scatter([int(i) * frame_bytes for i in idx], [frame_bytes] * 77, out)
    np.testing.assert_array_equal(out.view(np.uint16).reshape(77, h, w), movie[idx])
    reader.close()
