"""The port's device slicing, ``close`` and ``export_tiff``
(localmd_tpu_torch/pmd_array.py) against the JAX package's
(localmd_tpu/pmd_array.py:38-692), on the CPU. The port's PMDArray is
built by ``from_reference_state`` from a live JAX pipeline run, so both
hold the same factors: every key's ``pmd[key]`` (both packages' device
paths) agrees to 1e-5 relative Frobenius, with both frame-chunk budgets
forced small as well; ``export_tiff`` agrees to 1e-5 (float32) and within
one count (uint16). The close semantics follow tests/test_pipeline.py:279-335,
948-1043 and 1185."""

import numpy as np
import pytest
import torch

from _torch_util import rel_fro

import localmd_tpu.pmd_array as jax_pa
import localmd_tpu_torch.pmd_array as port_pa
from localmd_tpu_torch import PMDArray, localmd_decomposition
from localmd_tpu_torch.io.tiff import TiffReader

from conftest import make_low_rank_movie

T, D1, D2 = 300, 30, 26

KEYS = {
    "int_frame": (5,),
    "negative_frame": (-1,),
    "frame_slice_roi": (slice(10, 40), slice(3, 17), slice(5, 22)),
    "unaligned_roi": (slice(0, T), slice(7, 23), slice(1, 25)),
    "strided": (slice(-5, None), slice(None, None, 7), slice(None, None, 9)),
    "negative_rows": (slice(0, 9), slice(-12, -2), -3),
    "fancy_pairs": ([3, 17, T - 1], [5, 29], [7, 25]),
    "pixel_trace": (slice(None), 15, 15),
    "full_frame_list": ([0, 150, 299],),
    "rows_only": (slice(100, 120), slice(4, 9)),
    "ints_everywhere": (7, 3, 4),
    "frame_array": (np.array([4, 2, 9]), slice(0, 30), slice(0, 26)),
}
EMPTY_KEYS = {
    "no_frames": ([], slice(0, 5), slice(0, 5)),
    "no_rows": (slice(0, 4), slice(5, 5), slice(None)),
}


@pytest.fixture(scope="module")
def pair():
    """(JAX PMDArray, port PMDArray built from its factors on the CPU)."""
    import localmd_tpu

    movie = make_low_rank_movie(3, (T, D1, D2), rng=np.random.default_rng(4), noise=0.1)
    jpmd = localmd_tpu.localmd_decomposition(
        movie, (10, 10), frame_range=T, max_components=4, background_rank=2,
        temporal_avg_factor=4, sim_iters=15, seed=0,
    )
    u = jpmd._blocksparse
    state = dict(
        panels=np.asarray(u.panels), rows=np.asarray(u.rows), dense_basis=np.asarray(u.dense_basis),
        starts=np.asarray(u.starts), block_shape=u.block_shape, counts=np.asarray(jpmd._counts),
        r=np.asarray(jpmd._r_padded), s=np.asarray(jpmd._s_src), v=np.asarray(jpmd._v_src),
        k2_keep=jpmd._k2_keep, mean_img=jpmd.mean_img, std_img=jpmd.var_img, order=jpmd.order,
    )
    return jpmd, PMDArray.from_reference_state(state, device="cpu")


@pytest.mark.parametrize("name", list(KEYS))
def test_device_slicing_matches_jax(name, pair):
    jpmd, port = pair
    key = KEYS[name]
    want = jpmd[key]
    got = port[key]
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel_fro(got, want) <= 1e-5
    # the port's __getitem__ took the device path, not the host CSR
    assert port._blocksparse is not None and port._u_csr is None


@pytest.mark.parametrize("name", ["int_frame", "frame_slice_roi", "strided", "fancy_pairs",
                                  "pixel_trace", "negative_rows"])
def test_results_are_the_callers_to_write(name, pair):
    """A served array is the result's only host copy: writing into it
    changes neither the next request's result nor the factors."""
    jpmd, port = pair
    key = KEYS[name]
    u = port._blocksparse
    factors = [t.clone() for t in (u.panels, u.dense_basis, port._r_padded, port._v_src,
                                   port._mean_src, port._var_src)]
    first = port[key]
    want = first.copy()
    assert first.flags.writeable and first.dtype == np.float32
    first[...] = 1e9
    again = port[key]
    # a repeat on the CPU may differ in its last bits (the GEMMs' blocking
    # follows the buffers' alignment)
    assert rel_fro(again, want) <= 1e-6 and rel_fro(again, jpmd[key]) <= 1e-5
    for before, now in zip(factors, (u.panels, u.dense_basis, port._r_padded, port._v_src,
                                     port._mean_src, port._var_src)):
        assert torch.equal(before, now)


@pytest.mark.parametrize("name", ["int_frame", "unaligned_roi", "pixel_trace", "fancy_pairs"])
def test_slice_counters_count_the_pageable_requests(name, pair):
    """CPU factors take the pageable route: each request adds one to
    ``slice.pageable`` and its result's bytes to ``slice.host_bytes``,
    whatever the chunking; empty selections count nothing."""
    _, port = pair
    key = KEYS[name]
    c = port.slice_counters
    before = {k: c.get(k, 0) for k in ("slice.pageable", "slice.host_bytes", "slice.to_host_s")}
    got = [port[key] for _ in range(2)]
    port[EMPTY_KEYS["no_frames"]]
    assert c["slice.pageable"] - before["slice.pageable"] == 2
    assert c["slice.host_bytes"] - before["slice.host_bytes"] == 2 * got[0].nbytes
    assert c["slice.to_host_s"] > before["slice.to_host_s"]
    assert "slice.pinned" not in c


def test_to_host_span_lands_in_the_trace(pair):
    """``pmd.to_host`` is a host range of the profiler's trace, once per
    request; with the profiler off it is only counted."""
    from torch.profiler import ProfilerActivity, profile

    _, port = pair
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port[KEYS["int_frame"]]
        port[KEYS["unaligned_roi"]]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("pmd.to_host") == 2


@pytest.mark.parametrize("name", ["unaligned_roi", "strided", "pixel_trace"])
def test_small_budgets_chunk_both_packages_alike(name, pair, monkeypatch):
    jpmd, port = pair
    key = KEYS[name]
    monkeypatch.setattr(jax_pa, "_SLICE_CANVAS_BUDGET_BYTES", D1 * D2 * 4 * 16)
    monkeypatch.setattr(port_pa, "_SLICE_CANVAS_BUDGET_BYTES", D1 * D2 * 4 * 16)
    calls = []
    real = port.__class__._slice_device_chunk

    def counted(self, *a):
        calls.append(1)
        return real(self, *a)

    monkeypatch.setattr(port.__class__, "_slice_device_chunk", counted)
    got = port[key]
    assert len(calls) > 1 or np.atleast_1d(np.arange(T)[key[0]]).size == 1
    assert rel_fro(got, jpmd[key]) <= 1e-5


@pytest.mark.parametrize("name", list(EMPTY_KEYS))
def test_empty_selections(name, pair):
    jpmd, port = pair
    key = EMPTY_KEYS[name]
    got, want = port[key], jpmd[key]
    assert got.size == want.size == 0 and got.shape == want.shape
    dev = port.slice_device(*key)
    assert isinstance(dev, torch.Tensor) and dev.numel() == 0


def test_slice_budget_counts_the_block_product(pair, monkeypatch):
    """Each chunk's bytes count the hit blocks' (k, b1*b2) product, not the
    canvas alone: at 50% overlap that product is about four canvases. The
    canvas is the bounding box, as the JAX package's extent is."""
    jpmd, port = pair
    corners = np.asarray(port.row_indices[[0, D1 - 1], :][:, [0, D2 - 1]])
    assert port._slice_pixel_extent(corners) == jpmd._slice_pixel_extent(corners) == D1 * D2
    used = np.asarray(port.row_indices[:, :])
    per_frame = port._slice_frame_bytes(used)
    u = port._blocksparse
    assert per_frame >= 4 * (D1 * D2 + u.n_blocks * 100)
    assert u.n_blocks * 100 > 3 * D1 * D2
    monkeypatch.setattr(port_pa, "_SLICE_CANVAS_BUDGET_BYTES", None)
    assert port_pa._slice_canvas_budget(torch.device("cpu")) == 1 << 30
    monkeypatch.setattr(port_pa, "_SLICE_CANVAS_BUDGET_BYTES", 777)
    assert port_pa._slice_canvas_budget(torch.device("cpu")) == 777


def test_slice_device_shapes(pair):
    jpmd, port = pair
    out = port.slice_device(slice(0, 3), slice(2, 8), slice(1, 9))
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (3, 6, 8)
    assert rel_fro(out, jpmd[0:3, 2:8, 1:9]) <= 1e-5
    for key in ((4, 2, 3), (slice(0, 2), [1, 2], [3, 4]), (slice(5, 9), 3), ([1, 2],)):
        got = port.slice_device(*key)
        want = np.asarray(jpmd.slice_device(*key))
        assert tuple(got.shape) == want.shape
        assert rel_fro(got, want) <= 1e-5
    with pytest.raises(ValueError):
        port.slice_device(0, None, 0)


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_export_tiff_matches_jax(dtype, pair, tmp_path):
    jpmd, port = pair
    frames = np.arange(0, T, 7)
    ours, theirs = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    port.export_tiff(ours, frames=frames, chunk_frames=16, dtype=dtype)
    jpmd.export_tiff(theirs, frames=frames, chunk_frames=16, dtype=dtype)
    a, b = TiffReader(ours), TiffReader(theirs)
    assert len(a.pages) == len(b.pages) == len(frames)
    assert a.frame_shape == b.frame_shape == (D1, D2) and a.dtype == b.dtype == np.dtype(dtype)
    got, want = a.read_frames(range(len(frames))), b.read_frames(range(len(frames)))
    if dtype == "float32":
        assert rel_fro(got, want) <= 1e-5
    else:
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


# -- close (tests/test_pipeline.py:948-1043, 1185) -----------------------------

KW = dict(frame_range=280, max_components=4, background_rank=1, temporal_avg_factor=4,
          sim_iters=15, seed=0, device="cpu")


def _run():
    movie = make_low_rank_movie(2, (280, 20, 20), rng=np.random.default_rng(7))
    return localmd_decomposition(movie, (10, 10), **KW)


def test_close_materializes_and_context_manager_closes():
    pmd = _run()
    before = pmd[5]
    with pmd:
        pass
    assert pmd._blocksparse is None and pmd._rs_dev is None and pmd._panels_c is None
    np.testing.assert_allclose(pmd[5], before, atol=1e-4)
    np.testing.assert_allclose(pmd.reconstruct_frames([5]).numpy()[0], before, atol=1e-4)
    with pytest.raises(RuntimeError, match="slice_device needs the device factors"):
        pmd.slice_device(0)


def test_close_materialize_false_drops_without_transfer():
    pmd = _run()
    pmd.reconstruct_frames([0, 1])          # builds the port's own device caches
    assert pmd._rs_dev is not None and pmd._v_host is None
    pmd.close(materialize=False)
    assert pmd._v_host is None and pmd._u_csr is None
    assert pmd._blocksparse is None and pmd._v_src is None
    assert pmd._rs_dev is None and pmd._panels_c is None and pmd._recon_plan is None
    for prop in ("u", "v", "r", "mean_img", "var_img"):
        with pytest.raises(RuntimeError, match="materialize=False"):
            getattr(pmd, prop)
    with pytest.raises(RuntimeError, match="materialize=False"):
        pmd[0]
    assert pmd.rank == int(pmd.s.shape[0])
    pmd.close()
    pmd.close(materialize=False)


def test_context_manager_exit_after_materialize_false():
    with _run() as pmd:
        pmd.close(materialize=False)
    with pytest.raises(RuntimeError, match="materialize=False"):
        _ = pmd.v


def test_close_materialize_false_keeps_existing_host_state():
    pmd = _run()
    before = pmd[5]
    _ = pmd.u, pmd.r, pmd.v, pmd.mean_img, pmd.var_img
    pmd.close(materialize=False)
    np.testing.assert_allclose(pmd[5], before, atol=1e-4)


def test_close_keeps_npz_loaded_arrays_usable(tmp_path):
    pmd = _run()
    path = str(tmp_path / "d.npz")
    pmd.to_npz(path)
    before = pmd[5]
    for materialize in (True, False):
        loaded = PMDArray.from_npz(path, device="cpu")
        loaded.close(materialize=materialize)
        assert loaded.rank == pmd.rank
        np.testing.assert_allclose(loaded[5], before, atol=1e-4)
