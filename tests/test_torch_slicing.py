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
    "reversed_rows": (slice(0, 40), slice(None, None, -1), slice(2, 20, 3)),
}
# keys whose spatial part is a box (ints and step-1 slices): the plan's box
# route; every other key of KEYS gathers its pixels from its bounding box
BOX_KEYS = {name: KEYS[name] for name in KEYS
            if name not in ("strided", "fancy_pairs", "reversed_rows")}
BOX_KEYS.update({
    "border_box": (slice(0, 50), slice(D1 - 7, D1), slice(D2 - 5, None)),
    "one_pixel_box": (slice(3, 60), slice(12, 13), slice(8, 9)),
    "int_rows": (slice(0, 20), 4, slice(2, 19)),
    "int_cols": (slice(0, 20), slice(5, 25), 11),
    "negative_slices": (slice(-40, -3), slice(-20, -4), slice(-9, -1)),
})
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


@pytest.fixture
def one_thread():
    """One CPU thread while a test compares bits: with several, two calls
    of the same GEMM on the CPU may differ in their last bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _general_key(key):
    """The same pixels as a box key, as broadcast index arrays: the plan's
    gather route."""
    k1 = key[1] if len(key) > 1 else slice(None)
    k2 = key[2] if len(key) > 2 else slice(None)

    def axis(k, n):
        if isinstance(k, int):
            return np.arange(k % n, k % n + 1)
        start, stop, _ = k.indices(n)
        return np.arange(start, stop)

    return key[0], axis(k1, D1)[:, None], axis(k2, D2)[None, :]


def _routed(port, key):
    """(result, the plan route its request counted)."""
    c = port.slice_counters
    before = {k: c.get(k, 0) for k in ("slice.box", "slice.gather")}
    out = port[key]
    routes = [k for k in before if c.get(k, 0) > before[k]]
    assert len(routes) == 1 and c[routes[0]] - before[routes[0]] == 1
    return out, routes[0]


@pytest.mark.parametrize("name", list(BOX_KEYS))
def test_box_route_serves_the_gather_routes_bits(name, pair, one_thread):
    """A box key's plan, sliced from device copies with no gather, serves
    bit for bit what the gather route serves for the same pixels."""
    jpmd, port = pair
    key = BOX_KEYS[name]
    box, route = _routed(port, key)
    assert route == "slice.box"
    general = _general_key(key)
    gathered, route = _routed(port, general)
    assert route == "slice.gather"
    plan = port._plan(key)
    rows, cols = general[1].ravel(), general[2].ravel()
    assert (plan.r0, plan.c0, plan.h, plan.w) == (rows[0], cols[0], len(rows), len(cols))
    assert box.dtype == gathered.dtype == np.float32
    assert np.array_equal(box.view(np.uint32), gathered.reshape(box.shape).view(np.uint32))
    assert rel_fro(box, jpmd[key]) <= 1e-5


@pytest.mark.parametrize("name", list(KEYS))
def test_plan_route_follows_the_key(name, pair):
    """Box keys count ``slice.box`` and take no gather; strided, reversed
    and fancy keys count ``slice.gather``; ``slice_device`` plans alike."""
    _, port = pair
    key = KEYS[name]
    want = "slice.box" if name in BOX_KEYS else "slice.gather"
    assert _routed(port, key)[1] == want
    plan = port._plan(key)
    assert (plan.rel is None) == (want == "slice.box")
    assert plan.mean.shape == plan.std.shape == plan.shape + (1,)
    assert len(plan.ids) == plan.h * plan.w
    c = port.slice_counters
    before = c[want]
    port.slice_device(*key)
    assert c[want] - before == 1


def test_plan_span_lands_in_the_trace(pair):
    """``pmd.plan`` is a host range of the profiler's trace, once per
    request (empty ones too), ahead of ``pmd.to_host``; ``slice.plan_s``
    adds its seconds."""
    from torch.profiler import ProfilerActivity, profile

    _, port = pair
    before = port.slice_counters.get("slice.plan_s", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for key in (KEYS["int_frame"], KEYS["strided"], EMPTY_KEYS["no_rows"]):
            port[key]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("pmd.plan", "pmd.to_host")]
    assert [e.name() for e in sorted(events, key=lambda e: e.start_ns())] == [
        "pmd.plan", "pmd.to_host", "pmd.plan", "pmd.to_host", "pmd.plan"]
    assert port.slice_counters["slice.plan_s"] > before


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
    corner_key = (0, np.array([[0], [D1 - 1]]), np.array([[0, D2 - 1]]))
    corners = np.asarray(port.row_indices[corner_key[1:]])
    plan = port._plan(corner_key)
    assert plan.rel is not None and plan.shape == (2, 2)
    assert plan.h * plan.w == jpmd._slice_pixel_extent(corners) == D1 * D2
    per_frame = port._slice_frame_bytes(port._plan((0,)))
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
