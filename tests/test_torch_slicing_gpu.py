"""Device slicing's route to the host on the card
(localmd_tpu_torch/pmd_array.py, ``PMDArray._getitem_device``): a result
within the device's transient budget is copied into page-locked memory
that the returned array owns; a larger one, or one whose page-locked
allocation raises, into pageable memory. Both routes serve the same
bits, the parent's arithmetic on the card, and so do the two plan routes:
a box key's device slices and the gather of the same pixels.

Marked ``gpu``; each test skips (in a fixture, not at import) unless
``torch.cuda.is_available()``. Run on a machine with the card:
``python -m pytest -m gpu --noconftest tests/test_torch_slicing_gpu.py``.
The factors come from the port's CPU pipeline on a small movie and go to
the card through ``PMDArray.from_reference_state``; no kernel is built."""

import gc

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

T, D1, D2 = 400, 40, 36

KEYS = {
    "one_frame": (17,),
    "negative_frame": (-3,),
    "roi_trace": (slice(0, T), slice(12, 28), slice(9, 25)),
    "pixel_trace": (slice(None), 20, 11),
    "playback": (slice(100, 220),),
    "strided": (slice(-90, None, 3), slice(None, None, 7), slice(1, None, 5)),
    "fancy": ([3, 17, T - 1], [5, 29], [7, 25]),
    "negative_rows": (slice(0, 9), slice(-12, -2), -3),
}
# spatial boxes (ints and step-1 slices), served by the plan's box route
BOX_KEYS = {name: KEYS[name] for name in KEYS if name not in ("strided", "fancy")}
BOX_KEYS.update({
    "border_box": (slice(0, 64), slice(D1 - 7, D1), slice(D2 - 5, None)),
    "one_pixel_box": (slice(5, 300), slice(12, 13), slice(8, 9)),
    "int_cols": (slice(0, 20), slice(5, 25), 11),
    "negative_slices": (slice(-40, -3), slice(-20, -4), slice(-9, -1)),
})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def pmd():
    """The port's PMDArray of a small low-rank movie, its factors on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from localmd_tpu_torch import PMDArray, localmd_decomposition

    rng = np.random.default_rng(3)
    low = (rng.standard_normal((D1 * D2, 5)) @ rng.standard_normal((5, T))).T
    movie = (low.reshape(T, D1, D2) + 0.1 * rng.standard_normal((T, D1, D2))).astype(np.float32)
    host = localmd_decomposition(movie, (10, 10), frame_range=T, max_components=4,
                                 background_rank=2, temporal_avg_factor=4, sim_iters=15, seed=0,
                                 device="cpu")
    u = host._blocksparse
    state = dict(
        panels=u.panels.numpy(), rows=u.rows.numpy(), dense_basis=u.dense_basis.numpy(),
        starts=np.asarray(u.starts), block_shape=u.block_shape, counts=np.asarray(host._counts),
        r=np.asarray(host._r_padded), s=np.asarray(host._s_src), v=np.asarray(host._v_src),
        k2_keep=host._k2_keep, mean_img=np.asarray(host._mean_src),
        std_img=np.asarray(host._var_src), order=host.order,
    )
    return PMDArray.from_reference_state(state, device="cuda")


def _served(pmd, key):
    """(array, route) of one request: the counter its route added to."""
    before = dict(pmd.slice_counters)
    out = pmd[key]
    routes = [k for k in ("slice.pinned", "slice.pageable")
              if pmd.slice_counters.get(k, 0) > before.get(k, 0)]
    assert len(routes) == 1
    assert pmd.slice_counters["slice.host_bytes"] - before.get("slice.host_bytes", 0) == out.nbytes
    return out, routes[0]


def _pageable(pmd, key, monkeypatch):
    """The request served through the pageable route, the chunking kept."""
    import localmd_tpu_torch.pmd_array as pa

    with monkeypatch.context() as m:
        m.setattr(pa, "transient_budget_bytes", lambda dev: 0)
        return _served(pmd, key)


@pytest.fixture
def budget(cuda, monkeypatch):
    """Pins the chunks' budget to the device's, so forcing the pageable
    route through ``transient_budget_bytes`` leaves the chunking alone."""
    import localmd_tpu_torch.pmd_array as pa

    monkeypatch.setattr(pa, "_SLICE_CANVAS_BUDGET_BYTES", pa.transient_budget_bytes(cuda))
    return pa


@pytest.mark.parametrize("name", list(KEYS) + ["multi_chunk"])
def test_pinned_route_serves_the_pageable_routes_bits(name, pmd, budget, monkeypatch):
    key = KEYS.get(name, (slice(0, T), slice(3, 37), slice(2, 30)))
    if name == "multi_chunk":
        monkeypatch.setattr(budget, "_SLICE_CANVAS_BUDGET_BYTES", D1 * D2 * 4 * 16)
    pinned, route = _served(pmd, key)
    assert route == "slice.pinned"
    pageable, route = _pageable(pmd, key, monkeypatch)
    assert route == "slice.pageable"
    assert pinned.dtype == pageable.dtype == np.float32
    assert pinned.shape == pageable.shape and pinned.flags.writeable
    assert np.array_equal(pinned.view(np.uint32), pageable.view(np.uint32))
    if name != "multi_chunk":
        # one chunk: the same arithmetic as slice_device, squeezed on the host
        whole = pmd.slice_device(*key).cpu().numpy().squeeze()
        assert whole.shape == pinned.shape
        assert np.array_equal(whole.view(np.uint32), pinned.view(np.uint32))


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


@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "pageable"])
@pytest.mark.parametrize("name", list(BOX_KEYS))
def test_box_route_serves_the_gather_routes_bits(name, pinned, pmd, budget, monkeypatch):
    """A box key's plan (device slices, no gather, no per-pixel upload)
    serves bit for bit what the gather route serves for the same pixels,
    on either route to the host."""
    key = BOX_KEYS[name]
    results = []
    for k, plan_route in ((key, "slice.box"), (_general_key(key), "slice.gather")):
        before = pmd.slice_counters.get(plan_route, 0)
        out, route = _served(pmd, k) if pinned else _pageable(pmd, k, monkeypatch)
        assert route == ("slice.pinned" if pinned else "slice.pageable")
        assert pmd.slice_counters[plan_route] - before == 1
        results.append(out)
    box, gathered = results
    assert box.dtype == gathered.dtype == np.float32
    assert np.array_equal(box.view(np.uint32), gathered.reshape(box.shape).view(np.uint32))


def test_a_held_result_is_not_overwritten(pmd, budget, monkeypatch):
    """Results of one size share a bin of the host cache: one the caller
    holds keeps its block; after ``del`` the reused block serves the next
    result's own values."""
    a_key, b_key = (slice(0, 120),), (slice(200, 320),)
    want_a = _pageable(pmd, a_key, monkeypatch)[0]
    want_b = _pageable(pmd, b_key, monkeypatch)[0]
    a = _served(pmd, a_key)[0]
    b = _served(pmd, b_key)[0]
    assert b.ctypes.data != a.ctypes.data
    assert np.array_equal(a, want_a) and np.array_equal(b, want_b)
    del a
    gc.collect()
    again = [_served(pmd, key)[0] for key in (b_key, a_key, b_key)]
    assert len({g.ctypes.data for g in again + [b]}) == 4
    for got, want in zip(again, (want_b, want_a, want_b)):
        assert np.array_equal(got, want)


def test_larger_than_the_budget_takes_the_pageable_route(pmd, budget, monkeypatch):
    key = KEYS["roi_trace"]
    want = _served(pmd, key)[0]
    with monkeypatch.context() as m:
        m.setattr(budget, "transient_budget_bytes", lambda dev: want.nbytes - 1)
        got, route = _served(pmd, key)
    assert route == "slice.pageable" and np.array_equal(got, want)
    with monkeypatch.context() as m:
        m.setattr(budget, "transient_budget_bytes", lambda dev: want.nbytes)
        assert _served(pmd, key)[1] == "slice.pinned"


def test_a_refused_pinned_allocation_falls_back(pmd, budget, monkeypatch):
    key = KEYS["playback"]
    want = _served(pmd, key)[0]
    empty = torch.empty

    def refuse(*a, **kw):
        if kw.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return empty(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", refuse)
        got, route = _served(pmd, key)
    assert route == "slice.pageable" and np.array_equal(got, want)
    assert got.flags.writeable and got.dtype == np.float32


def test_counters_and_span(pmd, budget):
    """Every request counts once, under its route to the host and its plan
    route; ``slice.to_host_s`` and ``slice.plan_s`` add their spans'
    seconds, and both spans are ranges of the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    c = pmd.slice_counters
    keys = ("slice.pinned", "slice.to_host_s", "slice.plan_s", "slice.box", "slice.gather")
    before = {k: c.get(k, 0) for k in keys}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for key in KEYS.values():
            pmd[key]
    assert c["slice.pinned"] - before["slice.pinned"] == len(KEYS)
    assert c["slice.to_host_s"] > before["slice.to_host_s"]
    assert c["slice.plan_s"] > before["slice.plan_s"]
    assert c["slice.box"] - before["slice.box"] == len(BOX_KEYS.keys() & KEYS.keys())
    assert c["slice.gather"] - before["slice.gather"] == 2
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("pmd.to_host") == names.count("pmd.plan") == len(KEYS)
    assert any("DtoH" in n and "Pinned" in n for n in names)
    assert not any("DtoH" in n and "Pageable" in n for n in names)
