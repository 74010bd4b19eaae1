"""The JAX package's accelerator routes in the port, held on the CPU against
the JAX routes forced on (their module flags set to True in both packages)
and against the port's own gather and canvas forms:

(a) ``coset_stage_plan``, ``BlockGrid.cell_geometry`` and the coset
    placement metadata: equal to JAX's;
(b) the scatter-free coset placement of ``BlockSparseMatrix.matmul``:
    ``torch.equal`` to the ``index_add_`` form, 1e-6 of JAX's ``matmul``;
(c) the banded Gram: 1e-5 of JAX's, symmetric, and 2e-5 (scaled by the
    maximum) of the port's canvas form;
(d) the cell-packed V projection: 1e-5 of JAX's operands and chunk
    product (f32 and uint16), and 3e-5 scaled of the K2 route in
    ``v_projection`` (one chunk and streamed chunks);
(e) ``window0_coset_stage``: counts equal and each block's ``U V`` 1e-5 of
    JAX's with the same draws per coset, 1e-4 of the port's gather route;
(f) ``localmd_decomposition`` with every route on: 1e-5 of the JAX
    pipeline with every route on (same draws, pinned thresholds, a regular
    40x40x500 golden construction), and 5e-4 scaled of the port with every
    route off, ranks equal;
(g) every ineligible case takes the gather and canvas forms;
(h) the block-batch budget's arithmetic against JAX's ``block_batch_budget``.
Plus the thresholds memo."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu import blocksparse as jb
from localmd_tpu import engine as je
from localmd_tpu.ops import linalg as jl
from localmd_tpu.ops import tiling as jt
from localmd_tpu.utils import device as jdev
from localmd_tpu_torch import blocksparse as tb
from localmd_tpu_torch import engine as te
from localmd_tpu_torch.loader import PMDLoader as TLoader
from localmd_tpu_torch.ops import tiling as tt
from localmd_tpu_torch.utils import device as tdev
from localmd_tpu_torch.utils.random import sketch_override

from conftest import make_low_rank_movie

GRIDS = [
    (64, 48, (16, 16)),   # regular: four lattices, no remainder
    (70, 64, (16, 16)),   # non-divisible: a snapped tail off the lattices
    (60, 60, (15, 15)),   # odd blocks: no lattice
    (40, 36, (16, 16)),   # the golden grid: a snapped tail on d2
    (36, 30, (12, 10)),   # regular, non-square blocks
    (12, 30, (12, 10)),   # one block row
]


def _sketch(shape):
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


def _matrices(rng, d1, d2, blocks, order, slots=4, k_bg=3):
    """The same random U in both packages, every route's metadata set."""
    jgrid = jt.BlockGrid(d1, d2, blocks, order)
    tgrid = tt.BlockGrid(d1, d2, blocks, order)
    panels = rng.standard_normal((tgrid.n_blocks, tgrid.pixels_per_block, slots)).astype(np.float32)
    bg = rng.standard_normal((d1 * d2, k_bg)).astype(np.float32)
    ju = jb.BlockSparseMatrix(
        panels=jnp.asarray(panels), rows=jnp.asarray(jgrid.rows), n_pixels=d1 * d2,
        dense_basis=jnp.asarray(bg), starts=jnp.asarray(jgrid.starts), block_shape=blocks,
        coset_info=jgrid.coset_info(), cell_geom=jgrid.cell_geometry(),
    )
    kw = dict(
        panels=t32(panels), rows=torch.as_tensor(tgrid.rows, dtype=torch.long),
        n_pixels=d1 * d2, dense_basis=t32(bg), starts=tgrid.starts, block_shape=blocks,
        cosets=tuple(ids for ids, _ in tgrid.cosets()),
    )
    tu_scatter = tb.BlockSparseMatrix(**kw)
    tu = tb.BlockSparseMatrix(**kw, coset_info=tgrid.coset_info("cpu"),
                              cell_geom=tgrid.cell_geometry())
    return ju, tu, tu_scatter


# -- (a) the plan and the geometry ------------------------------------------


@pytest.mark.parametrize("d1,d2,blocks", GRIDS)
@pytest.mark.parametrize("order", ["F", "C"])
def test_plan_geometry_and_placement_metadata_match_jax(d1, d2, blocks, order):
    b1, b2 = blocks
    ours, ref = te.coset_stage_plan(d1, d2, b1, b2), je.coset_stage_plan(d1, d2, b1, b2)
    assert (ours is None) == (ref is None)
    if ref is not None:
        assert ours[0] == ref[0]
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_array_equal(ours[2], ref[2])
        assert sorted(np.concatenate([ours[1], ours[2]])) == list(range(len(ours[1]) + len(ours[2])))
    tgrid, jgrid = tt.BlockGrid(d1, d2, blocks, order), jt.BlockGrid(d1, d2, blocks, order)
    assert tgrid.cell_geometry() == jgrid.cell_geometry()
    idxs_t, metas_t, *rest_t, inv_t = tgrid.coset_info("cpu")
    idxs_j, metas_j, *rest_j, inv_j = jgrid.coset_info()
    assert metas_t == metas_j and rest_t == rest_j
    for a, b in zip(idxs_t, idxs_j):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    np.testing.assert_array_equal(to_np(inv_t), np.asarray(inv_j))
    assert tgrid.coset_info("cpu") is tgrid.coset_info(torch.device("cpu"))   # made once


@pytest.mark.parametrize("b1,b2,saf,ok", [(16, 16, 2, True), (12, 10, 2, False), (15, 15, 1, False),
                                          (16, 16, 4, True), (12, 12, 4, False), (20, 16, 2, True)])
def test_coset_stage_supported_matches_jax(b1, b2, saf, ok):
    assert te.coset_stage_supported(b1, b2, saf) == je.coset_stage_supported(b1, b2, saf) == ok


def test_transient_bytes_match_jax():
    args = (1024, 1024, 510, 40, 40, 20, 10, 2, 2401)
    assert te.coset_stage_transient_bytes(*args) == je.coset_stage_transient_bytes(*args)


# -- (b) the placement --------------------------------------------------------


@pytest.mark.parametrize("d1,d2,blocks", GRIDS + [(33, 47, (10, 12))])
@pytest.mark.parametrize("order", ["F", "C"])
def test_placement_equals_index_add_and_matches_jax(d1, d2, blocks, order, rng):
    ju, tu, tu_scatter = _matrices(rng, d1, d2, blocks, order)
    x = rng.standard_normal((tu.shape[1], 9)).astype(np.float32)
    placed = tu.matmul(t32(x))
    assert tu._coset_layout()[4] is not None and tu_scatter._coset_layout()[4] is None
    assert torch.equal(placed, tu_scatter.matmul(t32(x)))
    assert rel_fro(placed, np.asarray(ju.matmul(jnp.asarray(x)))) <= 1e-6


def test_placement_chunks_columns_and_fills_partial_cosets(rng, monkeypatch):
    """Columns split to the transient budget, and a coset given in part (a
    rank's share) with its missing lattice places zero, equal the
    ``index_add_`` form."""
    d1, d2, blocks = 48, 48, (16, 16)
    _, tu, tu_scatter = _matrices(rng, d1, d2, blocks, "F", k_bg=0)
    x = t32(rng.standard_normal((tu.shape[1], 70)))
    monkeypatch.setattr(tb, "transient_budget_bytes", lambda dev: d1 * d2 * 16 * 32)
    assert torch.equal(tu.matmul(x), tu_scatter.matmul(x))
    lo, hi = 5, 19
    order, bounds = tb.coset_order(tu.cosets, lo, hi)
    placement = tb.coset_placement(tu.cosets, tu.coset_info, blocks, lo, hi)
    assert any(pos is not None for _, pos in placement[0])
    perm = torch.as_tensor(order)
    panels = tu.panels[lo:hi].index_select(0, perm)
    rows = tu.rows[lo:hi].index_select(0, perm)
    xb = x.reshape(tu.n_blocks, tu.slots, -1)[lo:hi].index_select(0, perm)
    assert torch.equal(tb.coset_overlap_add(panels, rows, xb, d1 * d2, bounds, placement),
                       tb.coset_overlap_add(panels, rows, xb, d1 * d2, bounds))


# -- (c) the banded Gram -----------------------------------------------------


@pytest.mark.parametrize("d1,d2,blocks,k_bg", [
    (36, 30, (12, 10), 3),   # regular, non-square blocks, background
    (36, 30, (12, 10), 0),   # no background
    (48, 48, (16, 16), 2),   # square
    (12, 30, (12, 10), 2),   # one block row: the row offsets' pair terms are zeros
    (36, 10, (12, 10), 1),   # one block column
])
def test_banded_gram_matches_jax_and_canvas(d1, d2, blocks, k_bg, rng, monkeypatch):
    ju, tu, tu_scatter = _matrices(rng, d1, d2, blocks, "F", k_bg=k_bg)
    right = rng.standard_normal((tu.shape[1], 7)).astype(np.float32)
    ours = to_np(tb._banded_gram_quad(tu.panels, t32(right), tu.dense_basis, tu.rows, *tu.cell_geom))
    ref = np.asarray(jb._banded_gram_quad(ju.panels, jnp.asarray(right), ju.dense_basis, ju.rows,
                                          *ju.cell_geom))
    assert rel_fro(ours, ref) <= 1e-5
    np.testing.assert_array_equal(ours, ours.T)
    canvas = to_np(tu.gram_quadratic(t32(right)))          # "auto" is off on the CPU
    monkeypatch.setattr(tb, "BANDED_GRAM", True)
    assert tu.banded_gram_ready(7) and not tu_scatter.banded_gram_ready(7)
    routed = to_np(tu.gram_quadratic(t32(right)))
    np.testing.assert_array_equal(routed, ours)
    scale = max(np.abs(canvas).max(), 1.0)
    np.testing.assert_allclose(routed / scale, canvas / scale, atol=2e-5)


# -- (d) the cell-packed V projection ------------------------------------------


def _stats(rng, d1, d2):
    return (rng.random((d1, d2)).astype(np.float32) * 3 + 2,
            rng.random((d1, d2)).astype(np.float32) + 0.5)


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("order,k_bg,frames", [("F", 2, 40), ("C", 2, 40), ("F", 0, 40),
                                               ("F", 2, 1100)])
def test_cell_operands_and_chunk_match_jax(dtype, order, k_bg, frames, rng):
    d = 24
    ju, tu, _ = _matrices(rng, d, d, (12, 12), order, slots=3, k_bg=k_bg)
    mean_img, std_img = _stats(rng, d, d)
    mean_f = tt.flatten_image(t32(mean_img), order)
    std_f = tt.flatten_image(t32(std_img), order)
    m_t, q_t = tb.build_vproj_cells(tu.panels, tu.rows, (d, d), order, tu.cell_geom, tu.dense_basis,
                                    std_f, mean_f)
    m_j, q_j = jb.build_vproj_cells(ju.panels, ju.rows, (d, d), order, ju.cell_geom, ju.dense_basis,
                                    jnp.asarray(to_np(std_f)), jnp.asarray(to_np(mean_f)))
    assert rel_fro(m_t, np.asarray(m_j)) <= 1e-6
    assert rel_fro(q_t, np.asarray(q_j)) <= 1e-6
    raw = rng.random((frames, d, d)) * 100 + 50
    raw = raw.astype(np.float32) if dtype == "float32" else raw.astype(np.uint16)
    p = rng.standard_normal((tu.shape[1], 5)).astype(np.float32)
    v_t = tb.coset_vproj_chunk(m_t, q_t, t32(p), torch.as_tensor(raw), *tu.cell_geom, tu.slots)
    v_j = jb.coset_vproj_chunk(m_j, q_j, jnp.asarray(p), jnp.asarray(raw), *ju.cell_geom, 3)
    assert rel_fro(v_t, np.asarray(v_j)) <= 1e-5
    # a frame's column does not depend on where its chunk starts or ends
    # (on a tile boundary), as a mesh rank's stripe needs
    tile = tb.VPROJ_FRAME_TILE
    if frames > tile:
        halves = [tb.coset_vproj_chunk(m_t, q_t, t32(p), torch.as_tensor(part), *tu.cell_geom,
                                       tu.slots) for part in (raw[:tile], raw[tile:])]
        assert torch.equal(torch.cat(halves, dim=1), v_t)


@pytest.mark.parametrize("order,batch", [("F", 10000), ("C", 10000), ("F", 64)])
@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("source", ["array", "file", "file_cached"])
def test_v_projection_cell_route_matches_k2_route(order, batch, dtype, source, rng, monkeypatch,
                                                  tmp_path):
    """The loader's branch: one chunk (batch 10000) and streamed 64-frame
    chunks, from memory, from a raw file and from the movie cache, the cell
    route against the K2 route (its plain twin here)."""
    from localmd_tpu_torch.dataset import RawBinaryArray

    t, d = 130, 24
    movie = rng.standard_normal((t, d, d)) + 4
    movie = movie.astype(np.float32) if dtype == "float32" else (movie * 500).astype(np.uint16)
    _, tu, tu_scatter = _matrices(rng, d, d, (12, 12), order, slots=3, k_bg=2)
    p = t32(rng.standard_normal((tu.shape[1], 5)))
    if source != "array":
        path = str(tmp_path / "movie.raw")
        movie.tofile(path)
        movie = RawBinaryArray(path, (t, d, d), dtype)

    def loader():
        ld = TLoader(movie, device="cpu", background_rank=0, seed=0, order=order,
                     batch_size=batch, cache_movie=source == "file_cached")
        assert (ld._cache_frames == t) == (source == "file_cached")
        return ld

    v_ref = to_np(loader().v_projection(tu, p))            # "auto" is off on the CPU
    monkeypatch.setattr(tb, "COSET_VPROJ", True)
    assert tb.coset_vproj_eligible(tu) and not tb.coset_vproj_eligible(tu_scatter)
    calls = []
    real = tb.coset_vproj_chunk
    monkeypatch.setattr(tb, "coset_vproj_chunk", lambda *a: calls.append(1) or real(*a))
    ld = loader()
    m_cell, _ = ld.prepare_vproj_cells(tu)
    assert ld.prepare_vproj_cells(tu)[0] is m_cell             # made once per U
    v_cell = to_np(ld.v_projection(tu, p))
    assert len(calls) == (1 if batch >= t else 2)           # the 2-frame tail merges
    scale = max(np.abs(v_ref).max(), 1.0)
    np.testing.assert_allclose(v_cell / scale, v_ref / scale, atol=3e-5)


def test_v_projection_drops_the_cell_operands(rng, monkeypatch):
    """After ``v_projection`` on the cell route the loader holds no cell
    operands (the (nc1, nc2, h1*h2, 4S + K) ``m_cell`` is gone once the
    caller drops its own reference), and a second ``prepare_vproj_cells``
    builds them again; the second V is the first, bit for bit."""
    import gc
    import weakref

    t, d = 130, 24
    movie = (rng.standard_normal((t, d, d)) + 4).astype(np.float32)
    _, tu, _ = _matrices(rng, d, d, (12, 12), "F", slots=3, k_bg=2)
    p = t32(rng.standard_normal((tu.shape[1], 5)))
    monkeypatch.setattr(tb, "COSET_VPROJ", True)
    builds = []
    real = tb.build_vproj_cells
    monkeypatch.setattr(tb, "build_vproj_cells", lambda *a: builds.append(1) or real(*a))
    ld = TLoader(movie, device="cpu", background_rank=0, seed=0)
    m_cell = weakref.ref(ld.prepare_vproj_cells(tu)[0])
    v_first = ld.v_projection(tu, p)
    gc.collect()
    assert m_cell() is None and len(builds) == 1
    assert ld.prepare_vproj_cells(tu)[0] is not None and len(builds) == 2
    assert torch.equal(ld.v_projection(tu, p), v_first) and len(builds) == 2


# -- (e) the coset block stage ---------------------------------------------


class _PerCall:
    """A stateful override: the k-th draw of each shape is ``draws[k]``."""

    def __init__(self, draws):
        self.draws, self.k = draws, 0

    def __call__(self, shape):
        out = self.draws[self.k % len(self.draws)]
        self.k += 1
        assert out.shape == tuple(shape)
        return jnp.asarray(out)


@pytest.mark.parametrize("thresholds", [(1e9, 1e9), (0.6, 0.9)])
@pytest.mark.parametrize("d1,d2", [(64, 48), (70, 64)])
def test_window0_coset_stage_matches_jax_and_gather(thresholds, d1, d2, rng):
    b, t, max_rank, taf, saf = 16, 200, 4, 4, 2
    # as many smooth components as slots: every kept component is signal,
    # so the comparison is not a rotation inside the noise
    movie = make_low_rank_movie(max_rank, (t, d1, d2), rng=rng, noise=0.05)
    data = np.moveaxis(movie, 0, -1)
    data = (data - data.mean(axis=-1, keepdims=True)) / data.std(axis=-1, keepdims=True)
    data = np.ascontiguousarray(data.astype(np.float32))
    meta, ids, _ = te.coset_stage_plan(d1, d2, b, b)
    k = max_rank + 10
    draws = [np.random.default_rng(40 + c).standard_normal((t // taf, k)).astype(np.float32)
             for c in range(len(meta))]
    # the port's sketches come per block, in coset order: coset c's blocks
    # all get JAX's c-th draw
    sketches = torch.cat([t32(draws[c]).expand(nr * nc, -1, -1)
                          for c, (_, _, nr, nc) in enumerate(meta)])
    keys = jax.random.split(jax.random.PRNGKey(0), len(ids))
    with jl.sketch_override(_PerCall(draws)):
        acc_j, cnt_j, v_j = je.window0_coset_stage(
            jnp.asarray(data), keys, meta, b, b, max_rank, taf, saf,
            jnp.float32(thresholds[0]), jnp.float32(thresholds[1]), 1, t,
        )
    acc_c, cnt_c, v_c = te.window0_coset_stage(t32(data), sketches, meta, b, b, max_rank, taf, saf,
                                               thresholds[0], thresholds[1], 1, t)
    grid = tt.BlockGrid(d1, d2, (b, b))
    acc_g, cnt_g, v_g = te.window0_chunk_step(t32(data), grid.starts[ids], sketches, b, b, max_rank,
                                              taf, saf, thresholds[0], thresholds[1], 1, t_used=t)
    np.testing.assert_array_equal(to_np(cnt_c), np.asarray(cnt_j))
    np.testing.assert_array_equal(to_np(cnt_c), to_np(cnt_g))
    rec_c = to_np(acc_c) @ to_np(v_c)
    rec_j = np.asarray(acc_j) @ np.asarray(v_j)
    rec_g = to_np(acc_g) @ to_np(v_g)
    assert rec_c.shape == (len(ids), b * b, t)
    for blk in range(len(ids)):
        if np.linalg.norm(rec_j[blk]) == 0:
            assert np.linalg.norm(rec_c[blk]) == 0
            continue
        assert rel_fro(rec_c[blk], rec_j[blk]) <= 1e-5, blk
        assert rel_fro(rec_c[blk], rec_g[blk]) <= 1e-4, blk


# -- (f) the pipeline with every route on --------------------------------------


def _golden_construction(d1=40, d2=40):
    """tests/test_golden.py's movie at a regular 40 x 40 FOV."""
    rng = np.random.default_rng(55)
    T, R = 500, 4
    spatial = rng.random((d1 * d2, R)).astype(np.float32)
    temporal = rng.standard_normal((R, T)).astype(np.float32)
    temporal *= np.asarray([8.0, 6.0, 4.5, 3.0], np.float32)[:, None]
    movie = (spatial @ temporal).T.reshape(T, d1, d2)
    movie += 1e-4 * rng.standard_normal(movie.shape).astype(np.float32)
    return movie.astype(np.float32), T, R


GOLDEN_KW = dict(background_rank=2, temporal_avg_factor=4, welch_compat="reference", seed=0,
                 final_rank_tol=0.0)


def _routes(monkeypatch, on):
    for mod, name in ((te, "COSET_STAGE"), (tb, "BANDED_GRAM"), (tb, "COSET_VPROJ")):
        monkeypatch.setattr(mod, name, on)


@pytest.fixture(scope="module")
def golden_routes():
    """The regular golden construction through the JAX pipeline with every
    route forced on, and through the port with every route on and off, a
    spy on each route."""
    import localmd_tpu.pipeline as jax_pipeline
    import localmd_tpu_torch.pipeline as port_pipeline

    movie, T, R = _golden_construction()
    mp = pytest.MonkeyPatch()
    calls = {"coset_stage": 0, "banded_gram": 0, "cell_vproj": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    try:
        for mod in (jax_pipeline, port_pipeline):
            mp.setattr(mod, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
        for mod, name in ((je, "COSET_STAGE"), (jb, "BANDED_GRAM"), (jb, "COSET_VPROJ")):
            mp.setattr(mod, name, True)
        with jl.sketch_override(lambda shape: jnp.asarray(_sketch(shape))):
            ref = jax_pipeline.localmd_decomposition(movie, (16, 16), frame_range=T,
                                                     max_components=R, **GOLDEN_KW)
        out = {}
        for on in (True, False):
            _routes(mp, on)
            mp.setattr(port_pipeline, "window0_coset_stage",
                       spy("coset_stage", te.window0_coset_stage))
            mp.setattr(tb, "_banded_gram_quad", spy("banded_gram", tb._banded_gram_quad))
            mp.setattr(tb, "coset_vproj_chunk", spy("cell_vproj", tb.coset_vproj_chunk))
            with sketch_override(_sketch):
                pmd = port_pipeline.localmd_decomposition(movie, (16, 16), frame_range=T,
                                                          max_components=R, device="cpu",
                                                          **GOLDEN_KW)
            out[on] = (pmd, dict(calls))
            mp.undo()
            for mod in (jax_pipeline, port_pipeline):
                mp.setattr(mod, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
            for k in calls:
                calls[k] = 0
    finally:
        mp.undo()
    return ref, out


def test_pipeline_with_every_route_matches_jax(golden_routes):
    ref, out = golden_routes
    pmd, calls = out[True]
    assert calls == {"coset_stage": 1, "banded_gram": 1, "cell_vproj": 1}
    assert pmd.pipeline_ranks == ref.pipeline_ranks
    assert rel_fro(pmd[:, :, :], np.asarray(ref[:, :, :])) <= 1e-5


def test_pipeline_routes_on_match_routes_off(golden_routes):
    _, out = golden_routes
    (on, calls_on), (off, calls_off) = out[True], out[False]
    assert calls_off == {"coset_stage": 0, "banded_gram": 0, "cell_vproj": 0}
    # the kept rank is not compared: with final_rank_tol 0 this movie's
    # tail of 1e-4 noise components sits at the eigenvalue cut
    assert on.pipeline_ranks == off.pipeline_ranks
    rec_on, rec_off = on[:, :, :], off[:, :, :]
    scale = float(np.abs(rec_off).max()) or 1.0
    np.testing.assert_allclose(rec_on / scale, rec_off / scale, atol=5e-4)


@pytest.mark.parametrize("on", [True, False])
def test_route_counters_follow_the_routes(golden_routes, on):
    """``pipeline_cache``'s route counters on a regular grid: with every
    route on (the card's reading of such a grid) the cell route, the banded
    Gram and no block off the lattices; with them off K2 and the canvas."""
    _, out = golden_routes
    cache = out[on][0].pipeline_cache
    assert (cache["vreg.cell_calls"] >= 1) == on and (cache["vreg.k2_calls"] >= 1) != on
    assert cache["fsvd.banded"] == int(on)
    assert cache["blocks.remainder"] == 0


# -- (g) ineligible cases take the gather and canvas forms -------------------


def _small_run(monkeypatch, movie, blocks=(16, 16), **kw):
    import localmd_tpu_torch.pipeline as port_pipeline

    calls = {"coset": 0, "gather": 0, "banded": 0, "cell": 0}
    real_c, real_g = te.window0_coset_stage, te.window0_chunk_step
    real_b, real_v = tb._banded_gram_quad, tb.coset_vproj_chunk

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_pipeline, "window0_coset_stage", count("coset", real_c))
    monkeypatch.setattr(port_pipeline, "window0_chunk_step", count("gather", real_g))
    monkeypatch.setattr(tb, "_banded_gram_quad", count("banded", real_b))
    monkeypatch.setattr(tb, "coset_vproj_chunk", count("cell", real_v))
    monkeypatch.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
    settings = dict(frame_range=200, max_components=3, background_rank=1, temporal_avg_factor=4,
                    seed=0, device="cpu")
    settings.update(kw)
    with sketch_override(_sketch):
        port_pipeline.localmd_decomposition(movie, blocks, **settings)
    return calls


@pytest.fixture(scope="module")
def small_movie():
    return make_low_rank_movie(3, (200, 32, 32), rng=np.random.default_rng(5), noise=0.05)


def _smooth_rows(x):
    return 0.5 * (x + torch.roll(x, 1, dims=-1))


@pytest.mark.parametrize("case", ["denoiser", "checkpoint", "windows", "memory_gate", "eligible"])
def test_ineligible_cases_take_the_gather_route(case, small_movie, monkeypatch, tmp_path):
    import localmd_tpu_torch.pipeline as port_pipeline

    _routes(monkeypatch, True)
    kw = {}
    if case == "denoiser":
        kw["temporal_denoiser"] = _smooth_rows
    elif case == "checkpoint":
        kw["checkpoint_path"] = str(tmp_path / "ck")
    elif case == "windows":
        kw["window_chunks"] = 100
    elif case == "memory_gate":
        monkeypatch.setattr(port_pipeline, "device_free_bytes", lambda dev: 1)
    calls = _small_run(monkeypatch, small_movie, **kw)
    if case == "eligible":
        assert calls["coset"] == 1 and calls["gather"] == 0
    elif case == "windows":
        assert calls["coset"] == 0 and calls["gather"] == 0     # the window loop
    else:
        assert calls["coset"] == 0 and calls["gather"] >= 1
    # U's routes follow the grid, not the block stage's options
    assert calls["banded"] == 1 and calls["cell"] >= 1


def test_irregular_grid_takes_the_canvas_and_k2_routes(monkeypatch):
    """A snapped tail: the coset stage runs the lattices and one gathered
    batch for the rest; the Gram and the V projection take the canvas and
    K2 forms, even with their flags forced on."""
    _routes(monkeypatch, True)
    movie = make_low_rank_movie(3, (200, 40, 36), rng=np.random.default_rng(6), noise=0.05)
    calls = _small_run(monkeypatch, movie)
    assert calls == {"coset": 1, "gather": 1, "banded": 0, "cell": 0}


def test_mesh_takes_the_gather_route(small_movie, monkeypatch, tmp_path):
    """One gloo rank in this process: ``mesh=`` keeps the gather route in
    the block stage and the canvas Gram, and the V projection's cell route
    runs on the rank's stripe."""
    import torch.distributed as dist

    from localmd_tpu_torch.parallel import make_mesh

    _routes(monkeypatch, True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        calls = _small_run(monkeypatch, small_movie, mesh=make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    assert calls["coset"] == 0 and calls["banded"] == 0 and calls["cell"] >= 1


# -- (h) the block-batch budget ------------------------------------------------


class _FakeDevice:
    """What JAX's ``device_free_bytes`` reads of a device."""

    def __init__(self, limit, in_use):
        self.stats = {"bytes_limit": limit, "bytes_in_use": in_use}

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("free,reserved,allocated", [
    (70 << 30, 6 << 30, 2 << 30), (3 << 30, 0, 0), (1 << 28, 1 << 30, 1 << 29), (40 << 30, 0, 0),
])
@pytest.mark.parametrize("per_block,n_blocks,bbs", [(16 << 20, 961, 256), (100 << 20, 2601, 256),
                                                    (4 << 20, 225, 1024), (64 << 20, 40, 256)])
def test_block_batch_budget_matches_jax(free, reserved, allocated, per_block, n_blocks, bbs,
                                        monkeypatch):
    total = 80 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, total))
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda dev=None: {
        "reserved_bytes": {"all": {"current": reserved}},
        "allocated_bytes": {"all": {"current": allocated}}})
    cuda = torch.device("cuda", 0)
    # the allocator's cached, unallocated bytes count as free
    assert tdev.device_free_bytes(cuda) == free + reserved - allocated
    assert tdev.device_free_bytes(cuda, pending_bytes=5) == free + reserved - allocated - 5
    ours = tdev.block_batch_budget(cuda, per_block_bytes=per_block, n_blocks=n_blocks,
                                   block_batch_size=bbs)
    ref = jdev.block_batch_budget(_FakeDevice(total, total - (free + reserved - allocated)),
                                  per_block_bytes=per_block, n_blocks=n_blocks,
                                  block_batch_size=bbs)
    assert ours == ref
    assert ours == n_blocks or ours & (ours - 1) == 0
    # JAX reads assumed_live_bytes only when its runtime reports no memory:
    # with the card's memory known it changes neither package's answer
    live = 9 << 30
    fake = _FakeDevice(total, total - (free + reserved - allocated))
    assert tdev.device_free_bytes(cuda, assumed_live_bytes=live) == jdev.device_free_bytes(
        fake, assumed_live_bytes=live) == free + reserved - allocated
    assert tdev.block_batch_budget(cuda, per_block_bytes=per_block, n_blocks=n_blocks,
                                   block_batch_size=bbs, assumed_live_bytes=live) == jdev.block_batch_budget(
        fake, per_block_bytes=per_block, n_blocks=n_blocks, block_batch_size=bbs,
        assumed_live_bytes=live) == ours


def test_transient_budget_defaults_to_the_current_device(monkeypatch):
    """``transient_budget_bytes()`` with no device: the CPU floor here, as
    JAX's on its CPU backend, and the current card's memory / 16 where CUDA
    is available."""
    assert tdev.transient_budget_bytes() == jdev.transient_budget_bytes() == 1 << 30
    total = 80 << 30

    class _Props:
        total_memory = total

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props())
    assert tdev.transient_budget_bytes() == tdev.transient_budget_bytes(torch.device("cuda", 0)) == total // 16


def test_block_batch_budget_on_the_cpu_and_below_16():
    cpu = torch.device("cpu")
    assert tdev.device_free_bytes(cpu) is None
    # 1 GB at 16 MiB a block: 59, rounded down to 32
    assert tdev.block_batch_budget(cpu, per_block_bytes=16 << 20, n_blocks=961,
                                   block_batch_size=256) == 32
    # a caller's batch below 16 stays (the per-batch checkpoint tests use 8)
    assert tdev.block_batch_budget(cpu, per_block_bytes=1, n_blocks=25, block_batch_size=8) == 8
    assert tdev.block_batch_budget(cpu, per_block_bytes=1, n_blocks=9, block_batch_size=256) == 9


# -- the thresholds memo ------------------------------------------------------


def test_threshold_memo(monkeypatch):
    from localmd_tpu_torch.utils.random import make_generator

    draws = []
    real = te.normal
    monkeypatch.setattr(te, "normal", lambda *a, **k: draws.append(1) or real(*a, **k))
    monkeypatch.setattr(te, "_threshold_cache", {})
    dims = (8, 8, 40)

    def run(seed, device="cpu"):
        return te.threshold_heuristic(dims, iters=8, sim_batch=4, generator=make_generator(seed, "cpu"),
                                      device=device, cache_token=("pipeline-thr", seed))

    first = run(3)
    n = len(draws)
    assert n > 0
    assert run(3) == first and len(draws) == n                          # memoized: no draw
    run(4)
    assert len(draws) == 2 * n                                         # another seed
    with _precision("high"):
        run(3)
    assert len(draws) == 3 * n                                         # another precision
    run(3, device=torch.device("cpu", 0))
    assert len(draws) == 4 * n                                         # another device
    assert {k[-1] for k in te._threshold_cache} == {"cpu", "cpu:0"}
    te.threshold_heuristic(dims, iters=8, sim_batch=4, generator=make_generator(3, "cpu"),
                           device="cpu")
    assert len(draws) == 5 * n                                         # no token: no memo
    with sketch_override(lambda shape: np.ones(shape, np.float32)):
        run(3)
    assert len(draws) == 6 * n                                         # no memo under an override


class _precision:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(self.name)

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved)
