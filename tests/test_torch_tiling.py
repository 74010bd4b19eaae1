"""Port vs JAX: F/C flattening, BlockGrid, patch gather, overlap-add and
average pooling. Tolerance: exact for integer metadata and pure data
movement, 1e-6 relative for the averaging and scatter sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu.ops import pooling as jpool
from localmd_tpu.ops import tiling as jt
from localmd_tpu_torch.ops import pooling as tpool
from localmd_tpu_torch.ops import tiling as tt

GRIDS = [
    (40, 36, (16, 16)),   # even blocks, snapped tail on d2
    (60, 52, (15, 15)),   # odd blocks
    (60, 52, (20, 20)),   # even blocks, snapped tail
    (64, 64, (32, 32)),   # regular grid
    (33, 47, (10, 12)),   # mixed
]


@pytest.mark.parametrize("order", ["F", "C"])
def test_flatten_unflatten_fov_matches_jax(order, rng):
    x = rng.standard_normal((3, 7, 5, 4)).astype(np.float32)
    flat_t = tt.flatten_fov(t32(x), order)
    np.testing.assert_array_equal(to_np(flat_t), np.asarray(jt.flatten_fov(jnp.asarray(x), order)))
    back = tt.unflatten_fov(flat_t, 7, 5, order)
    np.testing.assert_array_equal(to_np(back), x)


@pytest.mark.parametrize("order", ["F", "C"])
def test_flatten_unflatten_image_matches_jax(order, rng):
    x = rng.standard_normal((2, 6, 9)).astype(np.float32)
    flat_t = tt.flatten_image(t32(x), order)
    np.testing.assert_array_equal(to_np(flat_t), np.asarray(jt.flatten_image(jnp.asarray(x), order)))
    np.testing.assert_array_equal(to_np(tt.unflatten_image(flat_t, 6, 9, order)), x)


@pytest.mark.parametrize("d1,d2,blocks", GRIDS)
@pytest.mark.parametrize("order", ["F", "C"])
def test_block_grid_fields_match_jax(d1, d2, blocks, order):
    ours = tt.BlockGrid(d1, d2, blocks, order)
    ref = jt.BlockGrid(d1, d2, blocks, order)
    np.testing.assert_array_equal(ours.starts, ref.starts)
    np.testing.assert_array_equal(ours.rows, ref.rows)
    np.testing.assert_array_equal(ours.weights, ref.weights)
    np.testing.assert_array_equal(ours.cumulative_weights, ref.cumulative_weights)
    assert len(ours.cosets()) == len(ref.cosets())
    for (ids_o, meta_o), (ids_r, meta_r) in zip(ours.cosets(), ref.cosets()):
        np.testing.assert_array_equal(ids_o, ids_r)
        assert meta_o == meta_r


@pytest.mark.parametrize("d1,d2,blocks", GRIDS)
def test_cosets_partition_into_disjoint_blocks(d1, d2, blocks):
    from localmd_tpu_torch.ops.kernels import check_cosets

    grid = tt.BlockGrid(d1, d2, blocks)
    check_cosets(grid.starts, [ids for ids, _ in grid.cosets()], (d1, d2), blocks)


def test_block_sizes_and_fov_checks():
    assert tt.update_block_sizes((32, 40), (20, 50)) == jt.update_block_sizes((32, 40), (20, 50))
    with pytest.raises(ValueError):
        tt.update_block_sizes((8, 40), (20, 50))
    with pytest.raises(ValueError):
        tt.check_fov_size((9, 50))


@pytest.mark.parametrize("d1,d2,blocks", GRIDS[:3])
def test_extract_patches_matches_jax(d1, d2, blocks, rng):
    data = rng.standard_normal((d1, d2, 6)).astype(np.float32)
    grid = jt.BlockGrid(d1, d2, blocks)
    ref = np.asarray(jt.extract_patches(jnp.asarray(data), jnp.asarray(grid.starts), *blocks))
    ours = tt.extract_patches(t32(data), grid.starts, *blocks)
    np.testing.assert_array_equal(to_np(ours), ref)


@pytest.mark.parametrize("d1,d2,blocks", GRIDS[:3])
def test_overlap_add_matches_jax(d1, d2, blocks, rng):
    grid = jt.BlockGrid(d1, d2, blocks)
    panels = rng.standard_normal((grid.n_blocks, grid.pixels_per_block, 3)).astype(np.float32)
    ref = np.asarray(jt.overlap_add(jnp.asarray(panels), jnp.asarray(grid.rows), d1 * d2))
    ours = tt.overlap_add(t32(panels), grid.rows, d1 * d2)
    assert rel_fro(ours, ref) <= 1e-6


@pytest.mark.parametrize("shape,n", [
    ((4, 16, 16, 5), 2),    # divisible: reshape + mean
    ((3, 15, 15, 4), 2),    # SAME padding, partial edge windows
    ((2, 20, 14, 3), 3),
    ((11, 13, 2), 4),
    ((8, 8, 2), 1),
])
def test_downsample_average_pooling_matches_jax(shape, n, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jpool.downsample_average_pooling(jnp.asarray(x), n))
    ours = tpool.downsample_average_pooling(t32(x), n)
    assert ours.shape == ref.shape
    assert rel_fro(ours, ref) <= 1e-6


# -- the grid's device constants and the memoized grids ------------------------

@pytest.mark.parametrize("d1,d2,blocks,order", [
    (60, 52, (20, 20), "F"),    # snapped tail
    (60, 52, (20, 20), "C"),
    (64, 64, (32, 32), "F"),    # regular
    (33, 47, (10, 12), "C"),    # mixed, snapped on both dims
])
def test_device_constants_match_jax(d1, d2, blocks, order):
    ours = tt.BlockGrid(d1, d2, blocks, order).device_constants("cpu")
    ref = jt.BlockGrid(d1, d2, blocks, order).device_constants()
    assert len(ours) == len(ref) == 4
    for name, o, r in zip(("weights_flat", "cum_flat", "rows", "starts"), ours, ref):
        assert o.device.type == "cpu", name
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
    assert ours[2].dtype == torch.int64 and ours[3].dtype == torch.int32
    assert ours[0].dtype == ours[1].dtype == torch.float32


def test_device_constants_are_uploaded_once_per_grid_and_device():
    grid = tt.BlockGrid(40, 36, (16, 16))
    before = tt.UPLOADS["device_constants"]
    first = grid.device_constants("cpu")
    again = grid.device_constants(torch.device("cpu"))
    assert all(a is b for a, b in zip(first, again))
    assert tt.UPLOADS["device_constants"] == before + 1


def test_device_constants_upload_once_under_threads():
    """Volumetric planes share memoized grids from their threads: many
    threads asking at once get one upload and the same tensors."""
    import sys
    import threading

    grid = tt.BlockGrid(60, 52, (20, 20), "C")
    before = tt.UPLOADS["device_constants"]
    got, start = [], threading.Barrier(16)

    def ask():
        start.wait(timeout=30)
        got.append(grid.device_constants("cpu"))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and len(got) == 16
    assert all(g is got[0] for g in got)
    assert tt.UPLOADS["device_constants"] == before + 1


def test_clear_block_grid_cache_gives_a_fresh_grid():
    tt.clear_block_grid_cache()
    grid = tt.block_grid(40, 36, (16, 16), "F")
    assert tt.block_grid(40, 36, (16, 16), "F") is grid
    consts, info = grid.device_constants("cpu"), grid.coset_info("cpu")
    tt.clear_block_grid_cache()
    fresh = tt.block_grid(40, 36, (16, 16), "F")
    assert fresh is not grid
    assert getattr(fresh, "_device_constants", None) is None
    assert getattr(fresh, "_coset_info", None) is None
    assert tt.block_grid.cache_info().currsize == 1
    # the old grid's tensors stay valid for whoever holds them
    np.testing.assert_array_equal(fresh.device_constants("cpu")[2].numpy(), consts[2].numpy())
    assert info[0][0].device.type == "cpu"


def _public(module):
    return sorted(name for name, obj in vars(module).items()
                  if not name.startswith("_") and callable(obj)
                  and getattr(obj, "__module__", None) == module.__name__)


def test_tiling_exports_the_jax_names():
    """The same public functions and classes as the JAX module, with
    ``clear_block_grid_cache`` exported where the JAX package exports it:
    from ``ops.tiling`` only."""
    import localmd_tpu
    import localmd_tpu.ops
    import localmd_tpu_torch
    import localmd_tpu_torch.ops

    assert _public(tt) == _public(jt)
    assert "clear_block_grid_cache" in _public(tt)
    assert callable(tt.BlockGrid.device_constants)
    assert list(localmd_tpu_torch.ops.__all__) == list(localmd_tpu.ops.__all__)
    for pkg in (localmd_tpu, localmd_tpu_torch, localmd_tpu.ops, localmd_tpu_torch.ops):
        assert "clear_block_grid_cache" not in pkg.__all__
