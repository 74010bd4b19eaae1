"""K3's output-stationary gather, checked on the CPU: its host block lists
(``kernels.recon_tile_lists``) and its arithmetic, emulated in plain torch
tile by tile over those lists, against the plain twin
(``block_reconstruct_plain``, a scatter-add) and the JAX package's
``fused_block_reconstruct`` in interpret mode.

Geometries: ``chip_smoke.py``'s three (961 blocks of 32 on 512², blocks
20 with a snapped tail and blocks 15 on 60 x 52) and 52 x 52 with blocks
20, where the snapped tail start puts a pixel in three blocks a dimension
(starts 20, 30, 32). Tolerance: 1e-5 relative Frobenius, exact fp32
products and the 3xTF32 products of ``tests/test_torch_tf32.py`` alike;
one TF32 pass misses it on offset inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np
from test_torch_tf32 import emulated_product

from localmd_tpu.ops.pallas_kernels import fused_block_reconstruct
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops.tiling import BlockGrid

TOL = 1e-5
GEOMETRIES = [(512, 512, 32), (60, 52, 20), (60, 52, 15), (52, 52, 20)]


def _grid(d1, d2, b):
    grid = BlockGrid(d1, d2, (b, b))
    return grid, [ids for ids, _ in grid.cosets()]


def _incidences(grid, d1, d2, b):
    """(pixel, block) pairs of the grid, pixel-major, from the starts."""
    pix, blk = [], []
    for n, (k0, j0) in enumerate(grid.starts):
        yy, xx = np.meshgrid(np.arange(k0, k0 + b), np.arange(j0, j0 + b), indexing="ij")
        pix.append((yy * d2 + xx).ravel())
        blk.append(np.full(b * b, n))
    return np.concatenate(pix), np.concatenate(blk)


@pytest.mark.parametrize("d1,d2,b", GEOMETRIES)
def test_tile_lists_hold_every_incidence_once_in_coset_order(d1, d2, b):
    grid, cosets = _grid(d1, d2, b)
    offsets, blocks = kernels.recon_tile_lists(grid.starts, cosets, (d1, d2), (b, b))
    t = kernels.RECON_TILE
    tiles_x = -(-d2 // t)
    assert len(offsets) == -(-d1 // t) * tiles_x + 1 and offsets[-1] == len(blocks)
    rank = np.empty(grid.n_blocks, int)
    rank[np.concatenate(cosets)] = np.arange(grid.n_blocks)
    pix, blk, pos = [], [], []
    for tile in range(len(offsets) - 1):
        listed = blocks[offsets[tile]:offsets[tile + 1]]
        assert len(set(listed.tolist())) == len(listed)
        y0, x0 = (tile // tiles_x) * t, (tile % tiles_x) * t
        for i, n in enumerate(listed):
            k0, j0 = grid.starts[n]
            ys = np.arange(max(y0, k0), min(y0 + t, k0 + b, d1))
            xs = np.arange(max(x0, j0), min(x0 + t, j0 + b, d2))
            assert ys.size and xs.size, "a listed block does not meet its tile"
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            pix.append((yy * d2 + xx).ravel())
            blk.append(np.full(yy.size, n))
            pos.append(np.full(yy.size, offsets[tile] + i))
    pix, blk, pos = (np.concatenate(x) for x in (pix, blk, pos))
    # every (pixel, block) incidence exactly once
    ref_pix, ref_blk = _incidences(grid, d1, d2, b)
    ours = np.sort(pix.astype(np.int64) * grid.n_blocks + blk)
    ref = np.sort(ref_pix.astype(np.int64) * grid.n_blocks + ref_blk)
    np.testing.assert_array_equal(ours, ref)
    # each pixel meets its blocks in coset order
    order = np.lexsort((pos, pix))
    same_pixel = pix[order][1:] == pix[order][:-1]
    assert (np.diff(rank[blk[order]])[same_pixel] > 0).all()
    if (d1, d2, b) == (52, 52, 20):
        assert np.bincount(ref_pix).max() == 9           # 3 blocks a dimension


def gather_emulated(panels_c, temporal, starts, cosets, fov, block_shape, passes=None):
    """K3's gather in plain torch: per 8 x 8 pixel tile, the listed blocks
    in order, each block's product (the tile's rows of U_b, zero outside
    the block) added into the tile's fp32 sum. ``passes`` None: exact fp32
    products; 3 or 1: the kernel's tensor-core arithmetic, a block's k8
    steps chained from zero (``emulated_product``)."""
    d1, d2 = fov
    b1, b2 = block_shape
    n, p, s = panels_c.shape
    f = temporal.shape[-1]
    t = kernels.RECON_TILE
    offsets, blocks = kernels.recon_tile_lists(starts, cosets, fov, block_shape)
    tiles_x = -(-d2 // t)
    out = torch.empty(d1, d2, f)
    for tile in range(len(offsets) - 1):
        y0, x0 = (tile // tiles_x) * t, (tile % tiles_x) * t
        yy, xx = torch.meshgrid(torch.arange(y0, y0 + t), torch.arange(x0, x0 + t), indexing="ij")
        yy, xx = yy.reshape(-1), xx.reshape(-1)
        acc = torch.zeros(t * t, f)
        for blk in blocks[offsets[tile]:offsets[tile + 1]]:
            k0, j0 = (int(v) for v in starts[blk])
            inside = (yy >= k0) & (yy < k0 + b1) & (xx >= j0) & (xx < j0 + b2)
            local = ((yy - k0).clamp(0, b1 - 1) * b2 + (xx - j0).clamp(0, b2 - 1))
            rows = torch.where(inside[:, None], panels_c[blk][local], torch.zeros(()))
            if passes is None:
                acc = acc + rows @ temporal[blk]
            else:
                acc = acc + emulated_product(rows, temporal[blk], passes, slab=-(-s // 8) * 8)
        keep = (yy < d1) & (xx < d2)
        out[yy[keep], xx[keep]] = acc[keep]
    return out


def _recon_inputs(rng, grid, b, s, f, offset=0.0):
    panels = rng.standard_normal((grid.n_blocks, b * b, s)).astype(np.float32)
    temporal = (rng.standard_normal((grid.n_blocks, s, f)) + offset).astype(np.float32)
    return kernels.panels_f_to_c(t32(panels), b, b), t32(temporal)


@pytest.mark.parametrize("d1,d2,b,s,f", [
    (60, 52, 20, 3, 40), (60, 52, 15, 5, 70), (52, 52, 20, 20, 9), (24, 16, 8, 40, 3),
])
def test_gather_matches_plain_twin_and_pallas(d1, d2, b, s, f, rng):
    grid, cosets = _grid(d1, d2, b)
    panels_c, temporal = _recon_inputs(rng, grid, b, s, f)
    args = (panels_c, temporal, grid.starts, cosets, (d1, d2), (b, b))
    ours = gather_emulated(*args)
    plain = kernels.block_reconstruct_plain(*args)
    pallas = np.asarray(fused_block_reconstruct(
        jnp.asarray(to_np(panels_c)), jnp.asarray(to_np(temporal)), jnp.asarray(grid.starts),
        jnp.zeros((d1, d2, f), jnp.float32), b, b,
    ))
    assert rel_fro(to_np(ours), to_np(plain)) <= TOL
    assert rel_fro(to_np(ours), pallas) <= TOL
    # the CPU wrapper is the plain twin
    assert torch.equal(kernels.block_reconstruct(*args), plain)


@pytest.mark.parametrize("d1,d2,b,s,f", [(60, 52, 20, 20, 40), (52, 52, 20, 33, 24), (60, 52, 15, 8, 70)])
def test_gather_3xtf32_matches_plain_twin_on_offset_inputs(d1, d2, b, s, f, rng):
    """Temporal factors with an offset of 100 (a baseline the chains
    carry): 3xTF32 holds the bar, one TF32 pass does not."""
    grid, cosets = _grid(d1, d2, b)
    panels_c, temporal = _recon_inputs(rng, grid, b, s, f, offset=100.0)
    args = (panels_c, temporal, grid.starts, cosets, (d1, d2), (b, b))
    plain = to_np(kernels.block_reconstruct_plain(*args))
    assert rel_fro(to_np(gather_emulated(*args, passes=3)), plain) <= TOL
    assert rel_fro(to_np(gather_emulated(*args, passes=1)), plain) > 10 * TOL


def test_prepare_reconstruct_checks_on_the_host():
    grid, cosets = _grid(60, 52, 20)
    plan = kernels.prepare_reconstruct(grid.starts, cosets, (60, 52), (20, 20), "cpu")
    offsets, blocks = kernels.recon_tile_lists(grid.starts, cosets, (60, 52), (20, 20))
    assert torch.equal(plan.tile_offsets, torch.from_numpy(offsets))
    assert torch.equal(plan.tile_blocks, torch.from_numpy(blocks))
    assert plan.starts.dtype == torch.int32 and plan.n_blocks == grid.n_blocks
    bad = grid.starts.copy()
    bad[-1, 1] += 1
    with pytest.raises(ValueError, match="outside the FOV"):
        kernels.prepare_reconstruct(bad, cosets, (60, 52), (20, 20), "cpu")
    with pytest.raises(ValueError, match="exactly once"):
        kernels.prepare_reconstruct(grid.starts, cosets[:-1], (60, 52), (20, 20), "cpu")
    with pytest.raises(ValueError, match="on the host"):
        kernels.prepare_reconstruct(torch.zeros(2, 2, device="meta"), cosets, (60, 52), (20, 20), "cpu")
