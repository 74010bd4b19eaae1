"""K2's and K3's plain twins (the wrappers on CPU tensors) against the JAX
package: ``fused_v_projection`` and ``fused_block_reconstruct`` in interpret
mode (tests/test_pallas_kernels.py:75-169, 193-218) and the loader's XLA
V-projection kernel. The window-geometry test at test_pallas_kernels.py:171
checks TPU DMA alignment and has no counterpart. Tolerance: rtol 1e-4 /
atol 1e-3 as in the JAX tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t32, to_np

from localmd_tpu.loader import _v_projection_kernel
from localmd_tpu.ops.pallas_kernels import (
    fused_block_reconstruct,
    fused_v_projection,
    panels_f_to_c as jpanels_f_to_c,
)
from localmd_tpu.ops.tiling import BlockGrid, unflatten_fov as junflatten_fov
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops.tiling import unflatten_fov

TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("t,d,r,dtype,scale", [
    (100, 700, 37, "uint16", 0.01),     # none aligned to tiles
    (256, 512, 128, "float32", 1.0),    # exactly aligned
    (64, 1024, 2560, "float32", 0.02),  # large rank
])
def test_v_projection_matches_pallas(t, d, r, dtype, scale, rng):
    if dtype == "uint16":
        raw = rng.integers(0, 4000, size=(t, d)).astype(np.uint16)
    else:
        raw = rng.standard_normal((t, d)).astype(np.float32)
    a = rng.standard_normal((d, r)).astype(np.float32) * scale
    c = rng.standard_normal(r).astype(np.float32)
    ours = to_np(kernels.v_projection(torch.from_numpy(raw), t32(a), t32(c)))
    ref = np.asarray(fused_v_projection(jnp.asarray(raw), jnp.asarray(a), jnp.asarray(c)))
    assert ours.shape == (r, t)
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, (raw.astype(np.float32) @ a - c[None, :]).T, **TOL)


@pytest.mark.parametrize("order", ["F", "C"])
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_v_projection_with_reordered_projector_matches_loader(order, dtype, rng):
    """The loader reorders the folded projector's rows from the pipeline's
    pixel order to the raw chunk's C order (loader.py:1142) before K2."""
    t, d1, d2, r = 50, 12, 9, 7
    raw = (rng.integers(0, 3000, size=(t, d1, d2)) if dtype == "uint16"
           else rng.standard_normal((t, d1, d2))).astype(dtype)
    a_tilde = rng.standard_normal((d1 * d2, r)).astype(np.float32) * 0.01
    c = rng.standard_normal(r).astype(np.float32)
    ref = np.asarray(_v_projection_kernel(jnp.asarray(a_tilde), jnp.asarray(c), jnp.asarray(raw), order))
    a_c = unflatten_fov(t32(a_tilde), d1, d2, order).reshape(d1 * d2, r).contiguous()
    ours = to_np(kernels.v_projection(torch.from_numpy(raw.reshape(t, d1 * d2)), a_c, t32(c)))
    np.testing.assert_allclose(ours, ref, **TOL)


def _recon_case(rng, d1, d2, b, f, s):
    grid = BlockGrid(d1, d2, (b, b))
    n, p = grid.n_blocks, grid.pixels_per_block
    panels = rng.standard_normal((n, p, s)).astype(np.float32)
    temporal = rng.standard_normal((n, s, f)).astype(np.float32)
    expected = np.zeros((d1 * d2, f), np.float32)
    for blk in range(n):
        expected[grid.rows[blk]] += panels[blk] @ temporal[blk]
    expected_img = np.asarray(junflatten_fov(jnp.asarray(expected), d1, d2))
    return grid, panels, temporal, expected_img


@pytest.mark.parametrize("d1,d2,b,f,s", [
    (24, 16, 8, 8, 3),      # test_pallas_kernels.py:101
    (60, 52, 20, 4, 3),     # :144 unaligned blocks and FOV
    (100, 100, 32, 4, 2),   # :193 the clamp edge case
    (60, 52, 15, 5, 4),     # odd blocks, snapped tails
])
def test_block_reconstruct_matches_pallas_and_scatter(d1, d2, b, f, s, rng):
    grid, panels, temporal, expected_img = _recon_case(rng, d1, d2, b, f, s)
    panels_c = kernels.panels_f_to_c(t32(panels), b, b)
    np.testing.assert_array_equal(
        to_np(panels_c), np.asarray(jpanels_f_to_c(jnp.asarray(panels), b, b))
    )
    ours = to_np(kernels.block_reconstruct(
        panels_c, t32(temporal), torch.as_tensor(grid.starts),
        [ids for ids, _ in grid.cosets()], (d1, d2), (b, b),
    ))
    ref = np.asarray(fused_block_reconstruct(
        jnp.asarray(to_np(panels_c)), jnp.asarray(temporal), jnp.asarray(grid.starts),
        jnp.zeros((d1, d2, f), jnp.float32), b, b,
    ))
    assert ours.shape == (d1, d2, f)
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, expected_img, **TOL)


def test_block_reconstruct_rejects_overlapping_cosets(rng):
    grid, panels, temporal, _ = _recon_case(rng, 24, 16, 8, 4, 2)
    all_in_one = [np.arange(grid.n_blocks, dtype=np.int32)]
    with pytest.raises(ValueError, match="overlap"):
        kernels.block_reconstruct(
            kernels.panels_f_to_c(t32(panels), 8, 8), t32(temporal),
            torch.as_tensor(grid.starts), all_in_one, (24, 16), (8, 8),
        )
    with pytest.raises(ValueError, match="exactly once"):
        kernels.check_cosets(grid.starts, [np.array([0, 1])], (24, 16), (8, 8))
