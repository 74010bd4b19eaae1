"""Calls the JAX package accepts that the port used to refuse:
``BlockGrid.device_constants()`` and ``BlockGrid.coset_info()`` without a
device (localmd_tpu/ops/tiling.py:190, 305: the default device), and
``sketch_override`` and ``jacobi_eigh`` under ``ops.linalg``
(localmd_tpu/ops/linalg.py:48, 148). ``None`` is the card, as
``load_decomposition`` takes it by default: without CUDA the call raises
``resolve_device``'s error, which asks for ``device="cpu"``, and never
uploads to the CPU silently."""

import numpy as np
import pytest
import torch

from _torch_util import rel_fro
from localmd_tpu_torch.ops import tiling
from localmd_tpu_torch.ops.tiling import BlockGrid

METHODS = ("device_constants", "coset_info")


@pytest.mark.parametrize("method", METHODS)
def test_grid_method_without_device_asks_for_cpu_when_cuda_is_missing(method, monkeypatch):
    """The JAX package's call (pipeline.py:1095, 1106) reaches the device
    resolution, not a ``TypeError``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = BlockGrid(40, 36, (16, 16), "F")
    uploads = dict(tiling.UPLOADS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(grid, method)()
    assert tiling.UPLOADS == uploads
    assert getattr(grid, f"_{method}", {}) == {}


def test_none_is_the_current_cuda_device_and_shares_its_cache_key(monkeypatch):
    """The key of ``None`` is ``_device_key(torch.device("cuda"))``'s, so a
    grid warmed with ``device="cuda"`` makes no second upload for
    ``None``; the resolution itself uploads nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    uploads = dict(tiling.UPLOADS)
    assert tiling._device_key(None) == torch.device("cuda", 0)
    assert tiling._device_key(None) == tiling._device_key(torch.device("cuda"))
    assert tiling._device_key(None) == tiling._device_key("cuda:0")
    assert tiling._device_key("cpu") == torch.device("cpu")
    assert tiling.UPLOADS == uploads


@pytest.mark.parametrize("order", ["F", "C"])
def test_explicit_cpu_constants_are_the_grid_arrays(order):
    grid = BlockGrid(40, 36, (16, 16), order)
    before = tiling.UPLOADS["device_constants"]
    weights, cum, rows, starts = grid.device_constants("cpu")
    assert tiling.UPLOADS["device_constants"] == before + 1
    assert torch.equal(weights, torch.from_numpy(grid.weights.T.reshape(-1)))
    cum_host = grid.cumulative_weights.T if order == "F" else grid.cumulative_weights
    assert torch.equal(cum, torch.from_numpy(cum_host.reshape(-1)))
    assert rows.dtype == torch.int64 and torch.equal(rows, torch.from_numpy(grid.rows.astype(np.int64)))
    assert torch.equal(starts, torch.from_numpy(grid.starts))
    assert all(a is b for a, b in zip(grid.device_constants(torch.device("cpu")),
                                      (weights, cum, rows, starts)))
    assert tiling.UPLOADS["device_constants"] == before + 1


def test_explicit_cpu_coset_info_is_the_grid_cosets():
    grid = BlockGrid(48, 48, (16, 16), "F")
    ids, metas, d1, d2, order, inv = grid.coset_info("cpu")
    cosets = grid.cosets()
    assert (d1, d2, order) == (48, 48, "F")
    assert metas == tuple(meta for _, meta in cosets)
    for got, (want, _) in zip(ids, cosets):
        assert got.device.type == "cpu" and torch.equal(got, torch.from_numpy(want.astype(np.int64)))
    concat = torch.cat(ids)
    assert torch.equal(concat[inv], torch.arange(grid.n_blocks))
    assert grid.coset_info("cpu") is grid.coset_info(torch.device("cpu"))


def test_ops_linalg_gives_the_seam_and_k4_route():
    import localmd_tpu_torch.ops as ops
    import localmd_tpu_torch.ops.linalg as linalg
    from localmd_tpu_torch.ops.linalg import jacobi_eigh, sketch_override
    from localmd_tpu_torch.utils import random

    assert sketch_override is random.sketch_override
    assert jacobi_eigh is ops.jacobi_eigh
    with pytest.raises(AttributeError):
        linalg.no_such_name


def test_jacobi_eigh_under_ops_linalg_is_k4s_twin_on_the_cpu():
    from localmd_tpu_torch.ops.linalg import jacobi_eigh, jacobi_eigh_plain

    a = np.random.default_rng(0).standard_normal((3, 12, 12)).astype(np.float32)
    sym = torch.from_numpy(a + a.transpose(0, 2, 1))
    vals, vecs = jacobi_eigh(sym)
    want_vals, want_vecs = jacobi_eigh_plain(sym)
    assert torch.equal(vals, want_vals) and torch.equal(vecs, want_vecs)


def test_sketch_seam_entered_through_ops_linalg_matches_jax():
    """The same draw through each package's ``ops.linalg.sketch_override``:
    the port's rSVD equals the JAX package's."""
    import jax
    import jax.numpy as jnp

    from localmd_tpu.ops import linalg as jax_linalg
    from localmd_tpu_torch.ops import linalg as port_linalg
    from localmd_tpu_torch.utils.random import random_draws_are_live

    rng = np.random.default_rng(4)
    matrix = (rng.standard_normal((60, 5)) @ rng.standard_normal((5, 80))
              + 0.01 * rng.standard_normal((60, 80))).astype(np.float32)

    def draw(shape):
        return np.random.default_rng(9).standard_normal(shape).astype(np.float32)

    with jax_linalg.sketch_override(lambda shape: jnp.asarray(draw(shape))):
        u_j, s_j, vt_j = jax_linalg.truncated_random_svd(jnp.asarray(matrix), jax.random.PRNGKey(0), 5)
    with port_linalg.sketch_override(draw):
        u_p, s_p, vt_p = port_linalg.truncated_random_svd(torch.from_numpy(matrix), 5)
    assert rel_fro(s_p, np.asarray(s_j)) < 1e-5
    assert rel_fro(u_p * s_p[None] @ vt_p, np.asarray(u_j * s_j[None] @ vt_j)) < 1e-5
    assert random_draws_are_live()
