"""Port vs JAX: the blocked-sparse U (products, Gram forms, CSR export) and
the factorized SVD built on it. Tolerance: 1e-5 relative Frobenius for
products, 1e-4 for factorizations compared through the matrix they
reconstruct; CSR structure exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu import blocksparse as jb
from localmd_tpu import factorization as jf
from localmd_tpu.ops.tiling import BlockGrid
from localmd_tpu_torch import blocksparse as tb
from localmd_tpu_torch import factorization as tf


def _pair(rng, d1, d2, blocks, order, slots=4, k_bg=3, geometry=True):
    grid = BlockGrid(d1, d2, blocks, order)
    panels = rng.standard_normal((grid.n_blocks, grid.pixels_per_block, slots)).astype(np.float32)
    counts = rng.integers(0, slots + 1, size=grid.n_blocks)
    panels *= np.arange(slots)[None, None, :] < counts[:, None, None]  # zero-padded slots
    bg = rng.standard_normal((d1 * d2, k_bg)).astype(np.float32)
    ju = jb.BlockSparseMatrix(
        panels=jnp.asarray(panels), rows=jnp.asarray(grid.rows), n_pixels=d1 * d2,
        dense_basis=jnp.asarray(bg),
    )
    # without the geometry: U from panels and rows alone, as JAX allows
    grid_kw = dict(starts=grid.starts, block_shape=blocks,
                   cosets=tuple(ids for ids, _ in grid.cosets())) if geometry else {}
    tu = tb.BlockSparseMatrix(
        panels=t32(panels), rows=torch.as_tensor(grid.rows, dtype=torch.long),
        n_pixels=d1 * d2, dense_basis=t32(bg), **grid_kw,
    )
    return ju, tu, counts


@pytest.mark.parametrize("order", ["F", "C"])
@pytest.mark.parametrize("d1,d2,blocks", [(40, 36, (16, 16)), (33, 47, (10, 12))])
@pytest.mark.parametrize("geometry", [True, False])
def test_products_match_jax(order, d1, d2, blocks, geometry, rng):
    ju, tu, _ = _pair(rng, d1, d2, blocks, order, geometry=geometry)
    x = rng.standard_normal((tu.shape[1], 7)).astype(np.float32)
    y = rng.standard_normal((d1 * d2, 5)).astype(np.float32)
    assert rel_fro(tu.matmul(t32(x)), np.asarray(ju.matmul(jnp.asarray(x)))) <= 1e-5
    assert rel_fro(tu.rmatmul(t32(y)), np.asarray(ju.rmatmul(jnp.asarray(y)))) <= 1e-5
    assert rel_fro(tu.gram_matmul(t32(x), col_chunk=3),
                   np.asarray(ju.gram_matmul(jnp.asarray(x)))) <= 1e-5
    for chunk in (None, 4):
        ours = tu.gram_quadratic(t32(x), col_chunk=chunk)
        ref = np.asarray(ju.gram_quadratic(jnp.asarray(x), col_chunk=chunk))
        assert rel_fro(ours, ref) <= 1e-5
        np.testing.assert_array_equal(to_np(ours), to_np(ours).T)


def test_to_csr_matches_jax(rng):
    ju, tu, counts = _pair(rng, 40, 36, (16, 16), "F")
    csr_t, map_t = tu.to_csr(counts)
    csr_j, map_j = ju.to_csr(counts)
    np.testing.assert_array_equal(map_t, map_j)
    assert csr_t.shape == csr_j.shape
    assert abs(csr_t - csr_j).max() == 0


@pytest.mark.parametrize("expected_rank", [None, "counts"])
def test_factorized_svd_matches_jax(expected_rank, rng):
    ju, tu, counts = _pair(rng, 40, 36, (16, 16), "F", slots=3, k_bg=2)
    r_cols = tu.shape[1]
    v = rng.standard_normal((r_cols, 40)).astype(np.float32)
    k = None if expected_rank is None else int(counts.sum()) + 2
    p_t, s_t, vt_t = tf.compute_lowrank_factorized_svd(tu, t32(v), expected_rank=k)
    p_j, s_j, vt_j = jf.compute_lowrank_factorized_svd(ju, jnp.asarray(v), expected_rank=k)
    recon_t = to_np(tu.matmul(p_t)) * to_np(s_t)[None, :] @ to_np(vt_t)
    recon_j = np.asarray(ju.matmul(p_j)) * np.asarray(s_j)[None, :] @ np.asarray(vt_j)
    truth = to_np(tu.matmul(t32(v)))
    assert rel_fro(recon_t, truth) <= 1e-4
    assert rel_fro(recon_t, recon_j) <= 1e-4
    # only_left: U @ P has orthonormal columns (zeroed where rank-deficient)
    p_only = to_np(tf.compute_lowrank_factorized_svd(tu, t32(v), only_left=True, expected_rank=k))
    up = to_np(tu.matmul(t32(p_only)))
    gram = up.T @ up
    kept = np.diag(gram) > 0.5
    np.testing.assert_allclose(gram, np.diag(kept.astype(np.float64)), atol=1e-4)


class _NoMesh:
    """A mesh no product may touch: a scipy U takes the unsharded path."""

    def __getattr__(self, name):
        raise AssertionError(f"the mesh was read ({name})")


@pytest.mark.parametrize("n_cols,t", [(30, 200), (50, 20)])   # second: right = V
@pytest.mark.parametrize("expected_rank", [None, "rank"])
@pytest.mark.parametrize("mesh", [None, "unused"])
def test_factorized_svd_of_a_scipy_u_matches_jax(n_cols, t, expected_rank, mesh):
    """A scipy sparse U, as the JAX package accepts it
    (factorization.py:34-56): the singular values within rtol 1e-5 of
    JAX's, (U P') s Vt within 1e-5 of U V in both packages, and U P
    orthonormal within 1e-5."""
    rng = np.random.default_rng(14)
    u = scipy.sparse.random(400, n_cols, density=0.2, format="csr", random_state=rng, dtype=np.float32)
    v = rng.standard_normal((n_cols, t)).astype(np.float32)
    k = None if expected_rank is None else min(n_cols, t)
    mesh_t = mesh_j = None
    if mesh:
        mesh_t, mesh_j = _NoMesh(), _NoMesh()
    p_t, s_t, vt_t = tf.compute_lowrank_factorized_svd(u, t32(v), mesh=mesh_t, expected_rank=k)
    p_j, s_j, vt_j = jf.compute_lowrank_factorized_svd(u, jnp.asarray(v), mesh=mesh_j, expected_rank=k)
    assert isinstance(p_t, torch.Tensor) and s_t.shape == np.asarray(s_j).shape
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), rtol=1e-5)
    truth = u @ v.astype(np.float64)
    for p, s, vt in ((p_t, s_t, vt_t), (p_j, s_j, vt_j)):
        assert rel_fro((u @ to_np(p)) * to_np(s)[None, :] @ to_np(vt), truth) <= 1e-5
    p_only = tf.compute_lowrank_factorized_svd(u, t32(v), only_left=True, mesh=mesh_t, expected_rank=k)
    up = u @ to_np(p_only).astype(np.float64)
    np.testing.assert_allclose(up.T @ up, np.eye(up.shape[1]), atol=1e-5)


@pytest.mark.parametrize("rel_tol", [0.0, 1e-3, 0.5])
def test_final_svd_reformat_matches_jax(rel_tol, rng):
    p = rng.standard_normal((30, 8)).astype(np.float32)
    v = (rng.standard_normal((8, 50)) * np.logspace(0, -4, 8)[:, None]).astype(np.float32)
    r_t, s_t, vt_t, keep_t = tf.final_svd_reformat(t32(p), t32(v), rel_tol=rel_tol)
    r_j, s_j, vt_j, keep_j = jf.final_svd_reformat(jnp.asarray(p), jnp.asarray(v), rel_tol=rel_tol)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4, atol=1e-6)
    prod_t = to_np(r_t) * s_t[None, :] @ to_np(vt_t)
    prod_j = np.asarray(r_j) * s_j[None, :] @ np.asarray(vt_j)
    assert rel_fro(prod_t, prod_j) <= 1e-4


@pytest.mark.parametrize("m,k", [(100, 20), (600, 100), (600, 500), (512, 200), (4000, 480)])
def test_eigh_plan_matches_jax(m, k):
    assert tf.eigh_plan(m, k) == jf.eigh_plan(m, k)


def test_aggregate_local_and_global_matches_jax(rng):
    u = scipy.sparse.random(50, 6, density=0.3, random_state=1, dtype=np.float32)
    v = rng.standard_normal((6, 9)).astype(np.float32)
    sb = rng.standard_normal((50, 2)).astype(np.float32)
    tb_ = rng.standard_normal((2, 9)).astype(np.float32)
    u_t, v_t = tf.aggregate_local_and_global_decomposition(u, v, sb, tb_)
    u_j, v_j = jf.aggregate_local_and_global_decomposition(u, v, sb, tb_)
    assert abs(u_t - u_j).max() == 0
    np.testing.assert_array_equal(v_t, v_j)
