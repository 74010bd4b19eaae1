"""Port vs JAX: the multi-window block stage (engine.py:151-178, 594-903).
``single_residual_block_md_batched``, the three tiers of
``_fallback_rerun`` and ``windowed_pmd_batched`` get the same blocks and
the same injected sketch in both packages. Tolerance: counts and decisions
exact; per-block spatial projectors ``U U^T`` and reconstructions
``U @ temporal`` 1e-4 relative Frobenius."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu import engine as je
from localmd_tpu.ops import linalg as jl
from localmd_tpu_torch import engine as te
from localmd_tpu_torch.ops.tiling import flatten_fov

B, T, WL, RANK, TAF, SAF = 16, 240, 80, 6, 4, 2
THRESHOLDS = (1.0, 1.6)


def _smooth(x, axes, passes):
    for _ in range(passes):
        y = x.copy()
        for ax in axes:
            y = y + np.roll(x, 1, ax) + np.roll(x, -1, ax)
        x = y / (1 + 2 * len(axes))
    return x


def windowed_blocks(n=8, seed=0, noise=1.0):
    """(n, 16, 16, 240) blocks whose smooth rank-2 signal changes every 80
    frames, so later windows find components the first did not. Unit noise
    keeps the span of a kept noise component well determined in float32: at
    0.05-0.3 the two packages' projectors of such components differ by
    1e-4 to 3e-3."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(T // WL):
        u = _smooth(rng.standard_normal((n, B, B, 2)), (1, 2), 6)
        v = _smooth(rng.standard_normal((n, 2, WL)), (2,), 4)
        u /= u.reshape(n, -1, 2).std(axis=1)[:, None, None, :]
        v /= v.std(axis=2, keepdims=True)
        parts.append(np.einsum("nijr,nrt->nijt", u, v))
    blocks = np.concatenate(parts, axis=-1) + noise * rng.standard_normal((n, B, B, T))
    return blocks.astype(np.float32)


def _sketch(shape):
    return np.random.default_rng(21).standard_normal(shape).astype(np.float32)


def _sketches(n, n_windows=1):
    """The port's explicit (n_windows, n, WL / TAF, RANK + 10) sketches: the
    injected draw, as JAX's override broadcasts it."""
    s = torch.as_tensor(_sketch((WL // TAF, RANK + 10)))
    return s.expand(n_windows, n, -1, -1)


def _jax_override():
    return jl.sketch_override(lambda shape: jnp.asarray(_sketch(shape)))


def _proj(u):
    u = np.asarray(u, np.float64)
    return u @ np.swapaxes(u, -1, -2)


def _assert_bases_match(u_t, u_j, tol=1e-4):
    for b in range(u_j.shape[0]):
        pj = _proj(u_j[b])
        if np.linalg.norm(pj) == 0:
            assert np.linalg.norm(_proj(u_t[b])) == 0
        else:
            assert rel_fro(_proj(u_t[b]), pj) <= tol, b


def test_single_residual_block_md_batched_matches_jax():
    blocks = windowed_blocks(n=6, seed=1)
    window0, window1 = blocks[..., :WL], blocks[..., WL : 2 * WL]
    keys = jax.random.split(jax.random.PRNGKey(0), 6)
    with _jax_override():
        u0, _, _ = je.single_block_md_batched(jnp.asarray(window0), keys, 3, TAF, SAF, 1e9, 1e9)
        existing = jnp.concatenate([u0, jnp.zeros(u0.shape[:2] + (RANK - 3,))], axis=2)
        u_j, dec_j, v_j = je.single_residual_block_md_batched(
            jnp.asarray(window1), existing, keys, RANK, TAF, *THRESHOLDS
        )
    u_t, dec_t, v_t = te.single_residual_block_md_batched(
        t32(window1), t32(existing), _sketches(6)[0], RANK, TAF, *THRESHOLDS
    )
    np.testing.assert_array_equal(to_np(dec_t), np.asarray(dec_j))
    _assert_bases_match(to_np(u_t), np.asarray(u_j))
    assert rel_fro(to_np(u_t) @ to_np(v_t), np.asarray(u_j) @ np.asarray(v_j)) <= 1e-4
    # orthogonal to the existing basis
    cross = np.einsum("nps,npr->nsr", np.asarray(existing), to_np(u_t))
    assert np.abs(cross).max() <= 1e-3


@pytest.mark.parametrize("tier", ["none", "gathered", "full"])
def test_fallback_rerun_tiers_match_jax(tier):
    n = 16
    blocks = windowed_blocks(n=n, seed=2)[..., :WL]
    rng = np.random.default_rng(3)
    u_r = rng.standard_normal((n, B * B, RANK)).astype(np.float32)
    dec_r = (rng.random((n, RANK)) > 0.5).astype(np.int32)
    is_zero = np.zeros(n, bool)
    if tier == "gathered":
        is_zero[5] = True                       # 1 <= cap = 2
    elif tier == "full":
        is_zero[[0, 3, 4, 9, 15]] = True        # 5 > cap
    n_zero, cap = int(is_zero.sum()), max(1, n // 8)
    kw = dict(max_rank=RANK, temporal_avg_factor=TAF, spatial_avg_factor=SAF,
              spatial_threshold=THRESHOLDS[0], temporal_threshold=THRESHOLDS[1])
    with _jax_override():
        u_j, dec_j = je._fallback_rerun(
            jnp.asarray(blocks), jax.random.split(jax.random.PRNGKey(4), n), jnp.asarray(u_r),
            jnp.asarray(dec_r), jnp.asarray(is_zero), jnp.int32(n_zero), cap,
            spatial_denoiser=je.identity, temporal_denoiser=je.identity, **kw,
        )
    args = (t32(blocks), _sketches(n)[0], t32(u_r), torch.as_tensor(dec_r),
            torch.as_tensor(is_zero), n_zero)
    u_t, dec_t = te._fallback_rerun(*args, cap, **kw)
    np.testing.assert_array_equal(to_np(dec_t), np.asarray(dec_j))
    _assert_bases_match(to_np(u_t), np.asarray(u_j))
    keep = ~is_zero
    np.testing.assert_array_equal(to_np(u_t)[keep], u_r[keep])
    # the capped gather gives the all-blocks tier's output
    u_full, dec_full = te._fallback_rerun(*args, n, **kw)
    np.testing.assert_allclose(to_np(u_t), to_np(u_full), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to_np(dec_t), to_np(dec_full))


@pytest.mark.parametrize("thresholds,mcf", [
    (THRESHOLDS, 1), ((0.5, 1.0), 1), ((1e9, 1e9), 1), ((0.9, 1.4), 2),
])
def test_windowed_pmd_batched_matches_jax(thresholds, mcf, monkeypatch):
    n = 8
    blocks = windowed_blocks(n=n, seed=4)
    with _jax_override():
        res_j = je.windowed_pmd_batched(
            jnp.asarray(blocks), jax.random.PRNGKey(6), WL, RANK, *thresholds, mcf, TAF, SAF
        )
    calls = []
    residual = te.single_residual_block_md_batched
    monkeypatch.setattr(te, "single_residual_block_md_batched",
                        lambda *a, **k: calls.append(1) or residual(*a, **k))
    res_t = te.windowed_pmd_batched(
        t32(blocks), _sketches(n, T // WL), WL, RANK, *thresholds, mcf, TAF, SAF
    )
    counts = np.asarray(res_j.counts)
    np.testing.assert_array_equal(to_np(res_t.counts), counts)
    assert res_t.windows_run == 1 + len(calls)
    if counts.min() < RANK:
        assert res_t.windows_run == T // WL     # no early stop while a block has room
    _assert_bases_match(to_np(res_t.spatial), np.asarray(res_j.spatial))
    prod_t = to_np(res_t.spatial) @ to_np(res_t.temporal)
    prod_j = np.asarray(res_j.spatial) @ np.asarray(res_j.temporal)
    assert rel_fro(prod_t, prod_j) <= 1e-4


def test_windowed_pmd_stops_early_once_every_block_is_full():
    blocks = windowed_blocks(n=4, seed=5)
    res = te.windowed_pmd_batched(t32(blocks), _sketches(4, 3), WL, RANK, 1e9, 1e9, 1, TAF, SAF)
    assert res.windows_run == 1 and bool((res.counts == RANK).all())
    flat = to_np(flatten_fov(t32(blocks)))
    np.testing.assert_allclose(
        to_np(res.temporal), np.einsum("nps,npt->nst", to_np(res.spatial), flat), atol=1e-3
    )


def test_window_geometry_matches_jax():
    for wl, t, f in [(80, 240, 4), (100, 400, 5), (2000, 4000, 10), (97, 400, 10), (500, 300, 7)]:
        got = te.effective_window_length(wl, t, f)
        assert got == je.effective_window_length(wl, t, f)
        assert te.window_count(t, got) == len(range(0, t, got))
    with pytest.raises(ValueError, match="sketches shape"):
        te.windowed_pmd_batched(t32(windowed_blocks(n=2)), _sketches(2, 2), WL, RANK,
                                1e9, 1e9, 1, TAF, SAF)
    # a mesh must be a 1-D DeviceMesh over every rank (parallel.make_mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        te.windowed_pmd_batched(t32(windowed_blocks(n=2)), _sketches(2, 3), WL, RANK,
                                1e9, 1e9, 1, TAF, SAF, mesh=object())
