"""K4's plain twin (``ops.linalg.jacobi_eigh_plain``) against float64
LAPACK, the JAX package's ``jacobi_eigh`` (ops/linalg.py:147) and K4's own
Pallas body (scripts/ablate_jacobi_kernel.py ``make_kernel``) run in
interpret mode, plus the routing of ``eigh_descending``. The twin rotates
by the inner angle, as the Pallas body does; ``jacobi_eigh`` takes the
outer one when a_qq < a_pp and has not converged on a repeated spectrum at
k >= 30, so it is compared on the other spectra.

Vectors are compared only through what they determine (reconstructions,
projectors onto well-separated eigenspaces): with repeated eigenvalues they
are not unique. Tolerances: eigenvalues 1e-5 * |lambda_max|;
reconstruction ``V diag(lambda) V^T`` 1e-5 relative Frobenius;
``max|V^T V - I|`` 1e-5. Against the Pallas body, whose V drifts off
orthonormal, eigenvalues 1e-5 and reconstruction 1e-4."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, t32, to_np

from localmd_tpu.ops import linalg as jl
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops import linalg as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECTRA = ("random_psd", "rank_deficient", "repeated", "diagonal")


def make_sym(kind: str, n: int, k: int, seed: int = 0) -> np.ndarray:
    """A batch of (n, k, k) symmetric float32 test matrices."""
    rng = np.random.default_rng(seed)
    if kind == "random_psd":
        a = rng.standard_normal((n, k, k + 3))
    elif kind == "rank_deficient":              # the Gram of a k x 10 matrix
        a = rng.standard_normal((n, k, 10))
    elif kind == "repeated":
        q, _ = np.linalg.qr(rng.standard_normal((n, k, k)))
        lam = np.repeat(np.array([9.0, 4.0, 1.0, 0.25]), -(-k // 4))[:k]
        return ((q * lam[None, None, :]) @ np.swapaxes(q, 1, 2)).astype(np.float32)
    elif kind == "diagonal":
        return np.stack([np.diag(rng.random(k) * 5) for _ in range(n)]).astype(np.float32)
    else:
        raise ValueError(kind)
    return (a @ np.swapaxes(a, 1, 2)).astype(np.float32)


def _recon(vals, vecs):
    vals = np.asarray(vals, np.float64)
    vecs = np.asarray(vecs, np.float64)
    return (vecs * vals[..., None, :]) @ np.swapaxes(vecs, -1, -2)


def _check_decomposition(vals, vecs, sym):
    vals, vecs = to_np(vals), to_np(vecs)
    k = sym.shape[-1]
    lam_max = np.abs(sym).sum(axis=-1).max()
    assert np.all(np.diff(vals, axis=-1) <= 1e-6 * lam_max)
    assert rel_fro(_recon(vals, vecs), sym) <= 1e-5
    assert np.abs(np.swapaxes(vecs, -1, -2) @ vecs - np.eye(k)).max() <= 1e-5


@pytest.mark.parametrize("kind", SPECTRA)
@pytest.mark.parametrize("k", [11, 20, 30, 64])
def test_plain_twin_holds_the_bars(k, kind):
    """Against float64 LAPACK at the JAX package's sweep count."""
    sym = make_sym(kind, 6, k)
    vals_t, vecs_t = tl.jacobi_eigh_plain(t32(sym))
    _check_decomposition(vals_t, vecs_t, sym)
    vals_ref = np.linalg.eigvalsh(sym.astype(np.float64))[..., ::-1]
    assert np.abs(to_np(vals_t) - vals_ref).max() <= 1e-5 * np.abs(vals_ref).max()


@pytest.mark.parametrize("kind", ["random_psd", "rank_deficient", "diagonal"])
@pytest.mark.parametrize("k", [11, 20, 30, 64])
def test_plain_twin_matches_jax_jacobi(k, kind):
    sym = make_sym(kind, 6, k)
    vals_t, vecs_t = tl.jacobi_eigh_plain(t32(sym))
    vals_j, vecs_j = jl.jacobi_eigh(jnp.asarray(sym), tl.jacobi_sweeps(k))
    lam_max = float(np.abs(np.asarray(vals_j)).max())
    assert np.abs(to_np(vals_t) - np.asarray(vals_j)).max() <= 1e-5 * lam_max
    assert rel_fro(_recon(to_np(vals_t), to_np(vecs_t)), _recon(vals_j, vecs_j)) <= 1e-5
    if kind == "random_psd":
        # the top eigenvector is isolated: its projector is unique
        top_t = to_np(vecs_t)[..., :1]
        top_j = np.asarray(vecs_j)[..., :1]
        assert rel_fro(top_t @ np.swapaxes(top_t, -1, -2), top_j @ np.swapaxes(top_j, -1, -2)) <= 1e-4


@pytest.mark.parametrize("k", [30, 64])
def test_inner_angle_converges_where_jax_outer_angle_stalls(k):
    """Why K4 and its twin take the inner angle (as K4's Pallas body does)
    and not ops/linalg.py's ``0.5 atan2(2 a_pq, a_qq - a_pp)``: with a
    repeated spectrum the JAX package's Jacobi has not converged after its
    10 (k <= 32) or 12 sweeps, the inner angle has."""
    sym = make_sym("repeated", 6, k)
    vals_j, vecs_j = jl.jacobi_eigh(jnp.asarray(sym), tl.jacobi_sweeps(k))
    vals_t, vecs_t = tl.jacobi_eigh_plain(t32(sym))
    assert rel_fro(_recon(vals_j, vecs_j), sym) > 1e-5
    assert rel_fro(_recon(to_np(vals_t), to_np(vecs_t)), sym) <= 1e-5


@pytest.mark.parametrize("apq_mag", [0.0, 1e-15, 1e-5, 1.0, 1e5, 1e15])
def test_tangent_rotation_is_the_atan2_inner_angle(apq_mag):
    """``_rotation``'s tangent form (K4's and its Pallas body's) against
    theta = 0.5 atan2(2 a_pq sign(d), |d|) in float64 on the same float32
    d = a_qq - a_pp: (c, s) within 1e-6 absolute over a grid with a_pq = 0,
    d = 0, d < 0 and |d| / |a_pq| from 1e-30 to 1e30; |theta| <= pi/4."""
    mags = [0.0, 1e-15, 1e-5, 1.0, 1e5, 1e15]
    diag = np.array(sorted({s * m for m in mags for s in (-1.0, 1.0)}), np.float32)
    app, aqq, sgn_pq = np.meshgrid(diag, diag, [-1.0, 1.0], indexing="ij")
    app, aqq = app.ravel(), aqq.ravel()
    apq = (sgn_pq.ravel() * apq_mag).astype(np.float32)
    c, s = (to_np(x) for x in tl._rotation(t32(app), t32(aqq), t32(apq)))
    d = (aqq - app).astype(np.float64)                       # float32 difference, as the form takes it
    theta = 0.5 * np.arctan2(2.0 * apq.astype(np.float64) * np.where(d >= 0, 1.0, -1.0), np.abs(d))
    theta = np.where(apq == 0, 0.0, theta)
    assert (d == 0).any() and (d < 0).any() and (d > 0).any()
    np.testing.assert_allclose(c, np.cos(theta), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s, np.sin(theta), rtol=0, atol=1e-6)
    assert (np.abs(np.arctan2(s.astype(np.float64), c)) <= np.pi / 4 + 1e-7).all()
    if apq_mag == 0.0:
        assert (c == 1).all() and (s == 0).all()


def test_schedule_rotates_every_pair_once_per_sweep():
    for k in (2, 12, 30, 64):
        sched = tl._jacobi_tables(k)
        assert sched.shape == (k - 1, k // 2, 2)
        pairs = {tuple(p) for step in sched for p in step}
        assert len(pairs) == k * (k - 1) // 2
        assert all(p < q for p, q in pairs)
        for step in sched:
            assert sorted(step.reshape(-1).tolist()) == list(range(k))
        np.testing.assert_array_equal(sched, jl._jacobi_tables(k)[0])


@pytest.mark.parametrize("kp", [2, 12, 20, 26, 30, 32])
def test_k4_register_pairs_follow_the_schedule(kp):
    """K4 keeps its pairs in registers (csrc/jacobi_eigh.cu): slot s holds
    the circle elements at positions s and kp - 1 - s, each moved one step
    by ``next_element``; the look-ahead warp reads element x's rotation of
    the step before from the slot of ``prev_position`` of x's position; a
    V lane follows its element's position by ``next_position``. Those
    recurrences, written out here, give the plain twin's schedule over
    two sweeps."""
    m1, h = kp - 1, kp // 2
    next_element = lambda e: 0 if e == 0 else (m1 if e == 1 else e - 1)
    next_position = lambda p: 0 if p == 0 else (1 if p == m1 else p + 1)
    prev_position = lambda p: 0 if p == 0 else (m1 if p == 1 else p - 1)
    slot_of = lambda p: p if p < h else m1 - p
    sched = tl._jacobi_tables(kp)
    slots = [[0 if s == 0 else s, m1 - s] for s in range(h)]
    pos = list(range(kp))
    for step in range(2 * m1):
        pairs = sched[step % m1]
        assert [tuple(sorted(xy)) for xy in slots] == [tuple(p) for p in pairs]
        for e in range(kp):
            s = slot_of(pos[e])
            assert e in pairs[s]                          # a V lane finds its pair
        before = [tuple(sorted(xy)) for xy in slots]
        slots = [[next_element(x), next_element(y)] for x, y in slots]
        pos = [next_position(p) for p in pos]
        for s, (x, y) in enumerate(slots):                # the look-ahead's sources
            assert x in before[slot_of(prev_position(s))]
            assert y in before[slot_of(prev_position(m1 - s))]


@pytest.fixture(scope="module")
def pallas_body(tmp_path_factory):
    """K4's Pallas body from its measurement script. The script points a
    JAX compilation cache at a directory of its own on import; that is
    redirected into a temporary directory and the setting restored."""
    scripts = os.path.join(ROOT, "scripts")
    prev_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    prev_cfg = jax.config.jax_compilation_cache_dir
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path_factory.mktemp("jax_cache"))
    sys.path.insert(0, scripts)
    try:
        import ablate_jacobi_kernel
    finally:
        sys.path.remove(scripts)
        if prev_env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = prev_env
        jax.config.update("jax_compilation_cache_dir", prev_cfg)
    return ablate_jacobi_kernel


def _run_pallas_body(mod, sym: np.ndarray, sweeps: int, symmetrize: bool):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n, k, _ = sym.shape
    p_oh = jnp.asarray(mod._jacobi_matmul_tables(k))
    n_steps = p_oh.shape[0]
    return pl.pallas_call(
        mod.make_kernel(n_steps, sweeps, symmetrize),
        grid=(1,),
        in_specs=[
            pl.BlockSpec((n, k, k), lambda i: (0, 0, 0)),
            pl.BlockSpec((n_steps, k, k), lambda i: (0, 0, 0)),
        ],
        out_specs=(
            pl.BlockSpec((n, k), lambda i: (0, 0)),
            pl.BlockSpec((n, k, k), lambda i: (0, 0, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((n, k), jnp.float32),
            jax.ShapeDtypeStruct((n, k, k), jnp.float32),
        ),
        scratch_shapes=[pltpu.VMEM((n, k, k), jnp.float32), pltpu.VMEM((n, k, k), jnp.float32)],
        interpret=True,
    )(jnp.asarray(sym), p_oh)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_plain_twin_matches_pallas_body_in_interpret_mode(pallas_body, symmetrize):
    sym = make_sym("random_psd", 8, 30, seed=5)
    vals_p, vecs_p = (np.asarray(x) for x in _run_pallas_body(pallas_body, sym, 10, symmetrize))
    vals_t, vecs_t = tl.jacobi_eigh_plain(t32(sym))
    lam_max = float(np.abs(vals_p).max())
    assert np.abs(np.sort(vals_p, axis=-1)[..., ::-1] - to_np(vals_t)).max() <= 1e-5 * lam_max
    assert rel_fro(_recon(vals_p, vecs_p), sym) <= 1e-4
    assert rel_fro(_recon(to_np(vals_t), to_np(vecs_t)), _recon(vals_p, vecs_p)) <= 1e-4


def test_eigh_descending_routes_small_cuda_eighs_to_k4():
    assert tl.uses_jacobi("cuda", 11)
    assert tl.uses_jacobi(torch.device("cuda", 0), 64)
    assert not tl.uses_jacobi("cuda", 65)
    assert not tl.uses_jacobi("cpu", 30)
    assert not tl.uses_jacobi("meta", 30)


def test_eigh_descending_cpu_is_lapack_and_launches_nothing():
    sym = t32(make_sym("random_psd", 3, 30, seed=7))
    before = kernels.launch_counts()
    vals, vecs = tl.eigh_descending(sym)
    ref_vals, ref_vecs = (torch.from_numpy(x) for x in np.linalg.eigh(sym.numpy()))
    assert torch.equal(vals, ref_vals.flip(-1)) and torch.equal(vecs, ref_vecs.flip(-1))
    assert kernels.launch_counts() == before


def test_eigh_descending_k4_branch_keeps_batch_shape(monkeypatch):
    """With the route forced (the card is absent here), eigh_descending
    reaches the K4 wrapper, which on a CPU tensor takes the plain twin."""
    sym = make_sym("random_psd", 6, 11, seed=8).reshape(2, 3, 11, 11)
    monkeypatch.setattr(tl, "uses_jacobi", lambda device, k: True)
    vals, vecs = tl.eigh_descending(t32(sym))
    ref_vals, ref_vecs = tl.jacobi_eigh_plain(t32(sym.reshape(6, 11, 11)))
    assert vals.shape == (2, 3, 11) and vecs.shape == (2, 3, 11, 11)
    assert torch.equal(vals.reshape(6, 11), ref_vals) and torch.equal(vecs.reshape(6, 11, 11), ref_vecs)


def test_k4_wrapper_takes_plain_twin_on_cpu_and_checks_its_input():
    sym = t32(make_sym("repeated", 4, 20, seed=9))
    before = kernels.launch_counts()
    vals, vecs = kernels.jacobi_eigh(sym)
    ref_vals, ref_vecs = tl.jacobi_eigh_plain(sym)
    assert torch.equal(vals, ref_vals) and torch.equal(vecs, ref_vecs)
    assert kernels.launch_counts() == before
    for bad in (sym.double(), sym[0], torch.zeros(2, 65, 65), torch.zeros(2, 4, 5)):
        with pytest.raises(ValueError, match="jacobi_eigh"):
            kernels.jacobi_eigh(bad)
