"""The port's main path as a whole against the committed golden fixture: the
twin of tests/test_golden.py on ``device="cpu"``, with the same injected
sketch, pinned thresholds, ``welch_compat="reference"`` and
``final_rank_tol=0``. Tolerance: reconstruction <= 1e-5 relative Frobenius,
mean/var images rtol 1e-4."""

import os

import numpy as np
import pytest

from _torch_util import rel_fro, to_np

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_golden.npz")
SKETCHES = os.path.join(os.path.dirname(__file__), "golden", "torch_port_sketches.npz")


def _make_movie():
    """MUST match tests/test_golden.py _make_movie()."""
    rng = np.random.default_rng(55)
    T, d1, d2, R = 500, 40, 36, 4
    spatial = rng.random((d1 * d2, R)).astype(np.float32)
    temporal = rng.standard_normal((R, T)).astype(np.float32)
    temporal *= np.asarray([8.0, 6.0, 4.5, 3.0], np.float32)[:, None]
    movie = (spatial @ temporal).T.reshape(T, d1, d2)
    movie += 1e-4 * rng.standard_normal(movie.shape).astype(np.float32)
    return movie.astype(np.float32), T, R


def _jax_sketch(shape):
    import jax

    return np.asarray(jax.random.normal(jax.random.PRNGKey(1234), shape))


def _committed_sketch(shape):
    return np.load(SKETCHES)["x".join(str(int(s)) for s in shape)]


@pytest.fixture(scope="module")
def golden_run():
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    movie, T, R = _make_movie()
    saved = port_pipeline.threshold_heuristic
    port_pipeline.threshold_heuristic = lambda *a, **k: (1e9, 1e9)
    try:
        with sketch_override(_jax_sketch):
            pmd = port_pipeline.localmd_decomposition(
                movie, (16, 16), frame_range=T, max_components=R,
                background_rank=2, temporal_avg_factor=4,
                compute_normalizer=True, welch_compat="reference",
                seed=0, final_rank_tol=0.0, device="cpu",
            )
    finally:
        port_pipeline.threshold_heuristic = saved
    return pmd, np.load(GOLDEN, allow_pickle=True)


def test_full_pipeline_matches_golden_1e5(golden_run):
    pmd, golden = golden_run
    recon = pmd[:, :, :]
    assert rel_fro(recon, golden["recon"]) <= 1e-5
    np.testing.assert_allclose(pmd.mean_img, golden["mean_img"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pmd.var_img, golden["noise_var_img"], rtol=1e-4)


def test_reconstruct_frames_matches_golden_1e5(golden_run):
    """The K3 route (plain twin on the CPU) reproduces the same movie."""
    pmd, golden = golden_run
    recon = to_np(pmd.reconstruct_frames(np.arange(pmd.shape[0])))
    assert rel_fro(recon, golden["recon"]) <= 1e-5
    sub = to_np(pmd.reconstruct_frames([3, 499, 250]))
    np.testing.assert_allclose(sub, recon[[3, 499, 250]], rtol=1e-5, atol=1e-5)


def test_committed_sketches_are_the_jax_draws():
    """chip_smoke.py injects the committed arrays on machines without jax."""
    with np.load(SKETCHES) as data:
        assert len(data.files) >= 1
        for key in data.files:
            shape = tuple(int(s) for s in key.split("x"))
            np.testing.assert_array_equal(data[key], _jax_sketch(shape).astype(np.float32))
    assert _committed_sketch((500, 12)).shape == (500, 12)


def test_golden_loads_through_port_npz_loader():
    from localmd_tpu_torch import load_decomposition

    golden = np.load(GOLDEN, allow_pickle=True)
    view = load_decomposition(GOLDEN, device="cpu")
    np.testing.assert_allclose(view[:, :, :], golden["recon"], atol=2e-3)
    np.testing.assert_allclose(to_np(view.reconstruct_frames([0, 7])), golden["recon"][[0, 7]], atol=2e-3)
