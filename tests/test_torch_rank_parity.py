"""Both packages keep the same rank on bench.make_movie's white movie.

The movie is bench.py's construction (bench.py:23-63; rank-16 white
factors plus N(0, 1) noise, uint16 as clip(40 x + 1000)) at 200 x 200 x
1024, made with numpy, under bench.py's second-leg settings (blocks 40,
frame_range 512, max_components 20, background_rank 15,
temporal_avg_factor 10; bench.py:365-390) without ``rank_prune``. The
thresholds are pinned and the same sketch is injected into both packages.
White factors look like noise to the roughness test, so the kept rank
hangs on components at the threshold's edge: this is the case where the
two could part.

Measured on seeds 0-3 of this movie: ``pipeline_ranks`` are equal, and the
16 singular values of the movie's signal (s / s0 > 1e-2) agree to ~1e-5.
Everything below them is the float32 floor of the factorized SVD (s / s0
about 6e-3 and down, the two packages up to 14 % apart): which of its
directions survive depends on Gram eigenvalues within a few per cent of
the 1e-6 * lambda_0 cut (seed 0: 1.017e-6 in JAX, 0.999e-6 in the port),
so the kept rank can differ by one (59 vs 58 on seeds 0 and 2, equal on
1 and 3). Tolerance: ``pipeline_ranks`` equal; the signal's singular
values equal in number and rtol 1e-3; the kept rank within one."""

import numpy as np
import pytest

import _torch_util  # noqa: F401  (pins torch's CPU threads: the floor's rounding)

SHAPE = (1024, 200, 200)
SETTINGS = dict(frame_range=512, max_components=20, background_rank=15,
                temporal_avg_factor=10, rank_prune=False, seed=0)
BLOCKS = (40, 40)
THRESHOLDS = (1.3889, 2.3168)


def white_movie(seed=0):
    t, d1, d2 = SHAPE
    rng = np.random.default_rng(seed)
    spatial = rng.standard_normal((d1 * d2, 16)).astype(np.float32)
    temporal = rng.standard_normal((16, t)).astype(np.float32)
    movie = (spatial @ temporal).T.reshape(t, d1, d2)
    movie += rng.standard_normal(movie.shape, dtype=np.float32)
    return np.clip(movie * 40.0 + 1000.0, 0, 65535).astype(np.uint16)


def _sketch(shape):
    return np.random.default_rng(77).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    import jax.numpy as jnp

    import localmd_tpu.pipeline as jax_pipeline
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu.ops.linalg import sketch_override as jax_override
    from localmd_tpu_torch.utils.random import sketch_override as port_override

    movie = white_movie()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_pipeline, "threshold_heuristic", lambda *a, **k: THRESHOLDS)
        mp.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: THRESHOLDS)
        with jax_override(lambda shape: jnp.asarray(_sketch(shape))):
            jax_pmd = jax_pipeline.localmd_decomposition(movie, BLOCKS, **SETTINGS)
        with port_override(_sketch):
            port_pmd = port_pipeline.localmd_decomposition(movie, BLOCKS, device="cpu", **SETTINGS)
    finally:
        mp.undo()
    return jax_pmd, port_pmd


def test_pipeline_ranks_equal(both):
    jax_pmd, port_pmd = both
    assert port_pmd.pipeline_ranks == jax_pmd.pipeline_ranks
    # "final" is the width of s, as in the JAX package; the kept count is rank
    assert port_pmd.pipeline_ranks["final"] == np.shape(port_pmd._s_src)[0]
    assert abs(port_pmd.rank - jax_pmd.rank) <= 1
    assert 16 < port_pmd.rank <= port_pmd.pipeline_ranks["final"]


def test_signal_singular_values_agree(both):
    jax_pmd, port_pmd = both
    s_j = np.asarray(jax_pmd._s_src, np.float64)
    s_t = np.asarray(port_pmd._s_src, np.float64)
    signal_j = s_j[s_j > 1e-2 * s_j[0]]
    signal_t = s_t[s_t > 1e-2 * s_t[0]]
    assert len(signal_j) == len(signal_t) == 16
    np.testing.assert_allclose(signal_t, signal_j, rtol=1e-3)
