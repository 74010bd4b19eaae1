"""Write ``torch_port_sketches.npz``: the injected rSVD sketches of the golden
run, for machines without jax.

The golden fixture (``reference_golden.npz``) was made with every rSVD
sketch replaced by ``jax.random.normal(jax.random.PRNGKey(1234), shape)``
(see ``generate_golden.py``). torch cannot reproduce threefry, so this
script runs the PyTorch port on the golden configuration on the CPU under a
recording override, evaluates the jax draw for every shape the run asks for,
and stores them keyed ``"<rows>x<cols>"``. ``chip_smoke.py`` injects them
when it checks the port against the golden fixture on the GPU.

Run (needs jax): python tests/golden/generate_torch_port_sketches.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_port_sketches.npz")
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def make_movie():
    """MUST match tests/test_golden.py _make_movie()."""
    rng = np.random.default_rng(55)
    T, d1, d2, R = 500, 40, 36, 4
    spatial = rng.random((d1 * d2, R)).astype(np.float32)
    temporal = rng.standard_normal((R, T)).astype(np.float32)
    temporal *= np.asarray([8.0, 6.0, 4.5, 3.0], np.float32)[:, None]
    movie = (spatial @ temporal).T.reshape(T, d1, d2)
    movie += 1e-4 * rng.standard_normal(movie.shape).astype(np.float32)
    return movie.astype(np.float32), T, R


def sketch_key(shape) -> str:
    return "x".join(str(int(s)) for s in shape)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    draws = {}

    def recording(shape):
        key = sketch_key(shape)
        if key not in draws:
            draws[key] = np.asarray(
                jax.random.normal(jax.random.PRNGKey(1234), tuple(shape)), np.float32
            )
        return draws[key]

    movie, T, R = make_movie()
    saved = port_pipeline.threshold_heuristic
    port_pipeline.threshold_heuristic = lambda *a, **k: (1e9, 1e9)
    try:
        with sketch_override(recording):
            port_pipeline.localmd_decomposition(
                movie, (16, 16), frame_range=T, max_components=R,
                background_rank=2, temporal_avg_factor=4,
                compute_normalizer=True, welch_compat="reference",
                seed=0, final_rank_tol=0.0, device="cpu",
            )
    finally:
        port_pipeline.threshold_heuristic = saved
    np.savez_compressed(OUT, **draws)
    print(f"wrote {OUT}: {sorted(draws)}")


if __name__ == "__main__":
    main()
