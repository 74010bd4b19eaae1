"""Shared helpers for the PyTorch-port tests (tests/test_torch_*.py).

The port's tests feed the same numpy inputs to a ``localmd_tpu`` function
and its ``localmd_tpu_torch`` counterpart and compare the results. Tier-1
runs with six xdist workers, so each worker's torch uses two threads.
"""

import json
import os

import numpy as np
import torch

torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_fro(a, b) -> float:
    """||a - b||_F / ||b||_F in float64."""
    a = to_np(a).astype(np.float64)
    b = to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t32(x) -> torch.Tensor:
    """float32 CPU tensor of ``x``."""
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


# the JAX package's committed results on tests/torch_parity_cases.py's cases
# (tests/golden/generate_torch_parity.py), which chip_smoke.py phase 14
# holds the card to
PARITY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "torch_parity")


def parity_records() -> dict:
    with open(os.path.join(PARITY_DIR, "cases.json")) as f:
        return json.load(f)


def parity_draws() -> dict:
    return dict(np.load(os.path.join(PARITY_DIR, "draws.npz")))


def run_parity_cases(names) -> dict:
    """Each named case through the JAX package, as
    ``tests/golden/generate_torch_parity.py`` runs it, and through
    ``chip_smoke.py`` phase 14's runner with ``device="cpu"``: name ->
    (JAX PMDArray, its record, the port's PMDArray)."""
    import sys

    sys.path.insert(0, os.path.dirname(PARITY_DIR))
    import generate_torch_parity
    from chip_smoke import parity_run

    records, draws = parity_records(), parity_draws()
    out = {}
    for name in names:
        jax_pmd, record = generate_torch_parity.run_jax(name)
        out[name] = (jax_pmd, record, parity_run(name, "cpu", records, draws))
    return out


def assert_fixture_is_current(name, jax_pmd, thresholds, prune_matrix):
    """The committed fixture is the JAX package's result now: the
    reconstruction and the images within 1e-6 relative Frobenius, equal
    ranks, thresholds within rtol 1e-6 and the rank-prune draw bit-equal."""
    from localmd_tpu import load_decomposition

    stored = load_decomposition(os.path.join(PARITY_DIR, f"{name}.npz"))
    assert rel_fro(stored[:, :, :], jax_pmd[:, :, :]) <= 1e-6
    assert rel_fro(stored.mean_img, jax_pmd.mean_img) <= 1e-6
    assert rel_fro(stored.var_img, jax_pmd.var_img) <= 1e-6
    record = parity_records()[name]
    assert record["pipeline_ranks"] == jax_pmd.pipeline_ranks
    assert record["rank"] == jax_pmd.rank
    np.testing.assert_allclose(record["thresholds"], thresholds, rtol=1e-6)
    draws = parity_draws()
    if prune_matrix is None:
        assert name not in draws
    else:
        assert np.array_equal(draws[name], prune_matrix)


def assert_port_meets_fixture(name, pmd):
    """The port's result against the committed JAX result, at the bars
    chip_smoke.py phase 14 holds the card to: every frame through
    ``reconstruct_frames`` and through slicing within 1e-4 relative
    Frobenius, ``mean_img``/``var_img`` within rtol 1e-4, equal
    ``pipeline_ranks`` and kept rank."""
    from localmd_tpu_torch import load_decomposition

    ref = load_decomposition(os.path.join(PARITY_DIR, f"{name}.npz"), device=None)
    want = ref[:, :, :]
    assert rel_fro(pmd.reconstruct_frames(np.arange(pmd.shape[0])), want) <= 1e-4
    assert rel_fro(pmd[:, :, :], want) <= 1e-4
    np.testing.assert_allclose(pmd.var_img, ref.var_img, rtol=1e-4)
    np.testing.assert_allclose(pmd.mean_img, ref.mean_img, rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref.mean_img).max()))
    record = parity_records()[name]
    assert pmd.pipeline_ranks == record["pipeline_ranks"]
    assert pmd.rank == record["rank"]
