"""The option probes of ``tests/torch_parity_cases.py`` on the CPU, as
``tests/test_torch_card_parity.py`` runs its grids (the two files split
the JAX runs across two workers): (b) each committed JAX result under
``tests/golden/torch_parity/`` is what the JAX package computes now
(1e-6), and (c) the port, run by ``chip_smoke.py`` phase 14's own
``parity_run`` with ``device="cpu"``, meets it at the CPU tests' bars
(1e-4 relative Frobenius through ``reconstruct_frames`` and slicing,
images rtol 1e-4, equal ``pipeline_ranks`` and kept rank). The options:
``temporal_avg_factor`` 3, ``compute_normalizer=False``, ``frame_range``
1000 on a 300-frame movie, ``block_batch_size`` 7 and
``welch_compat="reference"``, each test named by its case, every case's
thresholds pinned at (1e9, 1e9) in both packages."""

import pytest

from _torch_util import assert_fixture_is_current, assert_port_meets_fixture, run_parity_cases

CASES = ("temporal_avg_3", "no_normalizer", "frame_range_gt_t", "block_batch_7",
         "welch_reference")


@pytest.fixture(scope="module")
def option_runs():
    return run_parity_cases(CASES)


@pytest.mark.parametrize("name", CASES)
def test_committed_fixture_is_the_jax_result(name, option_runs):
    jax_pmd, record, _ = option_runs[name]
    assert_fixture_is_current(name, jax_pmd, record["thresholds"], None)


@pytest.mark.parametrize("name", CASES)
def test_port_meets_committed_fixture(name, option_runs):
    assert_port_meets_fixture(name, option_runs[name][2])
