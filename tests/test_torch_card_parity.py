"""The configurations ``chip_smoke.py`` phase 14 holds the card to, on the
CPU: (a) every case's movie, made by ``tests/torch_parity_cases.py``
(numpy only, for the machine with the card), is the movie its CPU test
makes with ``conftest.make_low_rank_movie`` and its conversion; (b) each
committed JAX result under ``tests/golden/torch_parity/`` is what the JAX
package computes now (1e-6), so a fixture cannot go stale; (c) the port,
run by phase 14's own ``chip_smoke.parity_run`` with ``device="cpu"``,
meets each fixture at the CPU tests' bars (1e-4 relative Frobenius
through ``reconstruct_frames`` and slicing, images rtol 1e-4, equal
``pipeline_ranks`` and kept rank).

Here (b) and (c) cover the grids and the dtype no other port test runs
through both packages: a regular 48 x 48 grid, int16 with negative
samples, odd geometry (57 x 43, blocks 20 x 12), ``spatial_avg_factor`` 1
and 3, and one block, each test named by its case;
``tests/test_torch_card_parity_options.py`` covers the option probes and
``tests/test_torch_pipeline.py`` its own cases from its module fixture.
Every case's thresholds are pinned at (1e9, 1e9) in both packages, every
sketch is the case's numpy draw."""

import os

import numpy as np
import pytest

from _torch_util import (
    PARITY_DIR, assert_fixture_is_current, assert_port_meets_fixture, parity_draws,
    parity_records, run_parity_cases,
)
from conftest import make_low_rank_movie

import torch_parity_cases as parity
from chip_smoke import parity_run

FIXTURE_BUDGET_BYTES = 8_000_000
CASES = ("regular_48", "int16_negative", "nonsquare_odd", "spatial_avg_1", "spatial_avg_3",
         "one_block")


def _cpu_test_movie(case):
    """The CPU tests' construction, written out here apart from the module
    under test: uint16 as test_torch_pipeline.py has made it, int16 as
    clip(rint(2000 x - 300))."""
    movie = make_low_rank_movie(4, case["shape"], rng=np.random.default_rng(3),
                                noise=case.get("noise", 1e-4))
    if case["dtype"] == "uint16":
        movie = np.clip(np.rint(movie * 2000.0 + 500.0), 0, 65535).astype(np.uint16)
    elif case["dtype"] == "int16":
        movie = np.clip(np.rint(movie * 2000.0 - 300.0), -32768, 32767).astype(np.int16)
    return movie


@pytest.mark.parametrize("name", list(parity.CASES))
def test_case_movie_is_the_cpu_tests_movie(name):
    movie = parity.movie(name)
    assert np.array_equal(movie, _cpu_test_movie(parity.CASES[name]))
    assert movie.dtype == np.dtype(parity.CASES[name]["dtype"])


def test_int16_case_has_negative_samples():
    assert parity.movie("int16_negative").min() < 0


def test_sketch_is_a_fresh_seeded_draw_per_shape():
    for shape in ((7, 3), (500, 12)):
        want = np.random.default_rng(1234).standard_normal(shape).astype(np.float32)
        assert np.array_equal(parity.sketch(shape), want)
    assert np.array_equal(parity.sketch((7, 3)), parity.sketch((7, 3)))


def test_case_list_covers_every_configuration():
    import test_torch_card_parity_options
    import test_torch_pipeline

    assert set(test_torch_pipeline.CASES) == set(parity.PIPELINE_CASES)
    probes = {"nonsquare_odd", "spatial_avg_1", "spatial_avg_3", "temporal_avg_3",
              "no_normalizer", "frame_range_gt_t", "block_batch_7", "one_block"}
    assert set(parity.NEW_CASES) == probes | {"regular_48", "int16_negative", "welch_reference"}
    split = CASES + test_torch_card_parity_options.CASES
    assert sorted(split) == sorted(parity.NEW_CASES)


def test_fixtures_cover_every_case_within_their_budget():
    records = parity_records()
    assert list(records) == list(parity.CASES)
    names = set(os.listdir(PARITY_DIR))
    assert names == {f"{name}.npz" for name in parity.CASES} | {"cases.json", "draws.npz"}
    total = sum(os.path.getsize(os.path.join(PARITY_DIR, n)) for n in names)
    assert total <= FIXTURE_BUDGET_BYTES
    assert set(parity_draws()) == {n for n, c in parity.CASES.items() if c.get("rank_prune")}


@pytest.mark.parametrize("name,regular", [("regular_48", True), ("nonsquare_odd", False),
                                          ("order_c", False), ("one_block", True)])
def test_case_grids_take_the_intended_routes(name, regular):
    """regular_48 is a regular grid (the banded Gram and the cell V route
    run there on the card); the odd and snapped grids take K2."""
    from localmd_tpu_torch.ops.tiling import block_grid

    case = parity.CASES[name]
    grid = block_grid(*case["shape"][1:], case["blocks"])
    assert (grid.cell_geometry() is not None) == regular


@pytest.fixture(scope="module")
def grid_runs():
    return run_parity_cases(CASES)


@pytest.mark.parametrize("name", CASES)
def test_committed_fixture_is_the_jax_result(name, grid_runs):
    jax_pmd, record, _ = grid_runs[name]
    assert_fixture_is_current(name, jax_pmd, record["thresholds"], None)


@pytest.mark.parametrize("name", CASES)
def test_port_meets_committed_fixture(name, grid_runs):
    assert_port_meets_fixture(name, grid_runs[name][2])


def test_regular_48_with_every_route_meets_fixture(monkeypatch):
    """The regular case with the card's routes forced on here: the coset
    block stage, the banded Gram and the cell V projection each run, and the
    result meets the JAX fixture."""
    import localmd_tpu_torch.blocksparse as tb
    import localmd_tpu_torch.engine as te
    import localmd_tpu_torch.pipeline as tp

    calls = {"coset_stage": 0, "banded_gram": 0, "cell_vproj": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod, flag in ((te, "COSET_STAGE"), (tb, "BANDED_GRAM"), (tb, "COSET_VPROJ")):
        monkeypatch.setattr(mod, flag, True)
    monkeypatch.setattr(tp, "window0_coset_stage", spy("coset_stage", te.window0_coset_stage))
    monkeypatch.setattr(tb, "_banded_gram_quad", spy("banded_gram", tb._banded_gram_quad))
    monkeypatch.setattr(tb, "coset_vproj_chunk", spy("cell_vproj", tb.coset_vproj_chunk))
    pmd = parity_run("regular_48", "cpu", parity_records(), parity_draws())
    assert all(calls.values()), calls
    assert_port_meets_fixture("regular_48", pmd)
