"""The widefield configuration's grid on the CPU: a one-side-snapped block
grid (``pmdbench/configs/widefield_u16.json``: 540x640, blocks 32), here at
54x64x600 with blocks 16, where 54 - 16 = 38 is no multiple of 8 just as
540 - 32 = 508 is no multiple of 16. Such a grid is not regular
(``BlockGrid.cell_geometry()`` is None), so the call takes K2 (its plain
twin here), the canvas Gram and, with ``engine.COSET_STAGE`` forced on as
on the card, the coset stage with a remainder of blocks on no lattice.

The decomposition is held to the benchmark's plain reference
(``pmdbench.reference``, float64) on the movie the benchmark makes
(``pmdbench.movie.Movie``, the configuration's widefield recipe), and the
route counters of ``pipeline_cache`` are read. Two calls in one module
fixture: the snapped movie with the coset stage on and off."""

import json
import os

import pytest
import torch

from localmd_tpu_torch import engine, localmd_decomposition
from localmd_tpu_torch.ops.tiling import block_grid
from pmdbench import harness
from pmdbench.movie import Movie

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**33 + 7
SETTINGS = dict(frame_range=600, max_components=8, background_rank=15, temporal_avg_factor=10,
                rank_prune=True, seed=0, sim_iters=10)
BLOCKS = (16, 16)

# The reference's numbers (``harness.decomposition_numbers``) and each
# tolerance at this size, with its reason. Measured on two seeds at this
# size: mean 1.2e-5, noise 1.7e-5-2.3e-5, recon 2.1e-4-8.1e-4, vreg
# 3.3e-5-8.4e-5, source 0.36-0.45.
TOLERANCES = {
    # float32 sums of 600 frames of ~8000 counts against float64, in noise
    # sigmas; the card's limit is 1e-3
    "mean_gap": 1e-4,
    # the float32 Welch estimate of 600 frames (the card's 40000 frames read
    # under 1e-5); a TF32 DFT reads 2.4e-5 on the card at full size
    "noise_gap": 1e-4,
    # the float32 factorization and regression against the float64 least
    # squares in the same basis: the float32 Gram leaves U P off orthonormal
    # columns (the north star's limit on the card is 2e-2; the widefield
    # cell's 40000 frames read up to 3.9e-2 there and have no limit)
    "recon_gap": 5e-3,
    # the float32 regression (K2's twin) against the float64 projection;
    # the card's limit is 2e-3, TF32 products read 8e-3 there
    "vreg_gap": 1e-3,
    # the share of a diffuse source's footprint outside the basis: at
    # 54x64 each source (sigma 2.7-6.3 px) spans one or two blocks, whose
    # rank test keeps its core and leaves out its tails under the noise;
    # losing a source outright reads near 1
    "source_gap": 0.5,
}


def _config() -> dict:
    with open(os.path.join(ROOT, "pmdbench", "configs", "widefield_u16.json")) as fh:
        return json.load(fh)


def _run(shape, coset) -> dict:
    cfg = _config()
    movie = Movie(dict(cfg["movie"], shape=list(shape), piece_frames=128), SEED, "cpu")
    frames = movie.to_card()
    saved = engine.COSET_STAGE
    engine.COSET_STAGE = coset
    try:
        pmd = localmd_decomposition(frames, BLOCKS, device="cpu", **SETTINGS)
    finally:
        engine.COSET_STAGE = saved
    dc = harness.Decomposition(harness.factors(pmd), movie.shape, torch.device("cpu"))
    ref = harness.reference_pass([dc], movie.frames, movie.shape, torch.device("cpu"))["float64"]
    numbers = harness.decomposition_numbers([dc], ref, movie.footprints())
    return dict(cache=dict(pmd.pipeline_cache), numbers=numbers, ranks=dict(pmd.pipeline_ranks))


@pytest.fixture(scope="module")
def runs():
    return {"coset": _run((600, 54, 64), True), "gather": _run((600, 54, 64), False)}


def test_the_configurations_grid_is_not_regular():
    cfg = _config()
    _, d1, d2 = cfg["movie"]["shape"]
    assert block_grid(d1, d2, tuple(cfg["settings"]["block_sizes"])).cell_geometry() is None
    assert block_grid(54, 64, BLOCKS).cell_geometry() is None


@pytest.mark.parametrize("number", list(TOLERANCES))
@pytest.mark.parametrize("name", ["coset", "gather"])
def test_passes_the_reference(runs, name, number):
    assert runs[name]["numbers"][number] <= TOLERANCES[number], runs[name]["numbers"]


def _k2_route(cache, frames):
    assert cache["vreg.k2_calls"] >= 1 and cache["vreg.cell_calls"] == 0
    assert cache["vreg.k2_frames"] == frames
    assert cache["vreg.k2_width"] >= 1
    assert cache["fsvd.banded"] == 0


def _coset(runs):
    _k2_route(runs["coset"]["cache"], 600)
    assert runs["coset"]["cache"]["vreg.k2_width"] == runs["coset"]["ranks"]["reduced"]


def _coset_remainder(runs):
    # the snapped last block row (start 38) lies on no lattice: its 7 blocks
    assert runs["coset"]["cache"]["blocks.remainder"] == 7


def _gather(runs):
    _k2_route(runs["gather"]["cache"], 600)
    assert runs["gather"]["cache"]["blocks.remainder"] == 0


COUNTER_CASES = {"coset": _coset, "coset_remainder": _coset_remainder, "gather": _gather}


@pytest.mark.parametrize("case", list(COUNTER_CASES))
def test_route_counters(runs, case):
    COUNTER_CASES[case](runs)
