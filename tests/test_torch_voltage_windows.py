"""The voltage configuration's multi-window block stage on the CPU
(``pmdbench/configs/voltage_f32.json``: 256x256 float32, blocks 32,
frame_range 20000 in ten 2000-frame windows), here at 64x64x3000 float32
with blocks 16 (a regular grid: 64 = 16 + 6 * 8, as 256 = 32 + 14 * 16),
frame_range 2000 in eight 250-frame windows and max_components 8. The
recipe's 60 cells per 256x256 become 4 at 64x64, the same density: at 60
every block fills its 8 slots in the first window and the loop stops there.

The decomposition is held to the benchmark's plain reference
(``pmdbench.reference``, float64) on the movie the benchmark makes
(``pmdbench.movie.Movie``), the block stage's counters of
``pipeline_cache`` are read against a one-window call of the same movie,
and ``engine.windowed_pmd_batched``'s output for a small batch is checked
in float64 against the loop's two invariants."""

import json
import os

import pytest
import torch

from localmd_tpu_torch import engine, localmd_decomposition
from localmd_tpu_torch.ops.linalg import DEFAULT_OVERSAMPLES
from localmd_tpu_torch.ops.tiling import block_grid, extract_patches, flatten_fov
from pmdbench import harness
from pmdbench.movie import Movie

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**33 + 11
SHAPE = (3000, 64, 64)
BLOCKS = (16, 16)
SETTINGS = dict(frame_range=2000, max_components=8, background_rank=15, temporal_avg_factor=10,
                rank_prune=False, seed=0, sim_iters=10, num_workers=0)
WINDOW = 250

# The reference's numbers (``harness.decomposition_numbers``) and each
# tolerance at this size, with its reason. Measured on three seeds at this
# size, eight windows and one: mean 4.8e-6-5.1e-6, noise 1.4e-6-2.1e-6,
# recon and vreg 3.7e-5-4.5e-5, source 0.13-0.18.
TOLERANCES = {
    # float32 sums of 3000 frames of ~2000 counts against float64, in noise
    # sigmas; the card's limit is 1e-3
    "mean_gap": 1e-4,
    # the float32 Welch estimate of 3000 frames against the float64 one; a
    # TF32 DFT reads 2.4e-5 on the card at full size
    "noise_gap": 1e-4,
    # the float32 factorization and regression against the float64 least
    # squares in the same basis (the north star's limit on the card: 2e-2)
    "recon_gap": 5e-3,
    # the float32 regression (K2's twin) against the float64 projection;
    # TF32 products read 8e-3 on the card
    "vreg_gap": 1e-3,
    # the share of a cell's footprint outside the basis: a cell of radius
    # 3-7 px spans up to four blocks, whose rank tests keep its core and
    # leave its tails under the noise; a cell lost outright reads near 1
    "source_gap": 0.4,
}


def _movie(seed=SEED) -> Movie:
    with open(os.path.join(ROOT, "pmdbench", "configs", "voltage_f32.json")) as fh:
        spec = json.load(fh)["movie"]
    return Movie(dict(spec, shape=list(SHAPE), piece_frames=256, n_cells=4), seed, "cpu")


def _run(movie, frames, window_chunks) -> dict:
    pmd = localmd_decomposition(frames, BLOCKS, device="cpu", window_chunks=window_chunks,
                                **SETTINGS)
    dc = harness.Decomposition(harness.factors(pmd), movie.shape, torch.device("cpu"))
    ref = harness.reference_pass([dc], movie.frames, movie.shape, torch.device("cpu"))["float64"]
    numbers = harness.decomposition_numbers([dc], ref, movie.footprints())
    return dict(cache=dict(pmd.pipeline_cache), numbers=numbers,
                windows=dict(pmd.pipeline_windows))


def _batch(frames, n=6, t=1000):
    """n standardized 16x16 patches of the movie's first t frames, the
    loop's sketches for windows of ``WINDOW`` frames, and the noise-null
    thresholds at that window, as the pipeline makes them."""
    x = frames[:t].permute(1, 2, 0).to(torch.float32)
    x = (x - x.mean(-1, keepdim=True)) / x.std(-1, keepdim=True)
    grid = block_grid(SHAPE[1], SHAPE[2], BLOCKS)
    blocks = extract_patches(x, grid.starts[:n], *BLOCKS)
    rank = SETTINGS["max_components"]
    gen = torch.Generator().manual_seed(5)
    sketches = torch.randn((t // WINDOW, n, WINDOW // 10, rank + DEFAULT_OVERSAMPLES),
                           generator=gen)
    thresholds = engine.threshold_heuristic((*BLOCKS, WINDOW), iters=40, generator=gen,
                                            device="cpu")
    return blocks, sketches, thresholds


@pytest.fixture(scope="module")
def runs():
    movie = _movie()
    frames = movie.to_card()
    out = {"windows": _run(movie, frames, WINDOW),
           "one": _run(movie, frames, SETTINGS["frame_range"])}
    blocks, sketches, thresholds = _batch(frames)
    rank = SETTINGS["max_components"]
    out["batch"] = (blocks, engine.windowed_pmd_batched(
        blocks, sketches, WINDOW, rank, *thresholds, 1, 10, 1))
    # a first window that keeps nothing: the first residual window re-runs
    # every block through the full kernel, which keeps each block's first
    # component whatever its test says (``filter_by_failures``), so no
    # later window re-runs any
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "_md_pack_step", lambda window, sk, acc, counts, *a: (acc, counts))
        out["empty_first"] = engine.windowed_pmd_batched(
            blocks, sketches, WINDOW, rank, *thresholds, 1, 10, 1)
    return out


def test_the_configuration_takes_the_window_loop():
    with open(os.path.join(ROOT, "pmdbench", "configs", "voltage_f32.json")) as fh:
        cfg = json.load(fh)
    _, d1, d2 = cfg["movie"]["shape"]
    st = cfg["settings"]
    assert block_grid(d1, d2, tuple(st["block_sizes"])).cell_geometry() is not None
    assert block_grid(*SHAPE[1:], BLOCKS).cell_geometry() is not None
    wl = engine.effective_window_length(st["window_chunks"], st["frame_range"],
                                        st["temporal_avg_factor"])
    assert engine.window_count(st["frame_range"], wl) == 10
    assert engine.window_count(SETTINGS["frame_range"], WINDOW) == 8


@pytest.mark.parametrize("number", list(TOLERANCES))
@pytest.mark.parametrize("name", ["windows", "one"])
def test_passes_the_reference(runs, name, number):
    assert runs[name]["numbers"][number] <= TOLERANCES[number], runs[name]["numbers"]


def _windows_counted(runs):
    cache, windows = runs["windows"]["cache"], runs["windows"]["windows"]
    assert windows["n_windows"] == 8
    assert cache["blocks.batches"] == len(windows["run_per_batch"]) >= 1
    assert cache["blocks.windows_run"] == sum(windows["run_per_batch"]) > cache["blocks.batches"]
    assert cache["blocks.fallback"] >= 0


def _one_window(runs):
    cache = runs["one"]["cache"]
    assert cache["blocks.windows_run"] == cache["blocks.batches"] >= 1
    assert cache["blocks.fallback"] == 0 and cache["blocks.remainder"] == 0


def _no_profiler_no_seconds(runs):
    for name in ("windows", "one"):
        assert "blocks.residual_s" not in runs[name]["cache"]


def _fallback_counts_the_reruns(runs):
    blocks, res = runs["batch"]
    assert res.fallback == 0
    empty = runs["empty_first"]
    assert empty.windows_run == blocks.shape[-1] // WINDOW
    assert empty.fallback == blocks.shape[0]
    assert bool((empty.counts >= 1).all())


COUNTER_CASES = {"windows_counted": _windows_counted, "one_window": _one_window,
                 "no_profiler_no_seconds": _no_profiler_no_seconds,
                 "fallback_counts_the_reruns": _fallback_counts_the_reruns}


@pytest.mark.parametrize("case", list(COUNTER_CASES))
def test_block_stage_counters(runs, case):
    COUNTER_CASES[case](runs)


def _columns_orthonormal(runs):
    # each block's kept columns, window 0's and the residual windows'
    # together, are orthonormal to float32 rounding: the residual windows'
    # components are orthogonal to the earlier ones
    _, res = runs["batch"]
    assert res.windows_run > 1
    acc = res.spatial.to(torch.float64)
    for b, k in enumerate(res.counts.tolist()):
        cols = acc[b, :, :k]
        gram = cols.T @ cols
        assert float((gram - torch.eye(k, dtype=torch.float64)).abs().max()) < 1e-4, b
        assert float(acc[b, :, k:].abs().sum()) == 0.0


def _temporal_is_the_projection(runs):
    # the temporal components are the columns' projection of the whole crop
    blocks, res = runs["batch"]
    proj = res.spatial.to(torch.float64).transpose(-1, -2) @ flatten_fov(blocks).to(torch.float64)
    gap = (res.temporal.to(torch.float64) - proj).norm() / proj.norm()
    assert float(gap) < 1e-5


INVARIANT_CASES = {"columns_orthonormal": _columns_orthonormal,
                   "temporal_is_the_projection": _temporal_is_the_projection}


@pytest.mark.parametrize("case", list(INVARIANT_CASES))
def test_window_loop_invariants(runs, case):
    INVARIANT_CASES[case](runs)
