"""The configurations on which the PyTorch port is held to the JAX package's
numbers, on the CPU and on the card.

Numpy only: ``chip_smoke.py`` reads this module on a machine without jax,
``tests/golden/generate_torch_parity.py`` runs each case through the JAX
package and commits the result under ``tests/golden/torch_parity/``, and
the tier-1 tests hold the port to those files. Each case rebuilds its
movie bit for bit from a seed (``movie``), takes the same injected sketch
in both packages (``sketch``) and the same call options (``options``).

Thresholds: a case without ``thresholds`` pins ``threshold_heuristic`` to
(1e9, 1e9) in both packages, so every block keeps ``max_components``; a
multi-window case (``window_chunks``) pins both to the JAX package's
Monte-Carlo for its block and window size; ``"jax"`` lets the JAX package
run its own Monte-Carlo and pins the port to its result; ``"injected"``
does the same in the generator and on the card, while the CPU test runs
the port's Monte-Carlo on the JAX package's noise draws. The values the
port is pinned to are stored in ``cases.json``.
"""

import numpy as np

SETTINGS = dict(max_components=6, background_rank=2, temporal_avg_factor=5, seed=0)
PINNED = (1e9, 1e9)

# tests/test_torch_pipeline.py's cases: (a) order C, (b) uint16, (c) a
# 76-frame statistics tail, (d) rank_prune on odd 15x15 blocks, (e) four
# windows of the residual stage, then (f) the call options
CASES = {
    "order_c": dict(shape=(600, 60, 52), dtype="float32", order="C", frame_range=600, blocks=(20, 20)),
    "uint16": dict(shape=(600, 60, 52), dtype="uint16", order="F", frame_range=600, blocks=(20, 20)),
    "tail_1100": dict(shape=(1100, 40, 36), dtype="float32", order="F", frame_range=500, blocks=(16, 16)),
    "rank_prune": dict(shape=(700, 60, 52), dtype="float32", order="F", frame_range=500,
                       blocks=(15, 15), rank_prune=True),
    "multi_window_f32": dict(shape=(800, 48, 40), dtype="float32", order="F", frame_range=400,
                             blocks=(16, 16), window_chunks=100, noise=0.3),
    "multi_window_u16": dict(shape=(800, 48, 40), dtype="uint16", order="F", frame_range=400,
                             blocks=(16, 16), window_chunks=100, noise=0.3),
}
# the call options, each on a golden-sized noisy movie
OPTION_BASE = dict(shape=(500, 40, 36), dtype="float32", order="F", frame_range=500,
                   blocks=(16, 16), noise=0.3)
CASES.update({
    "pixel_weighting": dict(OPTION_BASE, pixel_weighting=True),
    "max_failures_1": dict(OPTION_BASE, max_consecutive_failures=1, thresholds="jax"),
    "max_failures_2": dict(OPTION_BASE, max_consecutive_failures=2, thresholds="jax"),
    "frame_batch_size": dict(OPTION_BASE, frame_batch_size=128, thresholds="jax"),
    # T is not the crop's 500: the background rSVD's sketch is (T, k) for
    # T <= 1000, and ``draws`` tells the rank-prune matrix by its rows
    "rank_prune_factor": dict(OPTION_BASE, shape=(600, 40, 36), rank_prune=True,
                              rank_prune_factor=0.5),
    "sim_conf": dict(OPTION_BASE, sim_conf=10.0, sim_iters=24, thresholds="injected"),
})
PIPELINE_CASES = tuple(CASES)
# the configurations no other port test runs through both packages
CASES.update({
    # a regular grid: the banded Gram, the cell V route, the coset placement
    "regular_48": dict(OPTION_BASE, shape=(500, 48, 48)),
    # int16 with negative samples: K1 reading int16
    "int16_negative": dict(OPTION_BASE, dtype="int16"),
    # odd geometry: a 57 x 43 FOV of 20 x 12 blocks, snapped tails both
    # ways, on the first cases' near-noiseless construction (its 212 kept
    # components at noise 0.3 would take 0.87 MB of the fixtures' 8)
    "nonsquare_odd": dict(shape=(600, 57, 43), dtype="float32", order="F", frame_range=600,
                          blocks=(20, 12)),
    "spatial_avg_1": dict(OPTION_BASE, spatial_avg_factor=1),
    "spatial_avg_3": dict(OPTION_BASE, shape=(500, 48, 48), blocks=(24, 24), spatial_avg_factor=3),
    "temporal_avg_3": dict(OPTION_BASE, temporal_avg_factor=3),
    "no_normalizer": dict(OPTION_BASE, compute_normalizer=False),
    "frame_range_gt_t": dict(OPTION_BASE, shape=(300, 40, 36), frame_range=1000),
    "block_batch_7": dict(OPTION_BASE, block_batch_size=7),
    "one_block": dict(OPTION_BASE, shape=(500, 16, 16)),
    # K1 in reference mode (nperseg = T), as the golden fixture runs it
    "welch_reference": dict(OPTION_BASE, welch_compat="reference"),
})
NEW_CASES = tuple(name for name in CASES if name not in PIPELINE_CASES)
MULTI_WINDOW = tuple(name for name, case in CASES.items() if "window_chunks" in case)
# the case keys passed on to localmd_decomposition as they are
OPTIONS = ("max_consecutive_failures", "frame_batch_size", "rank_prune_factor", "sim_conf",
           "sim_iters", "spatial_avg_factor", "temporal_avg_factor", "compute_normalizer",
           "block_batch_size", "welch_compat")


def make_low_rank_movie(rank, dims, rng=None, noise=0.0):
    """A copy of ``tests/conftest.py``'s ``make_low_rank_movie`` (which
    imports jax): a rank-``rank`` (T, d1, d2) float32 movie of smooth
    spatial and temporal factors, optional additive noise."""
    rng = rng or np.random.default_rng(0)
    t, d1, d2 = dims
    spatial = rng.random((d1, d2, rank))
    for _ in range(4):
        spatial = 0.2 * (
            spatial
            + np.roll(spatial, 1, 0) + np.roll(spatial, -1, 0)
            + np.roll(spatial, 1, 1) + np.roll(spatial, -1, 1)
        )
    spatial = spatial.reshape(d1 * d2, rank)
    temporal = rng.random((rank, t))
    for _ in range(3):
        temporal = 0.5 * temporal + 0.25 * (
            np.roll(temporal, 1, 1) + np.roll(temporal, -1, 1)
        )
    movie = (spatial @ temporal).T.reshape((t, d1, d2))
    if noise:
        movie = movie + noise * rng.standard_normal(movie.shape)
    return movie.astype(np.float32)


def to_uint16(movie):
    return np.clip(np.rint(movie * 2000.0 + 500.0), 0, 65535).astype(np.uint16)


def to_int16(movie):
    """Around a negative offset, so that the noisy movies hold negative
    samples."""
    return np.clip(np.rint(movie * 2000.0 - 300.0), -32768, 32767).astype(np.int16)


def movie(name):
    case = CASES[name]
    out = make_low_rank_movie(4, case["shape"], rng=np.random.default_rng(3),
                              noise=case.get("noise", 1e-4))
    if case["dtype"] == "uint16":
        return to_uint16(out)
    if case["dtype"] == "int16":
        return to_int16(out)
    return out


def sketch(shape):
    """The draw both packages take in place of every Gaussian sketch."""
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


def options(name):
    """The keyword arguments of ``localmd_decomposition`` after the movie
    and the block shape (no ``device``)."""
    case = CASES[name]
    opts = dict(
        frame_range=case["frame_range"], order=case["order"],
        rank_prune=case.get("rank_prune", False), window_chunks=case.get("window_chunks"),
        **SETTINGS,
    )
    opts.update((k, case[k]) for k in OPTIONS if k in case)
    if case.get("pixel_weighting"):
        opts["pixel_weighting"] = np.random.default_rng(5).uniform(
            0.5, 2.0, case["shape"][1:]).astype(np.float32)
    return opts


def crop_frames(name):
    """Frames of the temporal crop: the rows of the rank-prune matrix."""
    opts = options(name)
    t = min(opts["frame_range"], CASES[name]["shape"][0])
    return t // opts["temporal_avg_factor"] * opts["temporal_avg_factor"]


def prune_shape(name, pipeline_ranks):
    """The rank-prune matrix's shape, from the JAX run's ranks
    (pipeline.py:1287-1290: min(total rank + background, crop) x factor
    columns)."""
    crop = crop_frames(name)
    factor = CASES[name].get("rank_prune_factor", 0.33)
    return (crop, int(min(pipeline_ranks["pre_reduction"], crop) * factor))


def draws(name, prune_matrix=None):
    """The port's draw for ``sketch_override``: the sketch, and for a
    ``rank_prune`` case the JAX key tree's rank-prune matrix, told by its
    (crop frames, m) shape (so such a case's T is not its crop)."""
    if not CASES[name].get("rank_prune"):
        return sketch
    crop = crop_frames(name)

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if len(shape) == 2 and shape[0] == crop:
            if shape != prune_matrix.shape:
                raise ValueError(f"{name}: rank-prune draw {shape}, stored {prune_matrix.shape}")
            return prune_matrix
        return sketch(shape)

    return draw
