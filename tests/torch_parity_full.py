"""The main path's own configuration at full width, on which the PyTorch
port on the card is held to the JAX package's numbers.

The configuration is bench.py's (bench.py:66-85): a 512 x 512 x 2048
movie, blocks of 32 x 32 (961 blocks), frame_range 1024, max_components
20, background_rank 15, temporal_avg_factor 10, sim_iters 250, seed 0,
rank_prune, order F. The movie is ``torch_parity_cases``'s construction
(rank 4, noise 0.3, ``default_rng(3)``) in float32 and through
``to_uint16``. Nothing is cut.

Numpy only: ``chip_smoke.py`` phase 15 reads this module on a machine
without jax, ``tests/golden/generate_torch_parity_full.py`` runs each case
through the JAX package and commits what the card is held to under
``tests/golden/torch_parity_full/``. A 2 GB reconstruction is not stored:
both sides keep its ``fingerprint``, the reconstruction seen through fixed
Gaussian probes (with a temporal probe past 4096 frames and a pixel sample
past 512 x 512 pixels, for ``torch_parity_cells``' longer and wider
movies; neither applies here).

Thresholds are ``"jax"``: the JAX package runs its own Monte-Carlo, and
the port is pinned to the values it recorded. The rank-prune matrix comes
from the JAX key tree and is stored once (both cases draw its shape).
"""

import numpy as np

import torch_parity_cases as cases

SHAPE = (2048, 512, 512)
BLOCKS = (32, 32)
NOISE = 0.3
MOVIE_SEED = 3
# the keyword arguments of localmd_decomposition after the movie and the
# block shape (no device)
OPTIONS = dict(frame_range=1024, max_components=20, background_rank=15, temporal_avg_factor=10,
               sim_iters=250, seed=0, block_batch_size=256, rank_prune=True, order="F")
FULL_CASES = {
    "full_512_f32": dict(shape=SHAPE, dtype="float32", blocks=BLOCKS),
    "full_512_u16": dict(shape=SHAPE, dtype="uint16", blocks=BLOCKS),
}
RANK_PRUNE_FACTOR = 0.33        # localmd_decomposition's default
MAX_CONSECUTIVE_FAILURES = 1    # localmd_decomposition's default
PROBES = 64                     # columns of the spatial probe
FINGERPRINT_SEED = 11
FINGERPRINT_CHUNK = 512         # frames a frames_fn call returns
FINGERPRINT_SLICE = 64          # frames taken to float64 at a time
PHI_FROM_T = 4096               # T above which psi^T Y is kept as psi^T Y Phi
PHI_COLUMNS = 512
SAMPLE_FROM_PIXELS = 512 * 512  # pixels above which per-pixel arrays are sampled
SAMPLE_PIXELS = 65536
SAMPLE_SEED = 13

sketch = cases.sketch


def convert(dtype, frames):
    """float32 frames in ``dtype``: the case conversion, elementwise."""
    if dtype == "uint16":
        return cases.to_uint16(frames)
    return frames.astype(np.dtype(dtype), copy=False)


def low_rank_movie(dims, dtype="float32", noise=NOISE, chunk=256, seed=MOVIE_SEED, rank=4):
    """``cases.make_low_rank_movie(rank, dims, default_rng(seed), noise)``
    in ``dtype``, bit for bit, built ``chunk`` frames at a time: numpy's
    Generator fills the noise stream in order, so the chunks draw what the
    whole array draws, and no float64 copy of the whole movie is held."""
    t, d1, d2 = dims
    rng = np.random.default_rng(seed)
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
    out = np.empty(dims, np.dtype(dtype))
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        frames = (spatial @ temporal[:, lo:hi]).T.reshape((hi - lo, d1, d2))
        if noise:
            frames = frames + noise * rng.standard_normal(frames.shape)
        out[lo:hi] = convert(dtype, frames.astype(np.float32))
    return out


def movie(name, chunk=256):
    case = FULL_CASES[name]
    return low_rank_movie(case["shape"], case["dtype"], chunk=chunk)


def crop_frames():
    """Frames of the temporal crop: the rows of the rank-prune matrix."""
    t = min(OPTIONS["frame_range"], SHAPE[0])
    return t // OPTIONS["temporal_avg_factor"] * OPTIONS["temporal_avg_factor"]


def prune_shape(pipeline_ranks):
    """The rank-prune matrix's shape from the JAX run's ranks
    (pipeline.py:1287-1290)."""
    crop = crop_frames()
    return (crop, int(min(pipeline_ranks["pre_reduction"], crop) * RANK_PRUNE_FACTOR))


def draws(prune_matrix):
    """The port's draw for ``sketch_override``: the JAX key tree's
    rank-prune matrix for its shape, the case's sketch for every other."""

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if shape == prune_matrix.shape:
            return prune_matrix
        return sketch(shape)

    return draw


def keep_decisions(spatial, temporal, thresholds):
    """Each component's keep decision: both roughness statistics below
    their thresholds (ops/roughness.py's ``evaluate_fitness``)."""
    return (np.asarray(spatial) < thresholds[0]) & (np.asarray(temporal) < thresholds[1])


def kept_counts(spatial, temporal, thresholds, max_failures=MAX_CONSECUTIVE_FAILURES):
    """Each block's kept count from its components' statistics (blocks,
    components): walking the decisions in order, a failure is kept until
    the ``max_failures``-th consecutive one (kept too) and nothing after
    it (the reference's filter, ops/roughness.py:134-151)."""
    counts = []
    for row in keep_decisions(spatial, temporal, thresholds):
        kept = failures = 0
        for ok in row:
            kept += 1
            failures = 0 if ok else failures + 1
            if failures == max_failures:
                break
        counts.append(kept)
    return np.asarray(counts)


def pixel_sample(n_pixels):
    """The pixels (C order) the per-pixel arrays are kept at: all of them
    up to ``SAMPLE_FROM_PIXELS``, else ``SAMPLE_PIXELS`` fixed ones."""
    if n_pixels <= SAMPLE_FROM_PIXELS:
        return np.arange(n_pixels)
    return np.sort(np.random.default_rng(SAMPLE_SEED).choice(n_pixels, SAMPLE_PIXELS,
                                                             replace=False))


def probes(shape, seed=FINGERPRINT_SEED):
    """dict of float64 Gaussians: ``psi`` (d1 d2, PROBES), ``omega`` (T,),
    and ``phi`` (T, PHI_COLUMNS) for T > PHI_FROM_T."""
    t, d1, d2 = shape
    rng = np.random.default_rng(seed)
    out = dict(psi=rng.standard_normal((d1 * d2, PROBES)), omega=rng.standard_normal(t))
    if t > PHI_FROM_T:
        out["phi"] = rng.standard_normal((t, PHI_COLUMNS))
    return out


def fingerprint(frames_fn, shape, seed=FINGERPRINT_SEED, chunk=FINGERPRINT_CHUNK, probe=None):
    """The reconstruction Y (d1 d2 pixels, C order, x T frames) seen through
    fixed probes, in float64: ``psi_y`` = psi^T Y (PROBES, T), or
    ``psi_y_phi`` = psi^T Y Phi (PROBES, PHI_COLUMNS) for T > PHI_FROM_T,
    and ``y_omega`` = Y omega at ``pixel_sample``. ``frames_fn(lo, hi)``
    returns frames [lo, hi) as an array of shape (hi - lo, d1, d2); it is
    called on ``chunk`` frames at a time, so the whole Y is never held."""
    t, d1, d2 = shape
    probe = probes(shape, seed) if probe is None else probe
    psi, omega, phi = probe["psi"], probe["omega"], probe.get("phi")
    psi_y = np.zeros((PROBES, PHI_COLUMNS)) if phi is not None else np.empty((PROBES, t))
    y_omega = np.zeros(d1 * d2)
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        frames = np.asarray(frames_fn(lo, hi))
        if frames.shape != (hi - lo, d1, d2):
            raise ValueError(f"frames_fn({lo}, {hi}) gave {frames.shape}")
        for a in range(lo, hi, FINGERPRINT_SLICE):
            b = min(hi, a + FINGERPRINT_SLICE)
            y = frames[a - lo:b - lo].reshape(b - a, d1 * d2).astype(np.float64)
            py = (y @ psi).T
            if phi is not None:
                psi_y += py @ phi[a:b]
            else:
                psi_y[:, a:b] = py
            y_omega += omega[a:b] @ y
    key = "psi_y_phi" if phi is not None else "psi_y"
    return {key: psi_y, "y_omega": y_omega[pixel_sample(d1 * d2)]}


def fingerprint_errors(got, want):
    """Relative errors of ``got``'s fingerprint against ``want``'s, for each
    key both hold: ||psi^T (Y1 - Y2)||_F / ||psi^T Y2||_F (``psi_y``, or
    through Phi ``psi_y_phi``) estimates the relative Frobenius error of
    the whole reconstruction; ``y_omega`` weighs every sampled pixel."""
    return {key: float(np.linalg.norm(np.asarray(got[key], np.float64) - want[key])
                       / np.linalg.norm(np.asarray(want[key], np.float64)))
            for key in ("psi_y", "psi_y_phi", "y_omega") if key in got and key in want}
