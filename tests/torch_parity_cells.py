"""The three other configurations ``bench_torch.py`` times, at full width,
on which the PyTorch port on the card is held to the JAX package's numbers.

Each case is a cell of ``bench_torch.py`` (``CELLS`` and
``NORTHSTAR_CELLS`` over ``MAIN_CONFIG``), with its shape, dtype, blocks
and options and nothing cut:

- ``voltage_f32``: 256 x 256 x 20000 float32, the JAX package's voltage
  workload (scripts/bench_workloads.py:34-42): 4000 init frames in two
  2000-frame windows, so the block stage runs a residual window;
- ``1024_u16``: 1024 x 1024 x 4096 uint16, bench.py's second leg
  (bench.py:365-390): blocks of 40, a grid with snapped tails (2601 blocks);
- ``northstar_u16``: 512 x 512 x 30000 uint16 read from a raw file, the
  north star (bench_northstar.py:118-131).

The movie is the rank-4, noise-0.3 construction of ``torch_parity_full``
(smooth factors from ``default_rng(MOVIE_SEED)``), drawn in chunks of
``CHUNK_FRAMES`` frames: chunk ``c`` takes its float32 noise from its own
generator, the ``c``-th child of ``SeedSequence(MOVIE_SEED)``, so its bytes
depend neither on the chunks a caller asks for nor on the threads that
fill them. Every Gaussian draw of both packages, the rank-prune matrix
included, is ``sketch(shape)`` (the rank-prune matrix of the north star
would take 22 MB to store).

Numpy only: ``chip_smoke.py`` phase 16 reads this module on a machine
without jax, ``tests/golden/generate_torch_parity_cells.py`` runs each case
through the JAX package and commits what the card is held to under
``tests/golden/torch_parity_cells/``. The reconstruction is kept as
``torch_parity_full.fingerprint`` keeps it: spatial Gaussian probes psi,
and for T > 4096 a temporal probe Phi (T, 512) in place of the full
(64, T) ``psi^T Y``; at more than 512 x 512 pixels the per-pixel arrays
(the images, ``Y omega``) are kept at a fixed pixel sample, and the
images are also seen through psi. ``errors`` compares two results so kept;
the generator also records the JAX package's spread, its result with
``nudged_sketch`` against its result.
"""

import hashlib
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch_parity_cases as cases
import torch_parity_full as full

NOISE = full.NOISE
MOVIE_SEED = full.MOVIE_SEED
RANK = 4
CHUNK_FRAMES = 32               # frames of one noise generator
# bench_torch.MAIN_CONFIG, the base of every cell
BASE = dict(frame_range=1024, max_components=20, background_rank=15, temporal_avg_factor=10,
            sim_iters=250, seed=0, rank_prune=True)
CELL_CASES = {
    "voltage_f32": dict(shape=(20000, 256, 256), dtype="float32", blocks=(32, 32), source="memory",
                        options=dict(BASE, frame_range=4000, window_chunks=2000, rank_prune=False)),
    "1024_u16": dict(shape=(4096, 1024, 1024), dtype="uint16", blocks=(40, 40), source="memory",
                     options=dict(BASE, frame_range=512)),
    "northstar_u16": dict(shape=(30000, 512, 512), dtype="uint16", blocks=(32, 32), source="raw",
                          options=dict(BASE, frame_range=4096, num_workers=4)),
}
RANK_PRUNE_FACTOR = full.RANK_PRUNE_FACTOR
MAX_CONSECUTIVE_FAILURES = full.MAX_CONSECUTIVE_FAILURES
FINGERPRINT_CHUNK = 256         # frames a frames_fn call returns (1 GiB at 1024 x 1024)
DISK_RESERVE_BYTES = 1e9        # free disk left beside a written movie
SPREAD_SEED = 17                # which sketch entries ``nudged_sketch`` moves

sketch = cases.sketch
convert = full.convert
# the fingerprint is phase 15's, with its temporal probe and pixel sample
probes = full.probes
pixel_sample = full.pixel_sample
fingerprint_errors = full.fingerprint_errors


def nudged_sketch(shape, seed=SPREAD_SEED):
    """``sketch(shape)`` with half its entries, drawn from ``seed``, moved
    one float32 ulp up: the draw of the JAX package's run against itself
    (its spread)."""
    out = sketch(shape)
    move = np.random.default_rng(seed).random(out.shape) < 0.5
    out[move] = np.nextafter(out[move], np.float32(np.inf))
    return out


def options(name):
    """The keyword arguments of ``localmd_decomposition`` after the movie
    and the block shape (no device)."""
    return dict(CELL_CASES[name]["options"])


def crop_frames(name):
    """Frames of the init crop (the rank-prune matrix's rows)."""
    opts = options(name)
    t = min(opts["frame_range"], CELL_CASES[name]["shape"][0])
    return t // opts["temporal_avg_factor"] * opts["temporal_avg_factor"]


def n_windows(name):
    """Windows of the block stage (``engine.effective_window_length``)."""
    opts = options(name)
    crop, f = crop_frames(name), opts["temporal_avg_factor"]
    wl = min(opts.get("window_chunks") or crop, crop)
    wl = max(f, wl // f * f)
    return len(range(0, crop, wl))


def n_blocks(name):
    """Blocks of the case's grid: tiles at half-block strides, the tails
    snapped flush to the far edges (``ops.tiling.block_grid``)."""
    _, d1, d2 = CELL_CASES[name]["shape"]
    b1, b2 = CELL_CASES[name]["blocks"]

    def count(d, b):
        s = b // 2
        return len(range(0, d - b + 1, s)) + ((d - b) % s != 0)

    return count(d1, b1) * count(d2, b2)


# ---------------------------------------------------------------------------
# the movie
# ---------------------------------------------------------------------------

def factors(dims, seed=MOVIE_SEED, rank=RANK):
    """(spatial (rank, d1 d2), temporal (rank, T)) float32: the smooth
    factors of ``torch_parity_full.low_rank_movie``."""
    t, d1, d2 = dims
    rng = np.random.default_rng(seed)
    spatial = rng.random((d1, d2, rank))
    for _ in range(4):
        spatial = 0.2 * (spatial + np.roll(spatial, 1, 0) + np.roll(spatial, -1, 0)
                         + np.roll(spatial, 1, 1) + np.roll(spatial, -1, 1))
    temporal = rng.random((rank, t))
    for _ in range(3):
        temporal = 0.5 * temporal + 0.25 * (np.roll(temporal, 1, 1) + np.roll(temporal, -1, 1))
    spatial = np.ascontiguousarray(spatial.reshape(d1 * d2, rank).T, np.float32)
    return spatial, np.ascontiguousarray(temporal, np.float32)


class Movie:
    """A case's movie, made on demand: ``frames(lo, hi)`` returns frames
    [lo, hi) in the case dtype, filled chunk by chunk on ``threads``
    threads. Chunk ``c`` (frames [c C, (c + 1) C), C = ``CHUNK_FRAMES``) is
    noise * N(0, 1) from its own generator plus the rank-``RANK`` product,
    added one factor at a time in float32, then ``convert``-ed."""

    def __init__(self, shape, dtype="float32", noise=NOISE, seed=MOVIE_SEED, threads=None):
        self.shape, self.dtype, self.noise = tuple(shape), np.dtype(dtype), np.float32(noise)
        self.threads = threads or min(8, os.cpu_count() or 1)
        self.spatial, self.temporal = factors(self.shape, seed)
        n_chunks = -(-self.shape[0] // CHUNK_FRAMES)
        self.seeds = np.random.SeedSequence(seed).spawn(n_chunks)

    def _fill(self, c, out, lo, hi):
        """Frames [lo, hi) of chunk ``c`` into ``out`` (hi - lo, d1, d2)."""
        c0 = c * CHUNK_FRAMES
        n = min(self.shape[0], c0 + CHUNK_FRAMES) - c0
        buf = np.empty((n, self.spatial.shape[1]), np.float32)
        tmp = np.empty_like(buf)
        np.random.default_rng(self.seeds[c]).standard_normal(dtype=np.float32, out=buf)
        buf *= self.noise
        for k in range(self.spatial.shape[0]):
            buf += np.multiply(self.temporal[k, c0:c0 + n, None], self.spatial[k], out=tmp)
        part = buf[lo - c0:hi - c0].reshape(out.shape)
        if self.dtype == np.uint16:
            # cases.to_uint16, in place
            part *= np.float32(2000.0)
            part += np.float32(500.0)
            np.clip(np.rint(part, out=part), 0, 65535, out=part)
            np.copyto(out, part, casting="unsafe")
        else:
            out[...] = convert(self.dtype, part)

    def frames(self, lo, hi, out=None):
        t, d1, d2 = self.shape
        if not 0 <= lo <= hi <= t:
            raise IndexError(f"frames [{lo}, {hi}) of {t}")
        out = np.empty((hi - lo, d1, d2), self.dtype) if out is None else out
        jobs = []
        for c in range(lo // CHUNK_FRAMES, -(-hi // CHUNK_FRAMES)):
            a, b = max(lo, c * CHUNK_FRAMES), min(hi, (c + 1) * CHUNK_FRAMES)
            jobs.append((c, out[a - lo:b - lo], a, b))
        if self.threads == 1 or len(jobs) == 1:
            for job in jobs:
                self._fill(*job)
        else:
            with ThreadPoolExecutor(self.threads) as pool:
                list(pool.map(lambda job: self._fill(*job), jobs))
        return out

    def array(self):
        return self.frames(0, self.shape[0])

    def write(self, path, frames_per_write=1024):
        """Write the movie to ``path`` as a raw file, ``frames_per_write``
        frames at a time (after ``check_disk``): (seconds making the
        frames, seconds writing them)."""
        t, d1, d2 = self.shape
        check_disk(os.path.dirname(os.path.abspath(path)), t * d1 * d2 * self.dtype.itemsize)
        buf = np.empty((min(frames_per_write, t), d1, d2), self.dtype)
        built = written = 0.0
        with open(path, "wb") as fh:
            for lo in range(0, t, frames_per_write):
                hi = min(t, lo + frames_per_write)
                t0 = time.perf_counter()
                self.frames(lo, hi, out=buf[:hi - lo])
                t1 = time.perf_counter()
                fh.write(memoryview(buf[:hi - lo]).cast("B"))
                written += time.perf_counter() - t1
                built += t1 - t0
        return built, written


def movie(name, threads=None):
    case = CELL_CASES[name]
    return Movie(case["shape"], case["dtype"], threads=threads)


def check_disk(directory, nbytes):
    """Raise unless ``directory`` has room for ``nbytes`` and
    ``DISK_RESERVE_BYTES`` beside them."""
    free = shutil.disk_usage(directory).free
    if free < nbytes + DISK_RESERVE_BYTES:
        raise RuntimeError(f"{directory}: {free / 1e9:.1f} GB free, the movie needs "
                           f"{nbytes / 1e9:.1f} GB and {DISK_RESERVE_BYTES / 1e9:.0f} GB beside it")


def digest(mov):
    """sha256 of the movie's first and last chunks: the construction
    checked before a run on another machine."""
    t = mov.shape[0]
    h = hashlib.sha256()
    for lo in (0, (t - 1) // CHUNK_FRAMES * CHUNK_FRAMES):
        h.update(mov.frames(lo, min(t, lo + CHUNK_FRAMES)).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------

keep_decisions = full.keep_decisions
kept_counts = full.kept_counts


def window_counts(spatial, temporal, thresholds, max_rank, max_failures=MAX_CONSECUTIVE_FAILURES):
    """The kept count of each block after each window, from the statistics
    (windows, blocks, components): window w packs its kept components
    behind the earlier windows' and drops those past ``max_rank``
    (``engine.pack_components``)."""
    counts = np.zeros(np.shape(spatial)[1], np.int64)
    out = []
    for sp, tp in zip(spatial, temporal):
        counts = np.minimum(counts + kept_counts(sp, tp, thresholds, max_failures), max_rank)
        out.append(counts)
    return np.stack(out)


GRAM_CUT = 1e-6     # the factorized SVD keeps Gram eigenvalues past this share of the largest


def gram_kept(vals):
    """The Gram directions a factorized SVD keeps from its eigenvalues."""
    vals = np.asarray(vals, np.float64)
    return int((vals > max(vals[0], 0.0) * GRAM_CUT).sum())


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

def image_probe(mean_img, var_img, psi):
    """(PROBES, 2): psi^T of each image, flattened in C order."""
    return np.stack([psi.T @ np.asarray(img, np.float64).ravel() for img in (mean_img, var_img)], 1)


def image_errors(mean, var, ref_mean, ref_var):
    """The largest relative error of each statistics image (the mean's
    floored at 1e-5 of its largest value)."""
    ref_mean, ref_var = np.asarray(ref_mean), np.asarray(ref_var)
    return dict(
        mean=float(np.max(np.abs(mean - ref_mean)
                          / (np.abs(ref_mean) + 1e-5 * np.abs(ref_mean).max()))),
        var=float(np.max(np.abs(var - ref_var) / np.abs(ref_var))),
    )


def errors(got, want, s_prefix=False):
    """Relative errors of one result's arrays (as the fixture holds them)
    against another's: the fingerprint (``psi_y`` also naming psi^T Y Phi),
    ``s`` (inf where the lengths differ, unless ``s_prefix``: then over the
    shorter), the images at the stored pixels and through psi."""
    err = fingerprint_errors(got, want)
    if "psi_y_phi" in err:
        err["psi_y"] = err.pop("psi_y_phi")
    s, s_ref = (np.asarray(x, np.float64) for x in (got["s"], want["s"]))
    if s_prefix:
        n = min(len(s), len(s_ref))
        s, s_ref = s[:n], s_ref[:n]
    err["s"] = (float(np.linalg.norm(s - s_ref) / np.linalg.norm(s_ref))
                if s.shape == s_ref.shape else float("inf"))
    err.update(image_errors(got["mean_img"], got["var_img"], want["mean_img"], want["var_img"]))
    probe, ref_probe = (np.asarray(x, np.float64) for x in (got["image_probe"], want["image_probe"]))
    for i, key in enumerate(("mean_probe", "var_probe")):
        err[key] = float(np.linalg.norm(probe[:, i] - ref_probe[:, i]) / np.linalg.norm(ref_probe[:, i]))
    return err
