"""Write ``torch_parity_cells/``: the JAX package's results on the three
other configurations ``bench_torch.py`` times, at full width
(``tests/torch_parity_cells.py``: voltage_f32 256 x 256 x 20000 float32 in
two windows, 1024_u16 1024 x 1024 x 4096 uint16 on blocks of 40, and
northstar_u16 512 x 512 x 30000 uint16 from a raw file), for machines
without jax.

Each case runs through ``localmd_tpu.localmd_decomposition`` on the CPU in
a process of its own (``--one``), with the seams of
``generate_torch_parity_full.py``: every sketch replaced by the numpy
sketch (``sketch_override``), the rank-prune matrix and the range-capture
sketch of ``subspace_eigh`` too (``jax.random.normal`` returns
``sketch(shape)`` there, as the port draws them), the
threshold Monte-Carlo spied (its cache emptied), the per-block kept counts
taken where the pipeline hands them to its checkpoint, and each block
component's roughness statistics taken in ``evaluate_fitness`` through a
``jax.debug.callback``. The callback is told, when it is traced, whether it
runs in the residual window (``single_residual_block_md_batched``) or in
the zero-count fallback (``_fallback_rerun``); ``pack_components`` reports
the counts after each window. On the CPU the JAX package decomposes
the blocks in gathered batches in block order (the last batch padded at
its end), so each window's first rows are the blocks'; the counts they
imply, window by window, are checked against the captured ones. The movie
is made in memory (``voltage_f32``, ``1024_u16``) or written to a raw file
in ``$TMPDIR`` and read through ``localmd_tpu.dataset.RawBinaryArray``
(``northstar_u16``; the file is removed at the end). Written:

- ``torch_parity_cells/<case>.npz``: ``s``; ``mean_img`` and ``var_img``
  flattened at ``pixel_sample``; ``image_probe`` (psi^T of each image);
  the fingerprint (``psi_y`` or ``psi_y_phi``, and ``y_omega``, read from
  the JAX ``PMDArray`` in 256-frame slices); ``block_counts`` (int16),
  ``window_counts`` (int16, windows x blocks: the counts after each
  window), ``block_spatial`` / ``block_temporal`` (float32, windows x
  blocks x max_components) and ``gram_vals`` (float32: the factorized
  SVD's Gram eigenvalues, whose cut at 1e-6 of the largest decides the
  directions it keeps);
- ``torch_parity_cells/cases.json``: per case ``pipeline_ranks``, the kept
  rank, the thresholds, the rank-prune matrix's shape, the movie's digest,
  the frames the JAX loader cached, the seconds of the movie, the call and
  the fingerprint, the process's peak resident memory, and the JAX
  package's ``spread``: the errors (``torch_parity_cells.errors``, ``s``
  over the shorter length) of a second run whose every sketch is moved one
  float32 ulp on half its entries (``nudged_sketch``) against the first,
  with that run's kept rank and seconds; after ``--spread``, also
  ``spread_samples``: one such run per seed given, each with its kept
  rank and the Gram directions its factorized SVD kept.

``chip_smoke.py`` phase 16 holds the port on the card to these files;
``tests/test_torch_cell_parity.py`` checks their keys and budget, and its
slow tests run the port on the CPU against them.

Run (needs jax; both runs and fingerprints of a case took 7, 15 and 24
minutes on an 8-core CPU, at a peak of 13.2, 44.5 and 23.1 GB resident;
the north star needs 16.7 GB of free disk in $TMPDIR):
python tests/golden/generate_torch_parity_cells.py [CASE ...]
python tests/golden/generate_torch_parity_cells.py --spread CASE SEED [SEED ...]
(each seed one more run and fingerprint of the case, its arrays unchanged)
"""

import functools
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_parity_cells")
CASES_JSON = os.path.join(OUT, "cases.json")
BUDGET_BYTES = 12_000_000
sys.path.insert(0, HERE)                                    # generate_torch_parity
sys.path.insert(0, os.path.dirname(HERE))                   # tests/: the case modules
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository root

import torch_parity_cells as cells  # noqa: E402
import torch_parity_full as full  # noqa: E402
from generate_torch_parity import patched  # noqa: E402


def split_windows(calls, n_blocks, n_windows):
    """Each window's rows, (windows, blocks, ...), from tagged callback
    records ``(kind, array)`` in call order: per batch one ``"first"``
    record (window 0) and then one ``"residual"`` record per later window,
    the batches in block order. Raises on a fallback record or a batch
    whose windows are not all there."""
    kinds = [kind for kind, _ in calls]
    if "fallback" in kinds:
        raise RuntimeError("the zero-count fallback ran: its rows replace a window's, unmapped")
    batches, current = [], None
    for kind, rows in calls:
        if kind == "first":
            current = [rows]
            batches.append(current)
        elif current is None:
            raise RuntimeError("a residual window before any first window")
        else:
            current.append(rows)
    if any(len(b) != n_windows for b in batches):
        raise RuntimeError(f"windows per batch {[len(b) for b in batches]}, expected {n_windows}")
    return np.stack([np.concatenate([b[w] for b in batches])[:n_blocks] for w in range(n_windows)])


def run_jax(name, source, draw=cells.sketch):
    """The case through the JAX pipeline: (PMDArray, record). ``source`` is
    the movie array or dataset; ``draw(shape)`` replaces every Gaussian
    draw (``cells.sketch``, or ``cells.nudged_sketch`` for the spread).
    ``record`` holds the thresholds of the JAX
    package's Monte-Carlo, the rank-prune shape it drew (``prune_shape``,
    None without rank_prune), the per-block kept counts, each window's
    counts and (spatial, temporal) statistics, and the call's seconds."""
    import jax
    import jax.numpy as jnp

    import localmd_tpu.checkpoint as jax_checkpoint
    import localmd_tpu.engine as jax_engine
    import localmd_tpu.factorization as jax_factorization
    import localmd_tpu.pipeline as jax_pipeline
    from localmd_tpu.ops.linalg import sketch_override
    from localmd_tpu.ops.roughness import spatial_roughness_stat, temporal_roughness_stat

    case = cells.CELL_CASES[name]
    opts = cells.options(name)
    crop, n_blocks, n_windows = cells.crop_frames(name), cells.n_blocks(name), cells.n_windows(name)
    seen, prune, counts, stats, packs, subspace, grams = [], [], [], [], [], [], []
    tracing = threading.local()
    real_heuristic, real_normal = jax_pipeline.threshold_heuristic, jax.random.normal
    real_save, real_fitness = jax_checkpoint.PipelineCheckpoint.save, jax_engine.evaluate_fitness
    real_residual, real_fallback = (jax_engine.single_residual_block_md_batched,
                                    jax_engine._fallback_rerun)
    real_pack = jax_engine.pack_components
    real_subspace, real_eigh = jax_factorization.subspace_eigh, jax_factorization.eigh_descending

    def kind():
        return getattr(tracing, "kind", "first")

    def heuristic(*a, **k):
        seen.append(tuple(float(x) for x in real_heuristic(*a, **k)))
        return seen[-1]

    def normal(key, shape=(), *a, **k):
        if getattr(tracing, "subspace", False):
            # subspace_eigh's range-capture sketch, which the JAX package
            # draws from a key of its shape, where the port takes the sketch
            subspace.append(tuple(int(s) for s in shape))
            return jnp.asarray(draw(shape), k.get("dtype", jnp.float32))
        if len(shape) == 2 and shape[0] == crop:
            out = real_normal(key, shape, *a, **k)
            if not isinstance(out, jax.core.Tracer):
                prune.append(tuple(int(s) for s in shape))
                return jnp.asarray(draw(shape), out.dtype)
            return out
        return real_normal(key, shape, *a, **k)

    # a jit of its own: the package's may hold a program traced without
    # the sketch (a stage warm compiles it)
    fresh_subspace = jax.jit(real_subspace.__wrapped__, static_argnums=(1,))

    def subspace_eigh(sym, k_sketch):
        tracing.subspace = True
        try:
            return gram_spy(fresh_subspace(sym, k_sketch))
        finally:
            tracing.subspace = False

    def gram_spy(out):
        """The factorized SVD's Gram eigenvalues, whose cut at 1e-6 of the
        largest decides the directions it keeps."""
        jax.debug.callback(lambda v: grams.append(np.asarray(v)), out[0])
        return out

    def eigh(sym):
        return gram_spy(real_eigh(sym))

    def save(self, stage, **arrays):
        if stage == "blocks":
            counts.append(np.asarray(arrays["counts"]))
        return real_save(self, stage, **arrays)

    def fitness(images, traces, spatial_threshold, temporal_threshold):
        tag = kind()
        jax.debug.callback(lambda sp, tp: stats.append((tag, (np.asarray(sp), np.asarray(tp)))),
                           spatial_roughness_stat(images), temporal_roughness_stat(traces))
        return real_fitness(images, traces, spatial_threshold, temporal_threshold)

    def tagged(fn, tag):
        def run(*a, **k):
            before, tracing.kind = kind(), tag
            try:
                return fn(*a, **k)
            finally:
                tracing.kind = before
        return run

    def pack(*a, **k):
        acc, cnt = real_pack(*a, **k)
        jax.debug.callback(lambda c: packs.append(np.asarray(c)), cnt)
        return acc, cnt

    changes = [(jax_engine, "_threshold_cache", {}),
               (jax_pipeline, "threshold_heuristic", heuristic),
               (jax.random, "normal", normal),
               (jax_checkpoint.PipelineCheckpoint, "save", save),
               (jax_engine, "evaluate_fitness", fitness),
               (jax_engine, "single_residual_block_md_batched", tagged(real_residual, "residual")),
               (jax_engine, "_fallback_rerun", tagged(real_fallback, "fallback")),
               (jax_engine, "pack_components", pack),
               (jax_factorization, "subspace_eigh", subspace_eigh),
               (jax_factorization, "eigh_descending", eigh)]
    t0 = time.perf_counter()
    with patched(changes), sketch_override(lambda shape: jnp.asarray(draw(shape))):
        pmd = jax_pipeline.localmd_decomposition(source, case["blocks"], **opts)
    secs = time.perf_counter() - t0
    want_prune = 1 if opts["rank_prune"] else 0
    if len(seen) != 1 or len(prune) != want_prune or len(counts) != 1 or len(grams) != 1:
        raise RuntimeError(f"{name}: {len(seen)} Monte-Carlo calls, {len(prune)} rank-prune "
                           f"draws, {len(counts)} block stages, {len(grams)} factorized SVDs; "
                           f"expected 1, {want_prune}, 1, 1")
    if prune and prune[0] != prune_shape(name, pmd.pipeline_ranks):
        raise RuntimeError(f"{name}: rank-prune draw {prune[0]}, expected "
                           f"{prune_shape(name, pmd.pipeline_ranks)}")
    spatial = split_windows([(k, st[0]) for k, st in stats], n_blocks, n_windows)
    temporal = split_windows([(k, st[1]) for k, st in stats], n_blocks, n_windows)
    per_window = cells.window_counts(spatial, temporal, seen[0], opts["max_components"])
    if not np.array_equal(per_window[-1], counts[0]):
        raise RuntimeError(f"{name}: the captured statistics do not give the captured counts")
    # a batch packs once a window, in window order (the statistics showed
    # every batch ran every window)
    packed = [("residual" if i % n_windows else "first", c) for i, c in enumerate(packs)]
    if n_windows > 1 and not np.array_equal(split_windows(packed, n_blocks, n_windows),
                                            per_window):
        raise RuntimeError(f"{name}: the statistics do not give each window's packed counts")
    return pmd, dict(thresholds=seen[0], prune_shape=prune[0] if prune else None,
                     subspace_sketches=subspace, gram_vals=grams[0],
                     counts=counts[0], window_counts=per_window, stats=(spatial, temporal),
                     seconds=secs)


def prune_shape(name, pipeline_ranks):
    """The rank-prune matrix's shape from the run's ranks
    (pipeline.py:1287-1290)."""
    crop = cells.crop_frames(name)
    return (crop, int(min(pipeline_ranks["pre_reduction"], crop) * cells.RANK_PRUNE_FACTOR))


def fixture_of(name, pmd, record):
    """The case's arrays and the fingerprint's seconds."""
    shape = tuple(pmd.shape)
    probe = cells.probes(shape)
    t0 = time.perf_counter()
    fp = full.fingerprint(lambda lo, hi: pmd[lo:hi], shape, chunk=cells.FINGERPRINT_CHUNK,
                          probe=probe)
    fp_secs = time.perf_counter() - t0
    sample = cells.pixel_sample(shape[1] * shape[2])
    mean, var = np.asarray(pmd.mean_img, np.float32), np.asarray(pmd.var_img, np.float32)
    arrays = dict(s=np.asarray(pmd.s, np.float32), mean_img=mean.ravel()[sample],
                  var_img=var.ravel()[sample],
                  image_probe=cells.image_probe(mean, var, probe["psi"]).astype(np.float32),
                  block_counts=np.asarray(record["counts"], np.int16),
                  window_counts=np.asarray(record["window_counts"], np.int16),
                  gram_vals=np.asarray(record["gram_vals"], np.float32),
                  block_spatial=record["stats"][0].astype(np.float32),
                  block_temporal=record["stats"][1].astype(np.float32))
    arrays.update((k, v.astype(np.float32)) for k, v in fp.items())
    return arrays, fp_secs


def make_case(name, source):
    """The case's arrays, its ``cases.json`` entry (the movie's seconds
    and the memory aside) and ``run_jax``'s record."""
    pmd, record = run_jax(name, source)
    arrays, fp_secs = fixture_of(name, pmd, record)
    print(f"{name}: subspace_eigh sketches injected {record['subspace_sketches']}", file=sys.stderr)
    # the JAX package against itself: every sketch moved one ulp on half
    # its entries
    t0 = time.perf_counter()
    nudged, nudged_record = run_jax(name, source, cells.nudged_sketch)
    spread = cells.errors(fixture_of(name, nudged, nudged_record)[0], arrays, s_prefix=True)
    entry = dict(pipeline_ranks=dict(pmd.pipeline_ranks), rank=int(pmd.rank),
                 thresholds=[float(x) for x in record["thresholds"]],
                 prune_shape=list(record["prune_shape"]) if record["prune_shape"] else None,
                 movie_digest=cells.digest(cells.movie(name)), source=cells.CELL_CASES[name]["source"],
                 cached_frames=int(getattr(pmd, "pipeline_cache", {}).get("cached_frames", 0)),
                 seconds=round(record["seconds"], 1), fingerprint_seconds=round(fp_secs, 1),
                 spread=spread, spread_rank=int(nudged.rank),
                 spread_seconds=round(time.perf_counter() - t0, 1))
    return arrays, entry, record


def spread_samples(name, source, arrays, seeds):
    """The JAX package against its stored result ``arrays``, once per seed
    of ``nudged_sketch``: one dict per seed with its errors
    (``torch_parity_cells.errors``, ``s`` over the shorter), its kept rank
    and the Gram directions its factorized SVD kept."""
    out = []
    for seed in seeds:
        draw = functools.partial(cells.nudged_sketch, seed=seed)
        pmd, record = run_jax(name, source, draw)
        err = cells.errors(fixture_of(name, pmd, record)[0], arrays, s_prefix=True)
        out.append(dict(seed=int(seed), rank=int(pmd.rank),
                        gram_kept=cells.gram_kept(record["gram_vals"]), **err))
    return out


def source_of(name):
    """(the case's movie as the JAX package reads it, its seconds, a
    temporary directory to remove or None)."""
    from localmd_tpu.dataset import RawBinaryArray

    case = cells.CELL_CASES[name]
    mov = cells.movie(name)
    tmp = None
    t0 = time.perf_counter()
    if case["source"] == "raw":
        tmp = tempfile.mkdtemp(prefix="parity_cells_")
        path = os.path.join(tmp, f"{name}.raw")
        mov.write(path)
        source = RawBinaryArray(path, case["shape"], dtype=np.dtype(case["dtype"]).str)
    else:
        source = mov.array()
    return source, time.perf_counter() - t0, tmp


def use_cpu():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def run_spread(name, seeds):
    """``spread_samples`` of one case against its committed arrays, in this
    process: prints them as JSON on the last line."""
    use_cpu()
    arrays = dict(np.load(os.path.join(OUT, f"{name}.npz")))
    source, _, tmp = source_of(name)
    try:
        samples = spread_samples(name, source, arrays, seeds)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(samples), flush=True)


def run_one(name):
    """One case in this process: writes its .npz and prints its
    ``cases.json`` entry as the last line."""
    use_cpu()
    source, movie_secs, tmp = source_of(name)
    try:
        arrays, entry, _ = make_case(name, source)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(OUT, exist_ok=True)
    np.savez_compressed(os.path.join(OUT, f"{name}.npz"), **arrays)
    entry.update(movie_seconds=round(movie_secs, 1), peak_rss_gib=round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2))
    print(json.dumps(entry), flush=True)


def write_records(records):
    with open(CASES_JSON, "w") as f:
        json.dump({n: records[n] for n in cells.CELL_CASES if n in records}, f, indent=1)
        f.write("\n")


def main_spread(name, seeds):
    """Adds ``spread_samples`` (one subprocess, every seed) to the case's
    ``cases.json`` entry, its committed arrays unchanged."""
    records = json.load(open(CASES_JSON))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--spread-one", name,
                           *map(str, seeds)], stdout=subprocess.PIPE, text=True)
    sys.stdout.write(proc.stdout)
    if proc.returncode:
        raise SystemExit(f"{name}: exit {proc.returncode}")
    records[name]["spread_samples"] = json.loads(proc.stdout.strip().splitlines()[-1])
    write_records(records)


def main(names=None):
    names = list(names or cells.CELL_CASES)
    records = json.load(open(CASES_JSON)) if os.path.exists(CASES_JSON) else {}
    for name in names:
        if name not in cells.CELL_CASES:
            raise SystemExit(f"unknown case {name}; cases: {list(cells.CELL_CASES)}")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name],
                              stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            raise SystemExit(f"{name}: exit {proc.returncode}")
        records[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{name}: {records[name]}", flush=True)
        write_records(records)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {OUT}: {len(records)} cases, {total / 1e6:.2f} MB (budget "
          f"{BUDGET_BYTES / 1e6:.0f} MB)")
    if total > BUDGET_BYTES:
        raise RuntimeError(f"{OUT} holds {total} bytes, over {BUDGET_BYTES}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    elif sys.argv[1:2] == ["--spread-one"]:
        run_spread(sys.argv[2], [int(x) for x in sys.argv[3:]])
    elif sys.argv[1:2] == ["--spread"]:
        main_spread(sys.argv[2], [int(x) for x in sys.argv[3:]])
    else:
        main(sys.argv[1:])
