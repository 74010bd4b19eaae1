"""Write ``torch_parity_full/``: the JAX package's results on the main
path's own configuration at full width (``tests/torch_parity_full.py``:
bench.py:66-85 on a 512 x 512 x 2048 movie, float32 and uint16), for
machines without jax.

Each case runs through ``localmd_tpu.localmd_decomposition`` on the CPU as
``generate_torch_parity.py`` runs its cases: every sketch replaced by the
numpy sketch (``localmd_tpu.ops.linalg.sketch_override``), the JAX
package's own threshold Monte-Carlo spied (its cache emptied, so the
sketch reaches it) so the port can be pinned to its values, the rank-prune
matrix captured as the pipeline draws it, and the per-block kept counts
captured where the pipeline hands them to its checkpoint, with each block
component's roughness statistics (through a ``jax.debug.callback`` in
``evaluate_fitness``). Written:

- ``torch_parity_full/<case>.npz``: ``s``, ``mean_img`` and ``var_img``
  (float32), the reconstruction's fingerprint (``psi_y``, ``y_omega``,
  float32; read from the JAX ``PMDArray`` in 512-frame slices),
  ``block_counts`` (int16, one per block) and ``block_spatial`` /
  ``block_temporal`` (float32, (blocks, max_components): the statistics
  each keep decision compared with the thresholds);
- ``torch_parity_full/cases.json``: per case ``pipeline_ranks``, the kept
  rank, the thresholds the port is pinned to and the seconds of the call;
- ``torch_parity_full/draws.npz``: ``prune``, the rank-prune matrix from
  the JAX key tree (both cases draw the same one).

``chip_smoke.py`` phase 15 holds the port on the card to these files;
``tests/test_torch_full_width_parity.py`` checks their keys and budget,
and its slow tests remake a case and run the port on the CPU against them.

Run (needs jax; about 90 s and 11 GB of memory a case on a CPU):
python tests/golden/generate_torch_parity_full.py [CASE ...]
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_parity_full")
CASES_JSON = os.path.join(OUT, "cases.json")
DRAWS = os.path.join(OUT, "draws.npz")
BUDGET_BYTES = 10_000_000
sys.path.insert(0, HERE)                                    # generate_torch_parity
sys.path.insert(0, os.path.dirname(HERE))                   # tests/: the case modules
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository root

import torch_parity_full as full  # noqa: E402
from generate_torch_parity import patched  # noqa: E402


def run_jax(name, movie=None):
    """The case through the JAX pipeline: (PMDArray, record). ``record``
    holds the thresholds of the JAX package's Monte-Carlo, the rank-prune
    matrix it drew (``prune``), the per-block kept counts, each block
    component's (spatial, temporal) statistics (``stats``) and the call's
    seconds. On the CPU the JAX package decomposes the blocks in gathered
    batches in block order (the last batch padded), so the statistics'
    first rows are the blocks'; the kept counts they imply are checked
    against the captured ones."""
    import jax
    import jax.numpy as jnp

    import localmd_tpu.checkpoint as jax_checkpoint
    import localmd_tpu.engine as jax_engine
    import localmd_tpu.pipeline as jax_pipeline
    from localmd_tpu.ops.linalg import sketch_override
    from localmd_tpu.ops.roughness import spatial_roughness_stat, temporal_roughness_stat

    movie = full.movie(name) if movie is None else movie
    crop = full.crop_frames()
    seen, prune, counts, stats = [], [], [], []
    real_heuristic, real_normal = jax_pipeline.threshold_heuristic, jax.random.normal
    real_save = jax_checkpoint.PipelineCheckpoint.save

    def heuristic(*a, **k):
        seen.append(tuple(float(x) for x in real_heuristic(*a, **k)))
        return seen[-1]

    def normal(key, shape=(), *a, **k):
        out = real_normal(key, shape, *a, **k)
        if len(shape) == 2 and shape[0] == crop and not isinstance(out, jax.core.Tracer):
            prune.append(np.asarray(out, np.float32))
        return out

    def save(self, stage, **arrays):
        if stage == "blocks":
            counts.append(np.asarray(arrays["counts"]))
        return real_save(self, stage, **arrays)

    real_fitness = jax_engine.evaluate_fitness

    def fitness(images, traces, spatial_threshold, temporal_threshold):
        jax.debug.callback(lambda sp, tp: stats.append((np.asarray(sp), np.asarray(tp))),
                           spatial_roughness_stat(images), temporal_roughness_stat(traces))
        return real_fitness(images, traces, spatial_threshold, temporal_threshold)

    changes = [(jax_engine, "_threshold_cache", {}),
               (jax_pipeline, "threshold_heuristic", heuristic),
               (jax.random, "normal", normal),
               (jax_checkpoint.PipelineCheckpoint, "save", save),
               (jax_engine, "evaluate_fitness", fitness)]
    t0 = time.perf_counter()
    with patched(changes), sketch_override(lambda shape: jnp.asarray(full.sketch(shape))):
        pmd = jax_pipeline.localmd_decomposition(movie, full.FULL_CASES[name]["blocks"],
                                                 **full.OPTIONS)
    secs = time.perf_counter() - t0
    if len(seen) != 1 or len(prune) != 1 or len(counts) != 1:
        raise RuntimeError(f"{name}: {len(seen)} Monte-Carlo calls, {len(prune)} rank-prune "
                           f"draws, {len(counts)} block stages; expected one each")
    if prune[0].shape != full.prune_shape(pmd.pipeline_ranks):
        raise RuntimeError(f"{name}: rank-prune draw {prune[0].shape}, expected "
                           f"{full.prune_shape(pmd.pipeline_ranks)}")
    n_blocks = len(counts[0])
    block_stats = tuple(np.concatenate([st[i] for st in stats])[:n_blocks] for i in (0, 1))
    if not np.array_equal(full.kept_counts(*block_stats, seen[0]), counts[0]):
        raise RuntimeError(f"{name}: the captured statistics do not give the captured counts")
    return pmd, dict(thresholds=seen[0], prune=prune[0], counts=counts[0], stats=block_stats,
                     seconds=secs)


def key_tree_prune(pipeline_ranks):
    """The rank-prune matrix from the JAX key tree (the third split of
    ``PRNGKey(seed)``, pipeline.py:552, 1286-1290), as
    ``generate_torch_parity.prune_matrix`` derives it."""
    import jax

    key = jax.random.PRNGKey(full.OPTIONS["seed"])
    for _ in range(3):
        key, sub = jax.random.split(key)
    return np.asarray(jax.random.normal(sub, full.prune_shape(pipeline_ranks)), np.float32)


def fixture_of(pmd, record):
    """The case's arrays: images, ``s``, the fingerprint, the block counts."""
    shape = tuple(pmd.shape)
    fp = full.fingerprint(lambda lo, hi: pmd[lo:hi], shape)
    return dict(s=np.asarray(pmd.s, np.float32), mean_img=np.asarray(pmd.mean_img, np.float32),
                var_img=np.asarray(pmd.var_img, np.float32),
                psi_y=fp["psi_y"].astype(np.float32), y_omega=fp["y_omega"].astype(np.float32),
                block_counts=np.asarray(record["counts"], np.int16),
                block_spatial=record["stats"][0].astype(np.float32),
                block_temporal=record["stats"][1].astype(np.float32))


def record_of(pmd, record):
    """The case's entry of ``cases.json``."""
    return dict(pipeline_ranks=dict(pmd.pipeline_ranks), rank=int(pmd.rank),
                thresholds=[float(x) for x in record["thresholds"]],
                seconds=round(record["seconds"], 1))


def main(names=None):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    names = list(names or full.FULL_CASES)
    records = json.load(open(CASES_JSON)) if os.path.exists(CASES_JSON) else {}
    stored = dict(np.load(DRAWS)) if os.path.exists(DRAWS) else {}
    for name in names:
        pmd, record = run_jax(name)
        if not np.array_equal(record["prune"], key_tree_prune(pmd.pipeline_ranks)):
            raise RuntimeError(f"{name}: the rank-prune draw is not the key tree's")
        if "prune" in stored and not np.array_equal(stored["prune"], record["prune"]):
            raise RuntimeError(f"{name}: its rank-prune matrix differs from the stored one")
        stored["prune"] = record["prune"]
        np.savez_compressed(os.path.join(OUT, f"{name}.npz"), **fixture_of(pmd, record))
        records[name] = record_of(pmd, record)
        print(f"{name}: {record['seconds']:.1f} s; ranks {records[name]['pipeline_ranks']}, "
              f"kept {records[name]['rank']}, thresholds {records[name]['thresholds']}",
              flush=True)
        del pmd, record
    with open(CASES_JSON, "w") as f:
        json.dump({name: records[name] for name in full.FULL_CASES if name in records}, f, indent=1)
        f.write("\n")
    np.savez_compressed(DRAWS, **stored)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {OUT}: {len(records)} cases, {total / 1e6:.2f} MB (budget "
          f"{BUDGET_BYTES / 1e6:.0f} MB)")
    if total > BUDGET_BYTES:
        raise RuntimeError(f"{OUT} holds {total} bytes, over {BUDGET_BYTES}")


if __name__ == "__main__":
    main(sys.argv[1:])
