"""Write ``torch_parity/``: the JAX package's results on every case of
``tests/torch_parity_cases.py``, for machines without jax.

Each case runs through ``localmd_tpu.localmd_decomposition`` on the CPU as
the port's CPU tests run it: every sketch replaced by the case's numpy
sketch (``localmd_tpu.ops.linalg.sketch_override``), ``threshold_heuristic``
pinned, or spied where the case takes the JAX package's own Monte-Carlo.
Written:

- ``torch_parity/<case>.npz``: the result's ``to_npz`` (the reference
  convention), read by the port with ``load_decomposition``;
- ``torch_parity/cases.json``: per case the JAX package's
  ``pipeline_ranks``, kept rank and the thresholds the port is pinned to;
- ``torch_parity/draws.npz``: the draws numpy cannot remake: each
  ``rank_prune`` case's rank-prune matrix from the JAX key tree (the third
  split of ``PRNGKey(seed)``, pipeline.py:552, 1286-1290), keyed by case.

``chip_smoke.py`` phase 14 holds the port on the card to these files, and
``tests/test_torch_card_parity.py`` and ``tests/test_torch_pipeline.py``
remake them from the JAX package and hold the committed files to it.

Run (needs jax): python tests/golden/generate_torch_parity.py [CASE ...]
"""

import contextlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_parity")
CASES_JSON = os.path.join(OUT, "cases.json")
DRAWS = os.path.join(OUT, "draws.npz")
sys.path.insert(0, os.path.dirname(HERE))                   # tests/: torch_parity_cases
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository root

import torch_parity_cases as cases  # noqa: E402


@contextlib.contextmanager
def patched(changes):
    """Set each (module, attribute, value) for the block, then restore."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in changes]
    try:
        for mod, attr, value in changes:
            setattr(mod, attr, value)
        yield
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)


def window_thresholds(name):
    """The JAX package's Monte-Carlo thresholds for a multi-window case's
    blocks and window (its own key tree: the first split of PRNGKey(seed))."""
    import jax

    from localmd_tpu.engine import threshold_heuristic

    case = cases.CASES[name]
    _, sub = jax.random.split(jax.random.PRNGKey(cases.SETTINGS["seed"]))
    dims = (*case["blocks"], case["window_chunks"])
    return tuple(float(x) for x in threshold_heuristic(dims, iters=250, key=sub))


def run_jax(name, movie=None):
    """The case through the JAX pipeline: (PMDArray, record). ``record``
    holds ``thresholds``, the values the port is pinned to, and ``seen``,
    each call of the JAX package's own Monte-Carlo as (args, kwargs,
    thresholds) where the case runs it (its cache emptied, so the
    injected sketch reaches it)."""
    import jax.numpy as jnp

    import localmd_tpu.engine as jax_engine
    import localmd_tpu.pipeline as jax_pipeline
    from localmd_tpu.ops.linalg import sketch_override

    case = cases.CASES[name]
    movie = cases.movie(name) if movie is None else movie
    seen = []
    if case.get("thresholds"):
        real = jax_pipeline.threshold_heuristic

        def heuristic(*a, **k):
            seen.append((a, k, tuple(float(x) for x in real(*a, **k))))
            return seen[-1][2]

        changes = [(jax_engine, "_threshold_cache", {}),
                   (jax_pipeline, "threshold_heuristic", heuristic)]
        thresholds = None
    else:
        thresholds = window_thresholds(name) if name in cases.MULTI_WINDOW else cases.PINNED
        changes = [(jax_pipeline, "threshold_heuristic", lambda *a, **k: thresholds)]
    with patched(changes), sketch_override(lambda shape: jnp.asarray(cases.sketch(shape))):
        pmd = jax_pipeline.localmd_decomposition(movie, case["blocks"], **cases.options(name))
    if thresholds is None:
        thresholds = seen[0][2]
    return pmd, dict(thresholds=tuple(thresholds), seen=seen)


def prune_matrix(name, pipeline_ranks):
    """A ``rank_prune`` case's rank-prune matrix as the JAX pipeline drew
    it; None for any other case."""
    if not cases.CASES[name].get("rank_prune"):
        return None
    import jax

    key = jax.random.PRNGKey(cases.SETTINGS["seed"])
    for _ in range(3):
        key, sub = jax.random.split(key)
    shape = cases.prune_shape(name, pipeline_ranks)
    return np.asarray(jax.random.normal(sub, shape), np.float32)


def record_of(pmd, record):
    """The case's entry of ``cases.json``."""
    return dict(pipeline_ranks=dict(pmd.pipeline_ranks), rank=int(pmd.rank),
                thresholds=[float(x) for x in record["thresholds"]])


def main(names=None):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:     # as tests/conftest.py
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    names = list(names or cases.CASES)
    records = json.load(open(CASES_JSON)) if os.path.exists(CASES_JSON) else {}
    stored = dict(np.load(DRAWS)) if os.path.exists(DRAWS) else {}
    for name in names:
        pmd, record = run_jax(name)
        pmd.to_npz(os.path.join(OUT, f"{name}.npz"))
        records[name] = record_of(pmd, record)
        matrix = prune_matrix(name, pmd.pipeline_ranks)
        if matrix is not None:
            stored[name] = matrix
        print(f"{name}: ranks {records[name]['pipeline_ranks']}, kept {records[name]['rank']}, "
              f"thresholds {records[name]['thresholds']}", flush=True)
    with open(CASES_JSON, "w") as f:
        json.dump({name: records[name] for name in cases.CASES if name in records}, f, indent=1)
        f.write("\n")
    np.savez_compressed(DRAWS, **stored)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {OUT}: {len(records)} cases, {total / 1e6:.2f} MB")


if __name__ == "__main__":
    main(sys.argv[1:])
