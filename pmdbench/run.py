#!/usr/bin/env python3
"""Benchmark of ``localmd_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 pmdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run makes the
configuration's movie on the card from ``--seed``, warms up on the cell's
own shapes, measures for ``--seconds``, checks the sampled answers against
the plain reference in ``pmdbench/reference/`` and prints one JSON line
last on standard output: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics from a profiled window. The
compared numbers and their limits are the last lines on standard error.

Exits with 2, printing no result, without a CUDA card or with fewer cards
than the cell asks for, and with 3 if a forbidden module (JAX or the JAX
package) was loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # fixed cache directories inside the checkout, for any extension or
    # Triton build: a later run loads what the first built
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    sys.path.insert(0, ROOT)
    from pmdbench import catalog

    bench = catalog.load_benchmark(ROOT)
    cell = catalog.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"pmdbench: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"CUDA available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from pmdbench import harness

    harness.log(f"card: {harness.card_line()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    run = harness.CellRun(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), PROCESS_START)
    result = run.run()
    found = harness.forbidden_modules_loaded()
    if found:
        print(f"pmdbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"pmdbench check: {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
