"""Three ways of delivering a finished float32 result from the card to a
numpy array on the host, timed on the card with the host's clock:

1. ``pageable``: ``x.cpu().numpy()`` into fresh pageable memory, then
   ``.astype(np.float32)`` (a second host copy);
2. ``pinned``: a page-locked tensor of the result's shape from torch's
   caching host allocator, one ``copy_(non_blocking=True)``, one stream
   synchronize, ``.numpy()``; the array dies between requests, so the
   allocator reuses its block (the first, cold allocation is timed apart);
3. ``staged``: a reused page-locked staging buffer, the same copy, then a
   host copy into ``np.empty`` on ``--threads`` threads.

Each figure is the median of ``--reps`` requests; GB/s counts the result's
bytes once. The default size is a 120-frame 512x512 playback buffer (126
MB); ``--sizes`` takes more, in frames of 512x512. Run on a machine with a
CUDA card: ``python3 scripts/probe_to_host.py [--reps 15] [--threads 4]``."""

from __future__ import annotations

import argparse
import json
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _pageable(x):
    return x.cpu().numpy().astype(np.float32)


def _pinned(x):
    out = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
    out.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return out.numpy()


def _staged(x, staging, pool, threads):
    stage = staging[: x.numel()].view(x.shape)
    stage.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    src = stage.numpy()
    out = np.empty(x.shape, np.float32)
    cuts = np.linspace(0, x.shape[0], threads + 1).astype(int)
    list(pool.map(lambda i: np.copyto(out[cuts[i]:cuts[i + 1]], src[cuts[i]:cuts[i + 1]]),
                  range(threads)))
    return out


def _time(fn, x, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(x)
        times.append(time.perf_counter() - t0)
        del out
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--sizes", type=int, nargs="*", default=[1, 16, 120])
    args = ap.parse_args()
    dev = torch.device("cuda", torch.cuda.current_device())
    for frames in args.sizes:
        x = torch.randn((frames, 512, 512), device=dev)
        nbytes = x.numel() * 4
        want = x.cpu().numpy()
        t0 = time.perf_counter()
        cold = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
        cold_s = time.perf_counter() - t0   # a bin not used before: cudaHostAlloc
        del cold
        staging = torch.empty(x.numel(), dtype=torch.float32, pin_memory=True)
        with ThreadPoolExecutor(args.threads) as pool:
            assert np.array_equal(_pinned(x), want)
            assert np.array_equal(_staged(x, staging, pool, args.threads), want)
            seconds = dict(
                pageable=_time(_pageable, x, args.reps),
                pinned=_time(_pinned, x, args.reps),
                staged=_time(lambda y: _staged(y, staging, pool, args.threads), x, args.reps),
            )
        row = dict(frames=frames, mb=nbytes / 1e6, threads=args.threads,
                   first_pinned_alloc_ms=cold_s * 1e3,
                   ms={k: v * 1e3 for k, v in seconds.items()},
                   gb_per_s={k: nbytes / v / 1e9 for k, v in seconds.items()})
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
