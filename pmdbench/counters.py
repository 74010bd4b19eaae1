"""The readers of the port's own counters: the median over the window's
calls of one key of ``pipeline_cache`` (the loader's span counters,
``localmd_tpu_torch.loader``); None where a call lacks the key, as a
program without those counters gives."""

from __future__ import annotations

import statistics


def cache_median(run, key: str):
    calls = run.get("calls")
    if not calls or any(key not in c["cache"] for c in calls):
        return None
    return statistics.median(c["cache"][key] for c in calls)
