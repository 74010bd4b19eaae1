"""Shared arithmetic of the metric readers in ``metrics/``: a reader that
finds nothing to read returns None."""

from __future__ import annotations

import statistics

from pmdbench import rooflines, trace, window


def calls_rate(run):
    """Pixel-frames of every call completed in the window over its whole
    length, in millions per second."""
    calls = run.get("calls")
    if not calls:
        return None
    return window.rate(len(calls) * run["movie"]["pixel_frames"], run["window_s"]) / 1e6


def stage_median(run, key: str):
    """Median over the window's calls of ``pipeline_timings[key]``."""
    calls = run.get("calls")
    if not calls or any(key not in c["timings"] for c in calls):
        return None
    return statistics.median(c["timings"][key] for c in calls)


def idle_share(run):
    """1 - (union of device intervals) / the traced window, in %, where the
    window ran calls or requests."""
    prof = run.get("profile")
    if not prof or not (run.get("calls") or run.get("requests")):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


# K1's device functions (localmd_tpu_torch/csrc/movie_stats.cu)
K1_NAMES = ("movie_stats_wgmma_kernel",)


def k1_share(run):
    """K1's least time (the movie read once in the stream dtype, the mean
    and noise images written once, at the HBM peak) over its device time
    in the traced window, in %."""
    prof, calls = run.get("profile"), run.get("calls")
    if not prof or not calls:
        return None
    seconds = trace.device_seconds(prof, K1_NAMES)
    if seconds <= 0:
        return None
    t, d1, d2 = run["movie"]["shape"]
    bound = sum(rooflines.k1_seconds(t, d1 * d2, c["cache"]["stream_dtype"], run["peaks"])
                for c in calls)
    return 100.0 * bound / seconds
