"""Median latency of the single-frame requests in the window, in ms: the
fixed cost inside every request."""

import statistics


def read(run):
    lat = [r["latency_s"] for r in run.get("requests") or () if r["kind"] == "frame"]
    return 1e3 * statistics.median(lat) if lat else None
