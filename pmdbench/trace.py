"""Readings of a ``torch.profiler`` trace: the device's busy time (the union
of every kernel, copy and set interval), device time by operation name,
host time in CUDA runtime calls, and the longest idle gaps by what the
host was doing meanwhile."""

from __future__ import annotations

import numpy as np


def _union(spans) -> tuple:
    """(busy length, merged intervals) of (start, end) spans."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read_profile(prof, window_s: float, top: int = 10, gaps_examined: int = 400) -> dict:
    """Seconds throughout. Reads the profiler's raw events: building its
    per-event Python objects (``prof.events()``) costs some 60 us an
    event, minutes for a window of card-resident calls."""
    from torch.autograd import DeviceType

    device, host_ops, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, t, name = e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()
        if e.device_type() == DeviceType.CUDA:
            device.append((s, t, name))
        else:
            host_ops.append((s, t, name))
            if name.startswith("cu"):
                n, us = runtime.get(name, (0, 0.0))
                runtime[name] = (n + 1, us + (t - s))
    busy_us, merged = _union([(s, t) for s, t, _ in device])
    by_name: dict = {}
    for s, t, name in device:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(
        busy_s=busy_us / 1e6,
        window_s=window_s,
        device_ops=by_name,
        top_device_ops=[[name[:160], sec] for name, sec in ranked[:top]],
        runtime={name: [n, us / 1e6] for name, (n, us) in runtime.items()},
        idle_gaps=_idle_gaps(merged, host_ops, top, gaps_examined),
    )


def _idle_gaps(merged, host_ops, top: int, examined: int) -> list:
    """The longest gaps between device intervals, summed by the name of the
    host operation that overlaps each most (the shortest such on a tie)."""
    if len(merged) < 2 or not host_ops:
        return []
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:examined]
    starts = np.array([h[0] for h in host_ops], dtype=np.float64)
    ends = np.array([h[1] for h in host_ops], dtype=np.float64)
    lengths = ends - starts
    by_host: dict = {}
    for g0, g1 in gaps:
        overlap = np.minimum(ends, g1) - np.maximum(starts, g0)
        best = np.flatnonzero(overlap >= overlap.max() - 1e-9) if overlap.max() > 0 else []
        name = host_ops[int(best[np.argmin(lengths[best])])][2] if len(best) else "(no host op)"
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e6
    ranked = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], sec] for name, sec in ranked]


def device_seconds(profile: dict, names) -> float:
    """Device seconds of every operation whose name contains one of ``names``."""
    return sum(sec for op, sec in profile["device_ops"].items() if any(n in op for n in names))
