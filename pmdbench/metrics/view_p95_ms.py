"""95th percentile of the latency of every request in the window, from
issue until the numpy array is on the host, in ms."""

from pmdbench import window


def read(run):
    requests = run.get("requests")
    if not requests:
        return None
    return 1e3 * window.percentile([r["latency_s"] for r in requests], 95)
