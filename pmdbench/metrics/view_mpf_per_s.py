"""Pixel-frames delivered to the host over the window's whole length, in
millions per second."""

from pmdbench import window


def read(run):
    requests = run.get("requests")
    if not requests:
        return None
    return window.rate(sum(r["pixel_frames"] for r in requests), run["window_s"]) / 1e6
