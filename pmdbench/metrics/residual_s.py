"""Median over the window's calls of ``pipeline_cache["blocks.residual_s"]``:
the device seconds of the multi-window block stage's residual windows (the
residual kernel, the fallback and the packing of windows 1..n-1 of each
gathered batch), from CUDA event pairs around the ``blocks.residual``
spans; the port records them only while the profiler runs, so only a
traced window has it."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "blocks.residual_s")
