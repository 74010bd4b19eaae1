"""Median over the window's calls of ``pipeline_cache["vreg.k2_s"]``: the
device seconds of the V regression's K2 calls (one a raw chunk), from CUDA
event pairs around the ``vreg.k2`` spans; the port records them only while
the profiler runs, so only a traced window has it."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "vreg.k2_s")
