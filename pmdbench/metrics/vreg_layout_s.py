"""Median over the window's calls of ``pipeline_cache["vreg.layout_s"]``:
the device seconds of the V regression's cell-route layout copy (each
frame tile cast to float32 and laid out as (cell, pixel, t)), from CUDA
event pairs around the ``vreg.layout`` spans; the port records them only
while the profiler runs, so only a traced window has it."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "vreg.layout_s")
