"""Median over the window's calls of ``pipeline_cache["stats.host_read_s"]``:
the statistics pass's reads from the dataset into pinned host memory, in
host seconds summed over the prefetch worker's ``loader.host_read`` spans."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "stats.host_read_s")
