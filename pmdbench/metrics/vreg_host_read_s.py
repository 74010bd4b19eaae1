"""Median over the window's calls of ``pipeline_cache["vreg.host_read_s"]``:
the V regression's reads of the frames the movie cache does not hold, from
the dataset into pinned host memory, in host seconds summed over the
prefetch worker's ``loader.host_read`` spans."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "vreg.host_read_s")
