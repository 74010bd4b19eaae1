"""Median over the window's calls of ``pipeline_cache["stats.chunk_wait_s"]``:
the statistics pass's waits for a prefetched chunk, in host seconds summed
over the ``loader.chunk_wait`` spans of the thread that launches K1."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "stats.chunk_wait_s")
