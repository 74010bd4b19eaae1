"""Median over the window's calls of ``pipeline_cache["vreg.chunk_wait_s"]``:
the V regression's waits for a prefetched chunk, in host seconds summed
over the ``loader.chunk_wait`` spans of the thread that launches the
regression's products."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "vreg.chunk_wait_s")
