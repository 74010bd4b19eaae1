"""Median over the window's calls of ``pipeline_cache["stats.slot_wait_s"]``:
the statistics pass's waits for a pinned ring slot's previous copy to land,
in host seconds summed over the prefetch worker's ``loader.slot_wait`` spans."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "stats.slot_wait_s")
