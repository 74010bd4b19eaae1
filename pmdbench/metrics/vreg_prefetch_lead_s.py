"""Median over the window's calls of ``pipeline_cache["vreg.prefetch_lead_s"]``:
host seconds from the start of the V regression's stream, before the
factorized SVD (``PMDLoader.start_v_prefetch``), to the regression's take
of it; None where a call lacks the counter."""

from pmdbench import counters


def read(run):
    return counters.cache_median(run, "vreg.prefetch_lead_s")
