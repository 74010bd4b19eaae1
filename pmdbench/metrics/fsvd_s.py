"""Median over the window's calls of ``pipeline_timings["factorized_svd"]``
(the factorization; the V prefetch's copies still in flight at its fence
are billed here), in seconds; each stage is fenced with a device
synchronise."""

from pmdbench import readers


def read(run):
    return readers.stage_median(run, "factorized_svd")
