"""Median over the window's calls of ``pipeline_timings["v_regression"]``
(the loader's V regression), in seconds; each stage is fenced with a
device synchronise."""

from pmdbench import readers


def read(run):
    return readers.stage_median(run, "v_regression")
