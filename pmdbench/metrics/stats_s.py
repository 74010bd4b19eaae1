"""Median over the window's calls of
``pipeline_timings["stats_and_background"]`` (the loader's statistics
pass and background basis), in seconds; each stage is fenced with a
device synchronise."""

from pmdbench import readers


def read(run):
    return readers.stage_median(run, "stats_and_background")
