"""Median over the window's calls of
``pipeline_timings["block_decomposition"]`` (the engine's block stage),
in seconds; each stage is fenced with a device synchronise. Read as
``block_s`` in the card-resident cells and ``block_s.stream`` in the
streamed one."""

from pmdbench import readers


def read(run):
    return readers.stage_median(run, "block_decomposition")
