"""Movie pixel-frames (d1 * d2 * T) of every ``localmd_decomposition`` call
completed in the window of a streamed cell, over the window's whole
length, in millions per second."""

from pmdbench import readers


def read(run):
    return readers.calls_rate(run)
