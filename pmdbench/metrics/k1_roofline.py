"""K1 (the statistics kernel) against its roofline, in %: the movie read
once in the stream dtype and the mean and noise images written once, at
the card's published HBM rate, over K1's device time in the traced
window."""

from pmdbench import readers


def read(run):
    return readers.k1_share(run)
