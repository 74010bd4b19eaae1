"""Share of the traced window in which no kernel, copy or set ran on the
device, in %. Each cell's entry names it by the end-to-end metric it moves
(``idle_share.decompose``, ``.stream``, ``.view``)."""

from pmdbench import readers


def read(run):
    return readers.idle_share(run)
