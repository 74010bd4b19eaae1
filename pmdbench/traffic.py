"""The general generator of the benchmark's traffic, read from a mix's
data file (``traffic/<name>.json``).

``decompose`` mixes: a closed loop of one caller, each call a whole movie
handed over fresh -- from host memory as the port's own in-memory dataset
(``host_movie``; ``movie_on`` "host") or as a new tensor object viewing the
movie on the card ("card").

``view`` mixes: a closed loop of one client reading a finished
decomposition through ``PMDArray.__getitem__``. ``view_requests`` draws
the request sizes from the mix's own ``sizes_seed``, so every run does the
same work, and their order and positions from the run's seed.
"""

from __future__ import annotations

import functools
import threading

import numpy as np


@functools.lru_cache(maxsize=None)
def _counted_array():
    from localmd_tpu_torch.dataset import NumpyArray

    class CountedArray(NumpyArray):
        """The port's in-memory dataset over a host movie, unchanged but for
        a count of the bytes it hands out (``bytes_read``): its own
        ``read_into`` and indexing do the copies."""

        def __init__(self, array: np.ndarray):
            super().__init__(array)
            self._lock = threading.Lock()
            self._frame_bytes = array.nbytes // max(1, array.shape[0])
            self.bytes_read = 0

        def _count(self, frames) -> None:
            n = len(range(*frames.indices(self.shape[0]))) if isinstance(frames, slice) \
                else int(np.size(frames))
            with self._lock:
                self.bytes_read += n * self._frame_bytes

        def read_into(self, frames, out: np.ndarray) -> np.ndarray:
            got = super().read_into(frames, out)
            self._count(frames)
            return got

        def __getitem__(self, item):
            got = super().__getitem__(item)
            self._count(item[0] if isinstance(item, tuple) else item)
            return got

    return CountedArray


def host_movie(array: np.ndarray):
    """A new dataset object over a (T, d1, d2) movie in host memory: the
    port's ``NumpyArray`` with a count of the bytes it hands out."""
    return _counted_array()(array)


def view_requests(mix: dict, shape, seed: int) -> list:
    """The mix's request list for a (T, d1, d2) decomposition: dicts with
    ``kind``, the frames [t0, t0 + n) and the window (r0, c0, h, w)."""
    t, d1, d2 = shape
    n_total = int(mix["requests"])
    sizes = np.random.default_rng(int(mix["sizes_seed"]))
    kinds = []
    for entry in mix["mix"]:
        count = int(round(entry["share"] * n_total))
        if entry["kind"] == "frame":
            n = np.ones(count, np.int64)
            side = np.zeros(count, np.int64)
        else:
            lo, hi = entry["frames"]
            n = sizes.integers(lo, hi + 1, count)
            side = (sizes.integers(entry["side"][0], entry["side"][1] + 1, count)
                    if "side" in entry else np.zeros(count, np.int64))
        kinds += [(entry["kind"], int(a), int(b)) for a, b in zip(n, side)]
    rng = np.random.default_rng(int(seed))
    out = []
    for i in rng.permutation(len(kinds)):
        kind, n, side = kinds[i]
        h, w = (side, side) if side else (d1, d2)
        out.append(dict(
            kind=kind, n=n, h=h, w=w,
            t0=int(rng.integers(0, t - n + 1)),
            r0=int(rng.integers(0, d1 - h + 1)),
            c0=int(rng.integers(0, d2 - w + 1)),
        ))
    return out


def request_key(request: dict) -> tuple:
    """The ``PMDArray.__getitem__`` key of a request: one frame by its
    index, anything longer by a frame slice."""
    rows = slice(request["r0"], request["r0"] + request["h"])
    cols = slice(request["c0"], request["c0"] + request["w"])
    t0, n = request["t0"], request["n"]
    return (t0 if request["kind"] == "frame" else slice(t0, t0 + n), rows, cols)
