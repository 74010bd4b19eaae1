"""Movie loader: statistics, background basis, standardized init frames, the
streamed V regression, host->device streaming and the device movie cache
(counterpart of localmd_tpu/loader.py).

- The statistics pass walks plain 1024-frame ranges and runs K1
  (``ops.kernels.movie_stats``) on each raw chunk in its native dtype; a
  tail shorter than ``MIN_NOISE_FRAMES`` adds to the mean only
  (loader.py:814-940, comment at 845-856).
- The V regression folds the mixing matrix and the per-pixel
  standardization into one dense projector, A~ = (U P)/std and c = A~^T mean,
  so each raw chunk is one K2 call (``ops.kernels.v_projection``;
  loader.py:1131-1158); on a regular grid with ``blocksparse.COSET_VPROJ``
  on (the card's default) each chunk instead takes the cell route, one
  batched product against panels packed by (h1, h2) cell
  (``blocksparse.coset_vproj_chunk``; loader.py:1097-1130).
- Host sources stream on a background thread (``_PrefetchIter``): the
  worker reads each chunk from disk into a ring of ``depth + 2`` pinned
  host buffers in the chunk's native dtype (256 MiB pieces; the native
  readers and an in-memory ``NumpyArray`` copy each piece on
  ``num_workers`` threads, ``set_io_threads``), starts the
  copies to the card on a dedicated copy stream and records an event; the
  consumer's stream waits on that event before any kernel reads the chunk
  (``_PinnedStager``). A device tensor is never made from pageable memory.
- The movie cache (loader.py:535-648): while the stats pass streams the
  movie, leading chunks are copied straight into one device buffer in
  their native dtype, as many frames as ``cache_fraction`` of the free
  device memory holds; the init frames, the background frames and the V
  regression then read those frames from the card -- contiguous ranges as
  views -- instead of streaming them again.
- With a mesh of more than one rank (``parallel``), each rank streams its
  own stripe of the movie in both passes: whole stats chunks
  (``partition_chunks_for_host``), whose three accumulators are then
  all-gathered and summed in rank order, and a ceil-division stripe of
  frames for the V regression (``partition_ranges_for_host``), whose
  columns are all-gathered. The movie cache is off there: it holds a
  prefix of the movie, which a rank's stripe is not (loader.py:826-834).
- Program spans (``utils.logging.span``), on the thread doing the work:
  ``loader.host_read`` around each read from the dataset into host
  memory, ``loader.slot_wait`` around a pinned slot's wait for its
  previous copy, ``loader.chunk_wait`` around the consumer's wait for a
  prefetched chunk; while the profiler runs, the device spans
  ``vreg.layout`` (the cell route's layout copy) and ``vreg.k2`` (each K2
  call). What they and the passes count is listed once, in
  ``PMDLoader.pipeline_record``.
"""

from __future__ import annotations

import contextlib
import gc
import math
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from localmd_tpu_torch import blocksparse
from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.dataset import TensorMovie, as_dataset, frame_list
from localmd_tpu_torch.ops import kernels
from localmd_tpu_torch.ops.linalg import truncated_random_svd
from localmd_tpu_torch.ops.noise import NPERSEG
from localmd_tpu_torch.ops.tiling import flatten_fov, flatten_image, unflatten_fov
from localmd_tpu_torch.parallel.multihost import (
    all_gather_into,
    replicate_frame_sharded,
    world_and_rank,
)
from localmd_tpu_torch.utils import (
    device_free_bytes,
    display,
    get_logger,
    is_device_oom,
    make_generator,
    transient_budget_bytes,
)
from localmd_tpu_torch.utils.logging import DeviceSpans, count, span

MIN_NOISE_FRAMES = 256   # reference min_allowed_frames
STATS_CHUNK_FRAMES = 1024
STREAM_CHUNK_BYTES = 1 << 30  # floor of the f32 bytes of one streamed chunk
STAGE_PIECE_BYTES = 1 << 28   # one pinned ring slot: a host->device copy
CACHE_FRACTION = 0.5          # share of the free device memory the movie cache may take

# the numpy dtypes of ``kernels.KERNEL_DTYPES`` (a bfloat16 movie, which
# numpy cannot hold, arrives as a tensor)
_KERNEL_DTYPES = tuple(np.dtype(str(dt).removeprefix("torch."))
                       for dt in kernels.KERNEL_DTYPES if dt != torch.bfloat16)


def _chunk_ranges(total: int, chunk: int, merge_tail: bool = True) -> List[Tuple[int, int]]:
    """[start, end) ranges (loader.py:60-76). With ``merge_tail`` the final
    partial chunk joins the previous one; without it the short tail stays."""
    n_chunks = math.ceil(total / chunk)
    if n_chunks <= 1:
        return [(0, total)]
    if not merge_tail:
        return [(i * chunk, min((i + 1) * chunk, total)) for i in range(n_chunks)]
    ranges = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks - 2)]
    ranges.append(((n_chunks - 2) * chunk, total))
    return ranges


def _pass_key(label: Optional[str], name: str) -> Optional[str]:
    """The counter of ``name`` for the pass ``label``; None (nothing is
    counted) for a stream no pass labelled."""
    return f"{label}.{name}" if label else None


def partition_ranges_for_host(
    ranges: List[Tuple[int, int]], host_index: int, host_count: int
) -> List[Tuple[int, int]]:
    """This rank's contiguous stripe of frames (loader.py:79-114): frames
    ``[h * ceil(T / H), min((h + 1) * ceil(T / H), T))``, chunks split at
    the stripe's edges, so the stripes in rank order are the whole movie
    and each rank's V columns are one ceil-division shard. Trailing ranks
    may get an empty stripe. Only for passes whose per-chunk results do
    not depend on the chunk boundaries (the V regression)."""
    if host_count <= 1:
        return list(ranges)
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    total = sum(b - a for a, b in ranges)
    shard = -(-total // host_count)
    lo = min(host_index * shard, total)
    hi = min(lo + shard, total)
    out: List[Tuple[int, int]] = []
    acc = 0
    for a, b in ranges:
        n = b - a
        s, e = max(acc, lo), min(acc + n, hi)
        if s < e:
            out.append((a + (s - acc), a + (e - acc)))
        acc += n
    return out


def partition_chunks_for_host(
    ranges: List[Tuple[int, int]], host_index: int, host_count: int
) -> List[Tuple[int, int]]:
    """This rank's contiguous run of whole chunks, ``ceil(n_chunks / H)``
    of them (loader.py:117-144): the statistics pass's partition, since the
    Welch sigma is averaged per chunk, a short tail adds to the mean only
    and the reference mode's nperseg is the chunk length, so every rank
    must see the single-rank loop's chunk boundaries. Trailing ranks may
    get an empty stripe."""
    if host_count <= 1:
        return list(ranges)
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    per = -(-len(ranges) // host_count)
    return list(ranges[host_index * per : (host_index + 1) * per])


class _PrefetchIter:
    """Background-thread prefetching iterator over ``load_fn(item)``
    (loader.py:156-248), and a context manager that closes it on exit.

    Abandoning the iterator mid-stream (an exception in the consumer loop,
    e.g. the movie cache's OOM retry) must not leak the worker: ``close()``
    (also run by GC) sets the stop event and drains the queue, so the worker
    unblocks, drops its references and exits. With ``eager=True`` the
    worker starts at construction instead of the first ``__next__``."""

    def __init__(self, make_items: Sequence, load_fn, depth: int = 2,
                 eager: bool = False):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: list = []
        self._stop = threading.Event()
        self._items = make_items
        self._load = load_fn
        self._done = False
        self._started = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        if eager:
            self._ensure_started()

    def _ensure_started(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def _put(self, item) -> bool:
        """put honoring stop; False once the consumer is gone."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for item in self._items:
                if self._stop.is_set() or not self._put(self._load(item)):
                    return
        except BaseException as e:  # surface IO errors in the consumer
            self._err.append(e)
        finally:
            self._put(self._sentinel)

    def __iter__(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __next__(self):
        if self._done or self._stop.is_set():
            raise StopIteration
        self._ensure_started()
        while True:
            try:
                got = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():  # cross-thread close mid-consumption
                    raise StopIteration
        if got is self._sentinel:
            self._done = True
            if self._err:
                raise self._err[0]
            raise StopIteration
        return got

    def close(self) -> None:
        stop = getattr(self, "_stop", None)  # __del__-safe if __init__ failed
        if stop is None:
            return
        stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    __del__ = close


_COPY_STREAMS: dict = {}
_COPY_STREAMS_LOCK = threading.Lock()


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The host->device copy stream of ``device``, one per device for the
    process: the caching allocator keeps a pool per stream, so chunks
    allocated on one long-lived stream reuse its cached blocks run after
    run instead of stranding them in the pools of new streams."""
    with _COPY_STREAMS_LOCK:
        stream = _COPY_STREAMS.get(device.index)
        if stream is None:
            stream = _COPY_STREAMS[device.index] = torch.cuda.Stream(device=device)
        return stream


class _PinnedStager:
    """Host->device copies through a ring of pinned host buffers and a copy
    stream, for one stream of chunks.

    ``stage`` runs on the prefetch worker: it makes the loader's device the
    thread's current device (a new thread starts on device 0) and moves the
    chunk in pieces of at most ``STAGE_PIECE_BYTES``. For each piece it
    waits until the ring slot's previous copy has completed (a slot is
    never refilled while its bytes are still in flight), reads the frames
    from disk into the slot, and starts the copy into the chunk's device
    tensor with ``non_blocking=True`` on the copy stream, so the next
    piece's read overlaps this piece's copy. The event recorded after the
    last piece marks the whole chunk (one stream runs its copies in order).
    Pinned memory stays at ``n_slots`` pieces whatever the chunk size;
    ``release`` drops the ring.

    A ``dest`` the caller passes (the movie cache) was allocated on the
    consumer's stream, whose queued work may still use its block: the
    stager is made on the consumer's thread and records an event on that
    stream, and the copy stream waits on it before the first copy into a
    ``dest``. ``label`` is the pass the waits and reads count under."""

    def __init__(self, loader: "PMDLoader", n_slots: int, label: Optional[str] = None):
        self._loader = loader
        self._label = label
        self.device = loader.device
        self.stream = _copy_stream(self.device)
        self._consumer_ready = torch.cuda.Event()
        self._consumer_ready.record(torch.cuda.current_stream(self.device))
        frame_bytes = loader.n_pixels * torch.empty(0, dtype=loader.stream_dtype).element_size()
        self._piece = max(1, STAGE_PIECE_BYTES // frame_bytes)
        self._slots: List[Optional[torch.Tensor]] = [None] * n_slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self._next = 0

    def _slot(self) -> Tuple[int, torch.Tensor]:
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            with span(self._loader.transfers, _pass_key(self._label, "slot_wait_s"),
                      "loader.slot_wait"):
                self._events[i].synchronize()
        if self._slots[i] is None:
            self._slots[i] = torch.empty(
                (self._piece,) + tuple(self._loader.shape[1:]),
                dtype=self._loader.stream_dtype, pin_memory=True,
            )
        return i, self._slots[i]

    def stage(self, frames, dest: Optional[torch.Tensor] = None):
        torch.cuda.set_device(self.device)
        ids = frame_list(frames, self._loader.shape[0])
        n = len(ids)
        contiguous = n > 0 and ids == list(range(ids[0], ids[0] + n))
        with torch.cuda.stream(self.stream):
            if dest is None:
                dest = torch.empty((n,) + tuple(self._loader.shape[1:]),
                                   dtype=self._loader.stream_dtype, device=self.device)
            else:
                # the consumer's stream owns ``dest``: its earlier work there
                # goes first, and the allocator must not hand the block out
                # again before these copies have landed
                self.stream.wait_event(self._consumer_ready)
                dest.record_stream(self.stream)
        event = None
        for a in range(0, n, self._piece):
            b = min(a + self._piece, n)
            i, slot = self._slot()
            host = slot[: b - a]
            piece = slice(ids[0] + a, ids[0] + b) if contiguous else ids[a:b]
            self._loader._host_read(piece, host, self._label)
            with torch.cuda.stream(self.stream):
                dest[a:b].copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            self._events[i] = event
            self._loader._count_copy(host.numel() * host.element_size())
        return dest, event

    def release(self) -> None:
        self._slots = [None] * len(self._slots)
        self._events = [None] * len(self._events)


class _StagedChunks(_PrefetchIter):
    """A ``_PrefetchIter`` whose items are ``(tensor, event)``: each
    ``__next__`` makes the consumer's stream wait on the copy's event and
    marks the tensor as used by that stream, so the caching allocator does
    not give its block to the next copy while K1 or K2 still reads it.
    ``close`` also releases the pinned ring; queued chunks are dropped by
    the base class's drain. Each wait for a chunk is a ``loader.chunk_wait``
    span, its seconds added to ``counters[wait_key]``."""

    def __init__(self, items, load_fn, stager: Optional[_PinnedStager], depth: int,
                 eager: bool = False, counters: Optional[dict] = None,
                 wait_key: Optional[str] = None):
        self._stager = stager
        self._counters = counters
        self._wait_key = wait_key
        super().__init__(items, load_fn, depth=depth, eager=eager)

    def __next__(self):
        with span(self._counters, self._wait_key, "loader.chunk_wait"):
            tensor, event = super().__next__()
        if event is not None:
            stream = torch.cuda.current_stream(tensor.device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return tensor

    def close(self) -> None:
        super().close()
        stager = getattr(self, "_stager", None)
        if stager is not None:
            stager.release()
            self._stager = None

    __del__ = close


def _rows_to_c(x: torch.Tensor, d1: int, d2: int, order: str) -> torch.Tensor:
    """Reorder the pixel rows of (d1*d2, k) from ``order`` to C order."""
    return unflatten_fov(x, d1, d2, order).reshape(d1 * d2, -1)


def _rows_from_c(x: torch.Tensor, d1: int, d2: int, order: str) -> torch.Tensor:
    """Reorder the pixel rows of (d1*d2, k) from C order to ``order``."""
    return flatten_fov(x.reshape(d1, d2, -1), order)


def standardize_and_filter(
    data: torch.Tensor,
    mean_img: torch.Tensor,
    std_img: torch.Tensor,
    spatial_basis_flat: torch.Tensor,
    order: str = "F",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardize a (d1, d2, t) chunk and project out the background basis
    (loader.py:326-340). ``order`` is the pixel order of
    ``spatial_basis_flat``'s rows. Returns the filtered (d1, d2, t) chunk
    and the background temporal projection (K, t)."""
    return _standardize_frames(data.permute(2, 0, 1), mean_img, std_img, spatial_basis_flat, order)


def _standardize_frames(
    raw: torch.Tensor,
    mean_img: torch.Tensor,
    std_img: torch.Tensor,
    spatial_basis_flat: torch.Tensor,
    order: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``standardize_and_filter`` of a raw (t, d1, d2) chunk, the layout the
    loader reads. The filtered chunk comes back as a contiguous (d1, d2, t)
    f32 tensor.

    Works frames-major on C-order pixels, the raw chunk's own layout, with
    the (small) basis rows reordered instead: per pixel and frame the
    arithmetic is the JAX package's, and the only movie-sized transpose is
    the final one into the (d1, d2, t) layout the block stage gathers from."""
    t, d1, d2 = raw.shape
    x = raw.reshape(t, d1 * d2).to(torch.float32)
    x = (x - mean_img.reshape(-1)) / std_img.reshape(-1)
    basis_c = _rows_to_c(spatial_basis_flat, d1, d2, order)
    temporal_projection = (x @ basis_c).T                         # (K, t)
    x = x - temporal_projection.T @ basis_c.T
    return x.T.reshape(d1, d2, t).contiguous(), temporal_projection


def _fold_projector(a: torch.Tensor, std_flat: torch.Tensor, mean_flat: torch.Tensor):
    """(U P) -> (A~ = UP/std, c = A~^T mean) (loader.py:357). Divides ``a``
    in place: the (d, r') canvas is the largest buffer of the stage."""
    a_tilde = a.div_(std_flat[:, None])
    c = (a_tilde.T @ mean_flat[:, None])[:, 0]
    return a_tilde, c


class _CellRoute:
    """The V regression's cell route for one U (a regular grid with
    ``blocksparse.COSET_VPROJ`` on): ``m_cell`` and ``q`` from
    ``blocksparse.build_vproj_cells``, made before the mixing matrix
    exists. A chunk is one ``blocksparse.coset_vproj_chunk``, its layout
    copies the device span ``vreg.layout``."""

    def __init__(self, loader: "PMDLoader", u):
        self.panels = u.panels
        std, mean = (flatten_image(x, loader.order) for x in (loader.std_img, loader.mean_img))
        self.m_cell, self.q = blocksparse.build_vproj_cells(
            u.panels, u.rows, loader.shape[1:], loader.order, u.cell_geom, u.dense_basis, std, mean)
        self._geom = (*u.cell_geom, u.slots)
        self._counters = loader.transfers
        self.spans = DeviceSpans(loader.transfers, "vreg.layout_s", "vreg.layout", loader.device)

    def bind(self, p: torch.Tensor) -> None:
        self._p = p

    def __call__(self, raw: torch.Tensor) -> torch.Tensor:
        count(self._counters, "vreg.cell_calls", 1)
        # looked up at each call: tests patch the module's function
        return blocksparse.coset_vproj_chunk(self.m_cell, self.q, self._p, raw, *self._geom,
                                             self.spans.span)


class _K2Route:
    """The V regression's K2 route for one U (any the cell route does not
    take): ``bind`` folds the mixing matrix into A~ = (U P)/std with its
    rows in C order, c = A~^T mean and K2's layout of A~, once for every
    chunk. A chunk is one K2 call inside the device span ``vreg.k2``."""

    def __init__(self, loader: "PMDLoader", u):
        self._loader = loader
        self._u = u
        self.spans = DeviceSpans(loader.transfers, "vreg.k2_s", "vreg.k2", loader.device)

    def bind(self, p: torch.Tensor) -> None:
        ld = self._loader
        a_tilde, self._c = _fold_projector(self._u.matmul(p), flatten_image(ld.std_img, ld.order),
                                           flatten_image(ld.mean_img, ld.order))
        # projector rows follow the pipeline's pixel order; the raw chunk
        # flattens in C order, so reorder the rows once (loader.py:1142)
        self._a = _rows_to_c(a_tilde, *ld.shape[1:], ld.order).contiguous()
        self._prepared = kernels.prepare_projector(self._a) if self._a.is_cuda else None
        ld.transfers["vreg.k2_width"] = int(self._a.shape[1])

    def __call__(self, raw: torch.Tensor) -> torch.Tensor:
        count(self._loader.transfers, "vreg.k2_calls", 1)
        count(self._loader.transfers, "vreg.k2_frames", int(raw.shape[0]))
        raw2d = raw.reshape(raw.shape[0], self._a.shape[0])
        with self.spans.span():
            return kernels.v_projection(raw2d, self._a, self._c, self._prepared)


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class PMDLoader:
    """Owns dataset access, per-pixel statistics and the background basis.

    The parameters are the JAX package's (loader.py:402-420) plus ``device``
    (the card unless ``device="cpu"`` is passed; raises without CUDA) and
    ``mesh``, both keyword-only. ``dtype`` is the dtype of
    ``temporal_crop`` and ``temporal_crop_standardized``; the passes stream
    in the movie's own dtype whatever it is. ``cache_fraction`` is the share
    of the free device memory the movie cache may take. ``pixel_batch_size``
    and ``cache_reserve_bytes`` are kept as attributes and have no effect:
    the statistics pass reads the whole field of view at once, and JAX reads
    ``cache_reserve_bytes`` only when its runtime reports no device memory,
    which the card always reports."""

    def __init__(
        self,
        dataset,
        background_rank: int = 15,
        batch_size: int = 2000,
        order: str = "F",
        compute_normalizer: bool = True,
        frame_constant: int = STATS_CHUNK_FRAMES,
        seed: Optional[int] = None,
        welch_compat: str = "scipy",
        np_rng=None,
        num_workers: Optional[int] = None,
        precomputed: Optional[dict] = None,
        cache_movie="auto",
        stats_started_hook=None,
        dtype: str = "float32",
        pixel_batch_size: int = 5000,
        cache_fraction: float = CACHE_FRACTION,
        cache_reserve_bytes: Optional[int] = None,
        *,
        device="cuda",
        mesh=None,
    ):
        if welch_compat not in ("scipy", "reference"):
            raise ValueError(
                f"welch_compat must be 'scipy' or 'reference', got {welch_compat!r}"
            )
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.dataset = as_dataset(dataset)
        self.dtype = np.dtype(dtype)
        self._crop_dtype = _torch_dtype(self.dtype)
        self.shape = tuple(int(s) for s in self.dataset.shape)
        self.batch_size = batch_size
        self.pixel_batch_size = pixel_batch_size
        self.cache_reserve_bytes = cache_reserve_bytes
        self._order = order
        self.background_rank = background_rank
        self.frame_constant = frame_constant
        self.welch_compat = welch_compat
        self._compute_normalizer = compute_normalizer
        self._np_rng = np_rng if np_rng is not None else np.random
        # the ranks the two passes are striped over (parallel.make_mesh)
        self._mesh = mesh
        self._generator = make_generator(seed, self.device)
        self.stream_dtype = self._stream_dtype()
        # the movie cache (loader.py:448-466): "auto" caches as many leading
        # frames as ``cache_fraction`` of the free device memory holds (on
        # the CPU, with no memory query, only cache_movie=True caches, and
        # then everything); False never caches
        self._cache_policy = cache_movie
        self._cache_fraction = float(cache_fraction)
        self._cache: Optional[torch.Tensor] = None
        self._cache_frames = 0
        self._cache_building = False
        self._v_prefetch: Optional[dict] = None
        # host->device copies of movie frames (all from pinned memory) and
        # the streams' span counters (``utils.logging.count``); the prefetch
        # workers add to these
        self.transfers = {"pinned_copies": 0, "pinned_bytes": 0}
        # the V regression's device spans until ``pipeline_record`` settles
        # them, and the cell route ``prepare_vproj_cells`` made ahead of it
        self._spans: List[DeviceSpans] = []
        self._cell_route: Optional[_CellRoute] = None
        # fired once, as hook(loader, cache_target_frames), when the
        # statistics pass has planned and allocated the movie cache and
        # before it reads its first chunk (loader.py:491-494), so a caller can
        # overlap work with the read; the JAX pipeline starts its stage warms
        # there, the port's passes none. What the hook raises is kept in
        # ``stats_hook_error`` and the pass goes on.
        self._stats_started_hook = stats_started_hook
        self.stats_hook_error: Optional[BaseException] = None
        # threads, not processes: num_workers maps onto the prefetch depth
        # and the dataset's read threads: the native reader's, or the copy
        # threads of an in-memory NumpyArray (loader.py:478-487)
        self.num_workers = int(num_workers) if num_workers else 0
        self._prefetch_depth = max(2, min(self.num_workers, 4))
        if self.num_workers and hasattr(self.dataset, "set_io_threads"):
            self.dataset.set_io_threads(self.num_workers)

        # checkpoint/resume: skip the statistics and background passes when
        # a prior run's results are supplied (loader.py:500-510)
        if precomputed and "mean_img" in precomputed:
            self.mean_img = self._f32(precomputed["mean_img"])
            self.std_img = self._f32(precomputed["std_img"])
        else:
            self._run_stats_with_oom_retry()
        if precomputed and "spatial_basis" in precomputed:
            if self.background_rank > 0:
                # draw the frames all the same: the pipeline's later numpy
                # draws (window sampling) must see the RandomState as an
                # uninterrupted run leaves it
                self._background_frames()
            self.spatial_basis = self._f32(precomputed["spatial_basis"])
        else:
            self._initialize_background()

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

    @property
    def order(self) -> str:
        return self._order

    @property
    def n_pixels(self) -> int:
        return self.shape[1] * self.shape[2]

    # -- raw access -----------------------------------------------------------

    @property
    def _device_resident(self) -> bool:
        return isinstance(self.dataset, TensorMovie) and self.dataset.device == self.device

    def _stream_dtype(self) -> torch.dtype:
        """The dtype chunks reach K1 and K2 in: the stored one where they
        read it natively (``kernels.KERNEL_DTYPES``), else float32 (float64,
        int32, uint32, int64: JAX's DeviceMovie likewise makes float64 into
        float32)."""
        if isinstance(self.dataset, TensorMovie):
            dt = self.dataset.dtype
            return dt if dt in kernels.KERNEL_DTYPES else torch.float32
        raw = np.dtype(getattr(self.dataset, "raw_dtype", None) or self.dataset.dtype)
        raw = raw.newbyteorder("=")
        return _torch_dtype(raw if raw in _KERNEL_DTYPES else np.dtype(np.float32))

    def _count_copy(self, nbytes: int) -> None:
        count(self.transfers, "pinned_copies", 1)
        count(self.transfers, "pinned_bytes", int(nbytes))

    def _host_read(self, frames, out: torch.Tensor, label: Optional[str] = None) -> torch.Tensor:
        """``_read_into`` inside a ``loader.host_read`` span; for the pass
        ``label`` its seconds, bytes, and whether the dataset split it over
        threads count into ``transfers``."""
        with span(self.transfers, _pass_key(label, "host_read_s"), "loader.host_read"):
            self._read_into(frames, out)
        if label:
            threads = getattr(self.dataset, "read_threads", None)
            split = threads is not None and threads(out.shape[0]) > 1
            count(self.transfers, f"{label}.host_read_bytes", out.numel() * out.element_size())
            count(self.transfers, f"{label}.host_reads", 1)
            count(self.transfers, f"{label}.host_read_split", int(split))
        return out

    def _read_into(self, frames, out: torch.Tensor) -> torch.Tensor:
        """Frames of the dataset into the host tensor ``out`` (n, d1, d2), in
        its dtype. A tensor source copies tensor to tensor (a bfloat16 movie
        has no numpy form); the others fill ``out``'s numpy view."""
        if isinstance(self.dataset, TensorMovie):
            out.copy_(self.dataset.gather(frame_list(frames, self.shape[0])).reshape(out.shape))
        elif hasattr(self.dataset, "read_into"):
            self.dataset.read_into(frames, out.numpy())
        else:
            got = np.asarray(self.dataset[frame_list(frames, self.shape[0])])
            np.copyto(out.numpy(), got.reshape(out.shape), casting="unsafe")
        return out

    def _host_chunk(self, frames, dest: Optional[torch.Tensor] = None,
                    label: Optional[str] = None) -> torch.Tensor:
        """A host source's frames on the device, read synchronously: on the
        card through a pinned buffer, on the CPU into ``dest`` or a new
        buffer; the read counts under the pass ``label``."""
        if self.device.type != "cuda":
            n = len(frame_list(frames, self.shape[0]))
            out = dest if dest is not None else torch.empty((n,) + self.shape[1:],
                                                            dtype=self.stream_dtype)
            return self._host_read(frames, out, label)
        out, event = _PinnedStager(self, 2, label).stage(frames, dest)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            out.record_stream(stream)
        return out

    def _fetch(self, frames, stager: Optional[_PinnedStager] = None,
               dest: Optional[torch.Tensor] = None, label: Optional[str] = None):
        """(chunk, event): the (t, d1, d2) frames in the stream dtype on the
        device, from the cache or a device-resident movie (a view for a
        contiguous range), else from the host (staged through ``stager`` on
        the card, event None otherwise). A device-resident movie in a dtype
        K1 and K2 do not read is cast to float32 here, one chunk at a time.
        A host read without a stager counts under the pass ``label``."""
        if self._cache_serves(frames):
            if isinstance(frames, slice):
                return self._cache[frames], None
            return TensorMovie(self._cache).gather(frame_list(frames, self.shape[0])), None
        if self._device_resident:
            if isinstance(frames, slice):
                chunk = self.dataset.frames(frames)
            else:
                chunk = self.dataset.gather(frame_list(frames, self.shape[0]))
            return chunk.to(self.stream_dtype), None
        if stager is not None:
            return stager.stage(frames, dest)
        return self._host_chunk(frames, dest, label), None

    def _load_raw(self, frames, label: Optional[str] = None) -> torch.Tensor:
        """(t, d1, d2) frames on the device, read now: a slice for a
        contiguous range, else a gather of the frame list; a host read
        counts under the pass ``label``."""
        if not isinstance(frames, slice):
            frames = list(frames)
            if frames == list(range(frames[0], frames[0] + len(frames))):
                frames = slice(frames[0], frames[0] + len(frames))
        return self._fetch(frames, label=label)[0]

    def _stream_chunk_frames(self) -> int:
        """Frames a streamed chunk holds: max(1 GiB, the card's memory / 16)
        per f32 frame, capped at ``batch_size`` (loader.py:650-658)."""
        per_frame = self.n_pixels * 4
        budget = max(STREAM_CHUNK_BYTES, transient_budget_bytes(self.device))
        return max(64, min(self.batch_size, budget // per_frame))

    def _stream(self, items: Sequence, eager: bool = False, cache_dest: bool = False,
                label: Optional[str] = None):
        """The device chunks of ``items`` (slices or frame lists), as a
        context manager whose ``with`` block iterates them and whose exit
        closes the stream. Host sources stream on a prefetch worker
        (``_StagedChunks``), through a pinned ring on the card; chunks the
        cache or a device-resident movie serves are views, fetched as they
        are iterated. With ``cache_dest`` (the stats pass) a range inside
        the cache being built is copied straight into it. The stream's
        reads and waits count under the pass ``label`` (``transfers``)."""
        items = list(items)

        def dest_of(item):
            if not cache_dest or self._cache is None or not isinstance(item, slice):
                return None
            a, b, _ = item.indices(self.shape[0])
            return self._cache[a:b] if b <= self._cache.shape[0] else None

        if self._device_resident or all(self._cache_serves(it) for it in items):
            return contextlib.closing(self._fetch(it)[0] for it in items)
        on_card = self.device.type == "cuda"
        depth = min(self._prefetch_depth, 2) if on_card else self._prefetch_depth
        stager = _PinnedStager(self, depth + 2, label) if on_card else None

        def load(item):
            return self._fetch(item, stager, dest_of(item), label)

        return _StagedChunks(items, load, stager, depth=depth, eager=eager,
                             counters=self.transfers,
                             wait_key=_pass_key(label, "chunk_wait_s"))

    def _iter_raw_chunks(self, chunk_frames: Optional[int] = None, merge_tail: bool = True,
                         eager: bool = False, cache_dest: bool = False, host_partition=None,
                         label: Optional[str] = None):
        """Native-dtype frame chunks over the whole movie (loader.py:660-724),
        ranges split at the cache boundary so each chunk is served wholly
        from the card or wholly from the dataset. With more than one rank,
        ``host_partition`` "chunks" streams this rank's whole chunks and
        "frames" its stripe of frames. ``label`` is the pass (``_stream``)."""
        chunk_frames = chunk_frames or self._stream_chunk_frames()
        ranges = _chunk_ranges(self.shape[0], chunk_frames, merge_tail=merge_tail)
        world, rank = world_and_rank(self._mesh)
        if host_partition and world > 1:
            part = partition_chunks_for_host if host_partition == "chunks" else partition_ranges_for_host
            ranges = part(ranges, rank, world)
        c = self._cache_frames
        if self._cache is not None and 0 < c < self.shape[0]:
            ranges = [piece for a, b in ranges
                      for piece in ([(a, c), (c, b)] if a < c < b else [(a, b)])]
        return self._stream([slice(a, b) for a, b in ranges], eager=eager, cache_dest=cache_dest,
                            label=label)

    # -- the device movie cache -------------------------------------------------

    def _plan_cache_frames(self) -> int:
        """How many leading frames to keep on the device during the stats
        pass (loader.py:535-583): ``cache_fraction`` of the free device
        memory (``utils.device_free_bytes``: the caching allocator's
        reserved but unallocated blocks count as free, as JAX counts
        ``bytes_limit - bytes_in_use``), at the bytes a frame takes in the
        cache, in whole stats chunks; on the CPU (no memory query) all of
        them with ``cache_movie=True``, none otherwise. The cache holds the
        stream dtype: the source's stored dtype wherever K1 and K2 read it
        (``kernels.KERNEL_DTYPES``; so a TIFF read as float32 from int16
        caches int16), as JAX plans it (loader.py:548-551)."""
        if self._device_resident or not self._cache_policy:
            return 0
        t_total = self.shape[0]
        free = device_free_bytes(self.device)
        if free is None:
            return t_total if self._cache_policy is True else 0
        per_frame = self.n_pixels * torch.empty(0, dtype=self.stream_dtype).element_size()
        n = min(t_total, max(0, int(free * self._cache_fraction)) // per_frame)
        if n < t_total:
            n = (n // self.frame_constant) * self.frame_constant
        # not worth the bookkeeping below a couple of stats chunks
        if n < min(t_total, 2 * self.frame_constant):
            return 0
        return int(n)

    def release_cache(self) -> None:
        """Drop the movie cache (frees its device memory); later reads
        stream from the dataset again (loader.py:585-598)."""
        if self._cache is not None:
            display(f"Releasing the device movie cache ({self._cache_frames} frames)")
        self._cache = None
        self._cache_frames = 0
        if self._v_prefetch is not None:
            # its chunk ranges were split at the old cache boundary
            self._v_prefetch["iter"].close()
            self._v_prefetch = None

    def _cache_serves(self, frames) -> bool:
        """True iff ``frames`` lies entirely inside the cached prefix (and
        the cache is complete)."""
        if self._cache is None or self._cache_frames == 0 or self._cache_building:
            return False
        n = self._cache_frames
        if isinstance(frames, slice):
            start, stop, step = frames.indices(self.shape[0])
            return step == 1 and stop <= n
        if isinstance(frames, (int, np.integer)):
            return 0 <= int(frames) < n
        arr = np.asarray(frames)
        return arr.size > 0 and int(arr.min()) >= 0 and int(arr.max()) < n

    # -- V-regression stream overlap ---------------------------------------------

    def start_v_prefetch(self) -> bool:
        """Start the V regression's chunk stream now (loader.py:728-764): its
        disk reads and copies need nothing but the dataset, so they run
        while the factorized SVD computes. False when the movie is
        device-resident or wholly cached, or a stream is already pending."""
        if self._device_resident or self._v_prefetch is not None:
            return False
        if 0 < self.shape[0] <= self._cache_frames:
            return False
        it = self._iter_raw_chunks(eager=True, host_partition="frames", label="vreg")
        if not isinstance(it, _PrefetchIter):
            return False
        self._v_prefetch = {"iter": it, "cache_frames": self._cache_frames,
                            "started": time.perf_counter()}
        return True

    def _take_v_prefetch(self):
        """The pending stream, or None when there is none or the cache was
        dropped after it started (loader.py:766-778); sets the counters
        ``vreg.prefetched`` and ``vreg.prefetch_lead_s``
        (``pipeline_record``)."""
        h = self._v_prefetch
        self._v_prefetch = None
        if h is not None and h["cache_frames"] != self._cache_frames:
            h["iter"].close()
            h = None
        self.transfers["vreg.prefetched"] = int(h is not None)
        self.transfers["vreg.prefetch_lead_s"] = (
            time.perf_counter() - h["started"] if h is not None else 0.0)
        return h["iter"] if h is not None else None

    # -- statistics -----------------------------------------------------------

    def without_cache_on_oom(self, fn, *args):
        """``fn(*args)``, once more after a device OOM while the movie cache
        is up or being built: the cache goes (and a pending V prefetch with
        it), its policy turns off (loader.py:782-813, pipeline.py:598-607,
        1314-1376). Any other error propagates untouched. With more than one
        rank the cache is never up (``_initialize_normalizers`` turns it
        off), so no rank retries alone while the others wait."""
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001
            if not is_device_oom(e) or (self._cache is None and not self._cache_building):
                raise
        display(f"WARNING: {getattr(fn, '__name__', fn)} hit device OOM; "
                "dropping the movie cache and running it again")
        self._cache_building = False
        self.release_cache()
        self._cache_policy = False
        gc.collect()
        return fn(*args)

    def _run_stats_with_oom_retry(self) -> None:
        """The statistics pass under ``without_cache_on_oom``."""
        self.without_cache_on_oom(self._initialize_normalizers)

    def _initialize_normalizers(self) -> None:
        display("Computing video statistics (mean + noise sigma)")
        t_total, d1, d2 = self.shape
        normalizer_flag = self._compute_normalizer and t_total >= MIN_NOISE_FRAMES
        ref_compat = self.welch_compat == "reference"
        mean_acc = torch.zeros((d1, d2), dtype=torch.float32, device=self.device)
        noise_acc = torch.zeros((d1, d2), dtype=torch.float32, device=self.device)
        noise_chunks = 0
        world, _ = world_and_rank(self._mesh)
        if world > 1 and self._cache_policy:
            display("multi-rank run: device movie cache disabled (per-rank stats stripes)")
            self._cache_policy = False
        cache_target = self._plan_cache_frames()
        if cache_target:
            self._cache = torch.empty((cache_target, d1, d2), dtype=self.stream_dtype,
                                      device=self.device)
        self._cache_building = cache_target > 0
        hook, self._stats_started_hook = self._stats_started_hook, None  # once: an OOM retry reruns this
        if hook is not None:
            try:
                hook(self, cache_target)
            except Exception as e:  # noqa: BLE001 - the hook computes nothing the pass needs
                get_logger().debug("stats_started_hook failed: %r", e)
                self.stats_hook_error = e
        pos = 0
        # Unmerged ranges: a tail shorter than MIN_NOISE_FRAMES adds to the
        # mean only, as the reference stats loop does.
        with self._iter_raw_chunks(self.frame_constant, merge_tail=False, cache_dest=True,
                                   host_partition="chunks", label="stats") as chunks:
            for raw in chunks:
                t_c = raw.shape[0]
                pos += t_c
                if pos <= cache_target:
                    self._cache_frames = pos
                with_noise = normalizer_flag and t_c >= MIN_NOISE_FRAMES
                m, sig = kernels.movie_stats(
                    raw.reshape(t_c, d1 * d2), t_total,
                    compute_noise=with_noise, nperseg=t_c if ref_compat else NPERSEG,
                )
                if with_noise:
                    noise_acc = noise_acc + sig.reshape(d1, d2)
                    noise_chunks += 1
                mean_acc = mean_acc + m.reshape(d1, d2)
        if world > 1:
            # the only statistics traffic between ranks: each rank's two
            # images and chunk count, summed in rank order (loader.py:902-922)
            # so every rank gets the same bits
            n_pix = d1 * d2
            mine = torch.cat([mean_acc.reshape(-1), noise_acc.reshape(-1),
                              torch.tensor([float(noise_chunks)], device=self.device)])
            parts = all_gather_into(self._mesh, mine[None])               # (world, 2 P + 1)
            total = parts[0]
            for r in range(1, world):
                total = total + parts[r]
            mean_acc = total[:n_pix].reshape(d1, d2)
            noise_acc = total[n_pix : 2 * n_pix].reshape(d1, d2)
            noise_chunks = int(total[-1])
        self._cache_building = False
        if self._cache is not None:
            display(f"Device movie cache: {self._cache_frames}/{t_total} frames (native dtype)")
        self.mean_img = mean_acc
        if normalizer_flag and noise_chunks > 0:
            std = noise_acc / np.float32(noise_chunks)
            std = torch.where(std == 0, torch.ones_like(std), std)
        else:
            std = torch.ones((d1, d2), dtype=torch.float32, device=self.device)
        self.std_img = std
        display("Finished mean and noise estimation")

    # -- background -----------------------------------------------------------

    def _background_frames(self, n_samples: int = 1000) -> list:
        t_total = self.shape[0]
        n = min(n_samples, t_total)
        return np.sort(self._np_rng.choice(t_total, size=n, replace=False)).tolist()

    def _initialize_background(self) -> None:
        """Rank-``background_rank`` rSVD of <= 1000 random standardized
        frames (loader.py:944-975); basis rows follow ``order``."""
        if self.background_rank <= 0:
            self.spatial_basis = torch.zeros(
                (self.n_pixels, 1), dtype=torch.float32, device=self.device
            )
            return
        display("Computing low-rank background basis")
        frames = self._background_frames()
        d1, d2 = self.shape[1], self.shape[2]
        # frames-major, C-order pixels (the raw layout): the rSVD of the
        # (d, n) matrix is row-permutation equivariant, so only the (d, K)
        # basis is reordered to ``order`` -- no movie-sized transpose
        x = self._load_raw(frames, "background").reshape(len(frames), d1 * d2).to(torch.float32)
        x = (x - self.mean_img.reshape(-1)) / self.std_img.reshape(-1)
        u, _, _ = truncated_random_svd(x.T, self.background_rank, generator=self._generator)
        self.spatial_basis = _rows_from_c(u, d1, d2, self.order)

    # -- raw and standardized crops -------------------------------------------

    def temporal_crop(self, frames) -> torch.Tensor:
        """(d1, d2, T) frames (a slice or ids) in the loader's ``dtype`` on
        its device (loader.py:522-525)."""
        return self._load_raw(frames, "crop").to(self._crop_dtype).permute(1, 2, 0)

    def temporal_crop_standardized(self, frames) -> torch.Tensor:
        """(d1, d2, T) frames standardized with the loader's statistics,
        (x - mean) / std in the loader's ``dtype`` (loader.py:988-992); no
        background filter."""
        mean = self.mean_img.to(self._crop_dtype)[..., None]
        std = self.std_img.to(self._crop_dtype)[..., None]
        return (self.temporal_crop(frames) - mean) / std

    # -- standardized init frames ---------------------------------------------

    def temporal_crop_with_filter(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standardized, background-filtered init frames (d1, d2, T) and the
        background temporal basis (K, T), on the device. Processed in
        spans of ``_stream_chunk_frames`` frames (loader.py:994-1040), read
        by the prefetch worker for host sources, each written into one
        output buffer."""
        frames = list(frames)
        t = len(frames)
        d1, d2 = self.shape[1], self.shape[2]
        step = self._stream_chunk_frames()
        spans = list(range(0, t, step))
        contiguous = frames == list(range(frames[0], frames[0] + t))
        items = [
            slice(frames[0] + s, frames[0] + min(s + step, t)) if contiguous else frames[s : s + step]
            for s in spans
        ]
        if len(spans) == 1:
            return _standardize_frames(self._load_raw(items[0], "crop"), self.mean_img,
                                       self.std_img, self.spatial_basis, self.order)
        buf = torch.empty((d1, d2, t), dtype=torch.float32, device=self.device)
        tb_chunks = []
        with self._stream(items, label="crop") as chunks:
            for start, raw in zip(spans, chunks):
                filt, tb = _standardize_frames(
                    raw, self.mean_img, self.std_img, self.spatial_basis, self.order
                )
                buf[:, :, start : start + filt.shape[2]] = filt
                tb_chunks.append(tb)
        return buf, torch.cat(tb_chunks, dim=1)

    # -- streamed temporal regression -----------------------------------------

    def prepare_vproj_cells(self, u):
        """Build the cell route for ``u`` ahead of ``v_projection``, which
        takes it (loader.py:1046-1068): its operands need only U and the
        statistics images, so the pipeline calls this right after U is
        assembled and the build runs while the factorized SVD is queued.
        Made once per ``u`` (keyed on its panels); returns (m_cell, q)."""
        route = self._cell_route
        if route is None or route.panels is not u.panels:
            route = self._cell_route = _CellRoute(self, u)
        return route.m_cell, route.q

    def v_projection(self, u, p: torch.Tensor) -> torch.Tensor:
        """V = P^T U^T standardize(movie), the second full pass: (r', T).

        The route is chosen from ``u``: on a regular grid with
        ``blocksparse.COSET_VPROJ`` on, each raw chunk goes through the cell
        route (``_CellRoute``: one batched product against the packed
        per-cell panels; loader.py:1097-1130); otherwise the folded
        projector A~ = (U P)/std is built once and each chunk is one K2
        call (``_K2Route``). With a mesh each rank streams its stripe of
        frames and the stripes are gathered, so every rank returns the
        whole V (loader.py:1070-1227). The loader keeps no route after it,
        and no cell operands; its counters are ``pipeline_record``'s."""
        for key in ("vreg.k2_calls", "vreg.cell_calls"):
            count(self.transfers, key, 0)
        if blocksparse.coset_vproj_eligible(u):
            self.prepare_vproj_cells(u)
            route, self._cell_route = self._cell_route, None
        else:
            route, self._cell_route = _K2Route(self, u), None
        self._spans.append(route.spans)
        route.bind(p)
        with self._take_v_prefetch() or self._iter_raw_chunks(host_partition="frames",
                                                              label="vreg") as chunks:
            results = [route(raw) for raw in chunks]
        del route  # the cell operands go before V is gathered
        if len(results) == 1:
            v = results[0]
        elif results:
            v = torch.cat(results, dim=1)
        else:  # a trailing rank's empty stripe
            v = p.new_zeros((p.shape[1], 0))
        if self._mesh is None:
            return v
        return replicate_frame_sharded(self._mesh, v, self.shape[0])

    # -- the call's record --------------------------------------------------------

    def pipeline_record(self) -> dict:
        """The loader's part of ``PMDArray.pipeline_cache``, read after the
        caller's last fence, which the V regression's device spans need to
        settle (no synchronize of their own). Its keys:

        - ``cached_frames``, ``total_frames``, ``stream_dtype`` (the dtype
          chunks reached K1 and K2 in), ``pinned_copies`` and
          ``pinned_bytes`` (host->device copies of movie frames);
        - per pass ``<pass>`` (``stats``, ``crop``, ``background``,
          ``vreg``) that read a host source: ``.host_read_s`` and
          ``.host_read_bytes`` (``loader.host_read``), ``.host_reads`` and
          ``.host_read_split`` (those the dataset's ``read_threads`` split),
          ``.slot_wait_s`` (``loader.slot_wait``) and ``.chunk_wait_s``
          (``loader.chunk_wait``); chunks the card serves count nothing;
        - ``vreg.streamed_frames``: frames the V regression read from the
          dataset (0 where the cache or a device-resident movie served
          them all); ``vreg.prefetched`` (1 where it took the stream
          ``start_v_prefetch`` opened before the factorized SVD, 0 where it
          opened its own or a cache drop closed that one) and
          ``vreg.prefetch_lead_s`` (host seconds from that start to the
          take; 0 without one);
        - ``vreg.k2_calls`` and ``vreg.cell_calls`` (chunks per route); on
          the K2 route ``vreg.k2_width`` (r') and ``vreg.k2_frames``; while
          the profiler runs, ``vreg.layout_s`` and ``vreg.k2_s``, the device
          seconds of the ``vreg.layout`` and ``vreg.k2`` spans."""
        for spans in self._spans:
            spans.settle()
        self._spans.clear()
        frame_bytes = self.n_pixels * torch.empty(0, dtype=self.stream_dtype).element_size()
        return {
            "cached_frames": int(self._cache_frames),
            "total_frames": int(self.shape[0]),
            "vreg.prefetched": 0,
            "vreg.prefetch_lead_s": 0.0,
            **self.transfers,
            "vreg.streamed_frames": int(self.transfers.get("vreg.host_read_bytes", 0)) // frame_bytes,
            "stream_dtype": str(self.stream_dtype).removeprefix("torch."),
        }
