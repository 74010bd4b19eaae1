"""Lazy dataset protocol and movie sources (counterpart of
localmd_tpu/dataset.py:36-469).

Datasets yield ``(T, d1, d2)`` numpy frames on the host with the JAX
package's indexing semantics (``PMDDataset.__getitem__``); all device
placement happens in the loader. Each file source also has
``read_into(frames, out)``, which writes the frames in their stored dtype
straight into a caller's buffer (the loader's pinned staging buffer):
``RawBinaryArray`` and ``NpyArray`` through the native scatter reader
(``io.native``), ``TiffArray`` through its page index, ``NumpyArray``
split along the frames over ``set_io_threads`` copy threads (a shared pool
per thread count) once each part holds ``READ_SPLIT_BYTES``.

``TensorMovie`` (also exported as ``DeviceMovie``) is the counterpart of the
JAX package's ``DeviceMovie``: a tensor on the loader's device is
device-resident -- the loader slices frames on the device and nothing
crosses the host link, so it is never prefetched or cached.
"""

from __future__ import annotations

import os
import threading
import warnings
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from localmd_tpu_torch.io.tiff import TiffReader

FrameIndexer = Union[int, list, np.ndarray, slice, range]

READ_SPLIT_BYTES = 1 << 24   # the least of the source a copy thread of NumpyArray.read_into takes

# ``NumpyArray.read_into``'s copy threads, one pool per thread count, kept
# for the process: a caller makes a new dataset per call
_COPY_POOLS: dict = {}
_COPY_POOLS_LOCK = threading.Lock()
# a forked child has none of its parent's threads
os.register_at_fork(after_in_child=_COPY_POOLS.clear)


def _copy_pool(n_threads: int) -> ThreadPoolExecutor:
    """The shared pool of ``n_threads - 1`` workers (the caller copies one
    part itself)."""
    with _COPY_POOLS_LOCK:
        pool = _COPY_POOLS.get(n_threads)
        if pool is None:
            pool = _COPY_POOLS[n_threads] = ThreadPoolExecutor(
                n_threads - 1, thread_name_prefix=f"localmd-copy{n_threads}")
        return pool


def frame_list(frames, n_frames: int) -> list:
    """The frame ids of an int, slice, range or sequence, as a list."""
    if isinstance(frames, slice):
        return list(range(*frames.indices(n_frames)))
    if isinstance(frames, (int, np.integer)):
        return [int(frames)]
    return [int(i) for i in frames]


class PMDDataset(ABC):
    """Numpy-like lazy random access to a (T, d1, d2) movie.

    Implement ``dtype``, ``shape`` and ``_compute_at_indices`` to support a
    new file format (dataset.py:36-100)."""

    @property
    @abstractmethod
    def dtype(self) -> np.dtype:
        ...

    @property
    @abstractmethod
    def shape(self) -> Tuple[int, int, int]:
        """(n_frames, d1, d2)."""
        ...

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @abstractmethod
    def _compute_at_indices(self, indices: Union[list, int, slice]) -> np.ndarray:
        """Return frames at the requested temporal indices as (T, d1, d2)."""
        ...

    def read_into(self, frames, out: np.ndarray) -> np.ndarray:
        """Write the frames at ``frames`` (slice or ids) into ``out``
        (n, d1, d2), casting to ``out``'s dtype."""
        got = np.asarray(self._compute_at_indices(frames))
        np.copyto(out, got.reshape(out.shape), casting="unsafe")
        return out

    def _normalize_frame_indexer(self, frame_indexer: FrameIndexer):
        n = self.shape[0]
        if isinstance(frame_indexer, np.ndarray):
            frame_indexer = frame_indexer.tolist()
        if isinstance(frame_indexer, np.integer):
            frame_indexer = int(frame_indexer)
        if isinstance(frame_indexer, (slice, range)):
            start, stop, step = frame_indexer.start, frame_indexer.stop, frame_indexer.step
            if start is not None and start > n:
                raise IndexError(f"frame start {start} beyond n_frames {n}")
            if stop is not None and stop > n:
                raise IndexError(f"frame stop {stop} beyond n_frames {n}")
            return slice(start, stop, step if step is not None else 1)
        if isinstance(frame_indexer, (int, list)):
            return frame_indexer
        raise IndexError(f"Invalid frame indexer type: {type(frame_indexer)}")

    def __getitem__(self, item):
        if isinstance(item, tuple):
            if len(item) > len(self.shape):
                raise IndexError(
                    f"Too many indices ({len(item)}) for {len(self.shape)}-d dataset"
                )
            frame_indexer = item[0]
        else:
            frame_indexer = item

        frame_indexer = self._normalize_frame_indexer(frame_indexer)
        frames = self._compute_at_indices(frame_indexer)
        if frames.ndim < len(self.shape):
            frames = np.expand_dims(frames, axis=0)

        if isinstance(item, tuple):
            if len(item) == 2:
                frames = frames[:, item[1]]
            elif len(item) == 3:
                frames = frames[:, item[1], item[2]]
        return frames.squeeze()


# the reference's class name (reference dataset.py:7)
lazy_data_loader = PMDDataset


class NumpyArray(PMDDataset):
    """Adapter wrapping an in-memory (T, d1, d2) ndarray. ``read_into``
    copies a large read on up to ``set_io_threads`` threads (4 by default;
    the loader passes its ``num_workers``), each a contiguous run of the
    frames: ``np.copyto`` releases the GIL."""

    _io_threads = 4

    def __init__(self, array: np.ndarray):
        array = np.asarray(array)
        if array.ndim != 3:
            raise ValueError("NumpyArray expects a (T, d1, d2) array")
        self._array = array

    @property
    def dtype(self) -> np.dtype:
        return self._array.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._array.shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        return np.asarray(self._array[indices])

    def set_io_threads(self, n: int) -> None:
        self._io_threads = max(1, int(n))

    def read_threads(self, n_frames: int) -> int:
        """The threads ``read_into`` copies ``n_frames`` frames on: up to
        the ``set_io_threads`` count and ``n_frames``, while each thread's
        part keeps about ``READ_SPLIT_BYTES`` of the source; one below."""
        frame_bytes = self._array.dtype.itemsize * self.shape[1] * self.shape[2]
        return max(1, min(self._io_threads, int(n_frames),
                          int(n_frames) * frame_bytes // READ_SPLIT_BYTES))

    def _frame_keys(self, frames):
        """(n, key): the n frames ``frames`` selects, and ``key(a, b)``,
        the key of the frames ``a:b`` of them. A slice of positive step
        gives slices; any other key runs of its frame ids, which numpy
        reads from the key as it reads ``self._array[frames]``."""
        if isinstance(frames, slice):
            start, stop, step = frames.indices(self.shape[0])
            if step > 0:
                return len(range(start, stop, step)), \
                    lambda a, b: slice(start + a * step, start + b * step, step)
        ids = np.arange(self.shape[0])[frames].reshape(-1)
        return ids.shape[0], lambda a, b: ids[a:b]

    def read_into(self, frames, out: np.ndarray) -> np.ndarray:
        n_threads = self.read_threads(out.shape[0] if out.ndim else 0)
        n, key = self._frame_keys(frames) if n_threads > 1 else (None, None)
        if n_threads < 2 or n != out.shape[0]:
            return super().read_into(frames, out)

        def copy(a, b):
            dest = out[a:b]
            np.copyto(dest, self._array[key(a, b)].reshape(dest.shape), casting="unsafe")

        bounds = [n * i // n_threads for i in range(n_threads + 1)]
        first, *rest = zip(bounds, bounds[1:])
        pool = _copy_pool(n_threads)
        futures = [pool.submit(copy, a, b) for a, b in rest]
        try:
            copy(*first)
        finally:
            wait(futures)
        for future in futures:      # the first part's exception is raised
            future.result()
        return out


class TiffArray(PMDDataset):
    """Multipage TIFF movie (reference dataset.py:131-181), backed by the
    port's :class:`io.tiff.TiffReader` (mmap and a one-time page index).

    When the native parser rejects a file and ``tifffile`` is importable,
    the array falls back to a tifffile backend with a warning; without
    tifffile the error names both (dataset.py:140-177)."""

    def __init__(self, filename: str):
        self.filename = filename
        self._tifffile = None
        try:
            self._reader = TiffReader(filename)
        except ValueError as native_err:
            try:
                import tifffile
            except ImportError:
                raise ValueError(
                    f"{native_err} — and the 'tifffile' fallback is not "
                    "installed (pip install tifffile to read formats outside "
                    "the native reader's subset)"
                ) from native_err
            warnings.warn(
                f"native TIFF reader rejected {filename!r} ({native_err}); "
                "falling back to tifffile (slower random access)",
                stacklevel=2,
            )
            self._reader = None
            self._tifffile = tifffile
            with tifffile.TiffFile(filename) as tf:
                n = len(tf.pages)
                p0 = tf.pages[0]
                page_shape = tuple(p0.shape)
                if len(page_shape) != 2:
                    raise ValueError(
                        f"{filename}: pages have shape {page_shape}; only "
                        "single-sample (grayscale) movies are supported — "
                        "convert multi-channel data to grayscale first"
                    ) from native_err
                self._tf_shape = (n,) + page_shape
                self._tf_dtype = np.dtype(p0.dtype)

    def set_io_threads(self, n: int) -> None:
        """Map the pipeline's ``num_workers`` onto the native reader's
        thread count."""
        if self._reader is None:
            return
        reader = getattr(self._reader, "_fast_reader", None)
        if reader is not None:
            reader.n_threads = max(1, int(n))
        self._reader._io_threads = max(1, int(n))

    @property
    def dtype(self) -> np.dtype:
        # the reference TiffArray presents data as float32 (reference dataset.py:143-148)
        return np.dtype(np.float32)

    @property
    def raw_dtype(self) -> np.dtype:
        return self._reader.dtype if self._reader is not None else self._tf_dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        if self._reader is None:
            return self._tf_shape
        return (len(self._reader),) + self._reader.frame_shape

    def _indices(self, indices) -> list:
        if isinstance(indices, int):
            return [indices]
        if isinstance(indices, slice):
            return list(range(indices.start or 0, indices.stop or self.shape[0], indices.step or 1))
        return list(indices)

    def _compute_at_indices(self, indices) -> np.ndarray:
        idx = self._indices(indices)
        if self._reader is None:
            out = self._tifffile.imread(self.filename, key=idx)
            out = np.asarray(out, dtype=np.float32)
            return out.reshape((len(idx),) + self._tf_shape[1:])
        return self._reader.read_frames(idx).astype(np.float32)

    def read_into(self, frames, out: np.ndarray) -> np.ndarray:
        """Frames in their stored dtype: single-strip plain pages go from
        disk straight into ``out`` through the native reader."""
        idx = frame_list(frames, self.shape[0])
        reader = self._reader
        if reader is not None and out.dtype == reader.dtype and reader._try_native_read(idx, out):
            return out
        if reader is None:
            return super().read_into(idx, out)
        np.copyto(out, reader.read_frames(idx), casting="unsafe")
        return out


class _MemmapFrames(PMDDataset):
    """A C-ordered memmap of frames; ``read_into`` reads contiguous frames
    with the native scatter reader when it is built, else copies from the
    memmap."""

    _mm: np.memmap
    _io_threads = 4

    def set_io_threads(self, n: int) -> None:
        self._io_threads = max(1, int(n))
        reader = getattr(self, "_fast_reader", None)
        if reader is not None:
            reader.n_threads = self._io_threads

    def _native_reader(self):
        from localmd_tpu_torch.io.native import FastReader, native_available

        if not native_available() or not self._mm.flags.c_contiguous:
            return None
        if getattr(self, "_fast_reader", None) is None:
            self._fast_reader = FastReader(self.filename, n_threads=self._io_threads)
        return self._fast_reader

    def read_into(self, frames, out: np.ndarray) -> np.ndarray:
        idx = frame_list(frames, self.shape[0])
        if idx and (min(idx) < 0 or max(idx) >= self.shape[0]):
            raise IndexError(f"frames out of range for a movie of {self.shape[0]} frames")
        reader = self._native_reader() if out.dtype == self._mm.dtype else None
        if reader is None or not out.flags.c_contiguous:
            np.copyto(out, self._mm[idx], casting="unsafe")
            return out
        frame_bytes = int(np.prod(self.shape[1:])) * self._mm.dtype.itemsize
        base = int(self._mm.offset)
        reader.read_scatter(
            [base + i * frame_bytes for i in idx], [frame_bytes] * len(idx),
            out.reshape(len(idx), -1).view(np.uint8),
        )
        return out


class RawBinaryArray(_MemmapFrames):
    """Headerless binary movie via memmap: shape and dtype supplied by caller."""

    def __init__(self, filename: str, shape: Tuple[int, int, int], dtype="uint16", offset: int = 0):
        self.filename = filename
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)
        self._mm = np.memmap(filename, dtype=self._dtype, mode="r", offset=offset, shape=self._shape)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        return np.asarray(self._mm[indices])


class NpyArray(_MemmapFrames):
    """.npy movie file, memory-mapped."""

    def __init__(self, filename: str):
        self.filename = filename
        self._mm = np.load(filename, mmap_mode="r")
        if self._mm.ndim != 3:
            raise ValueError(".npy movie must be (T, d1, d2)")

    @property
    def dtype(self) -> np.dtype:
        return self._mm.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._mm.shape

    def _compute_at_indices(self, indices) -> np.ndarray:
        return np.asarray(self._mm[indices])


class ZStackArray:
    """Multi-plane volumetric movie: a list of per-plane (T, d1, d2) datasets
    (dataset.py:265-321). Each plane is an independent PMD problem."""

    def __init__(self, planes: Sequence):
        if not planes:
            raise ValueError("ZStackArray needs at least one plane")
        self.planes = [as_dataset(p) for p in planes]
        s0 = self.planes[0].shape
        for p in self.planes[1:]:
            if p.shape != s0:
                raise ValueError("All planes must share shape")

    @property
    def n_planes(self) -> int:
        return len(self.planes)

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.n_planes,) + tuple(self.planes[0].shape)

    @classmethod
    def from_interleaved(cls, source, n_planes: int) -> "ZStackArray":
        """Deinterleave a plane-cycling acquisition (frame t belongs to plane
        ``t % n_planes``) into lazy :class:`PlaneView`s; a ragged last cycle
        cuts every plane to ``T // n_planes`` frames. A tensor source stays
        where it is, as strided tensor views."""
        if n_planes < 1:
            raise ValueError(f"n_planes must be >= 1, got {n_planes}")
        src = as_dataset(source)
        t_total = src.shape[0]
        if t_total < n_planes:
            raise ValueError(
                f"movie has {t_total} frames, fewer than n_planes={n_planes}"
            )
        n_frames = t_total // n_planes
        if isinstance(src, TensorMovie):
            return cls(
                [TensorMovie(src._array[z::n_planes][:n_frames]) for z in range(n_planes)]
            )
        return cls([PlaneView(src, z, n_planes, n_frames) for z in range(n_planes)])


class PlaneView(PMDDataset):
    """Lazy view of plane ``z`` of an interleaved (T*Z, d1, d2) source:
    plane-frame ``t`` is source frame ``z + t * n_planes``."""

    def __init__(self, source, z: int, n_planes: int, n_frames: int = None):
        self._source = as_dataset(source)
        if not 0 <= z < n_planes:
            raise ValueError(f"plane {z} outside 0..{n_planes - 1}")
        self._z = int(z)
        self._n_planes = int(n_planes)
        t_total = self._source.shape[0]
        avail = (t_total - self._z + n_planes - 1) // n_planes
        self._n_frames = int(n_frames) if n_frames is not None else avail
        if self._n_frames > avail:
            raise ValueError(
                f"plane {z} has only {avail} frames, asked for {self._n_frames}"
            )
        raw = getattr(self._source, "raw_dtype", None)
        if raw is not None:
            self.raw_dtype = raw

    @property
    def dtype(self) -> np.dtype:
        return self._source.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        _, d1, d2 = self._source.shape
        return (self._n_frames, d1, d2)

    def set_io_threads(self, n: int) -> None:
        if hasattr(self._source, "set_io_threads"):
            self._source.set_io_threads(n)

    def read_threads(self, n_frames: int) -> int:
        """The source's threads for a read of ``n_frames`` (1 where it
        does not say)."""
        threads = getattr(self._source, "read_threads", None)
        return threads(n_frames) if threads is not None else 1

    def _plane_index(self, i: int) -> int:
        """One plane-frame index against this view's length: negative ids
        wrap against ``n_frames``, out-of-range ids raise."""
        i0 = int(i)
        i = i0 + self._n_frames if i0 < 0 else i0
        if not 0 <= i < self._n_frames:
            raise IndexError(
                f"frame {i0} out of range for plane with {self._n_frames} frames"
            )
        return self._z + i * self._n_planes

    def _global(self, indices) -> list:
        if isinstance(indices, int):
            return [self._plane_index(indices)]
        if isinstance(indices, slice):
            rng = range(*indices.indices(self.shape[0]))
            return [self._z + i * self._n_planes for i in rng]
        return [self._plane_index(i) for i in indices]

    def _compute_at_indices(self, indices) -> np.ndarray:
        global_idx = self._global(indices)
        src = self._source
        if hasattr(src, "_compute_at_indices"):
            out = np.asarray(src._compute_at_indices(global_idx))
        else:
            out = np.asarray(src[global_idx])
        if out.ndim == 2:
            out = out[None]
        return out

    def read_into(self, frames, out: np.ndarray) -> np.ndarray:
        global_idx = self._global(frame_list(frames, self.shape[0]))
        if hasattr(self._source, "read_into"):
            return self._source.read_into(global_idx, out)
        np.copyto(out, np.asarray(self._source[global_idx]).reshape(out.shape), casting="unsafe")
        return out


class TensorMovie:
    """A (T, d1, d2) tensor on any device: the counterpart of the JAX
    package's ``DeviceMovie`` (dataset.py:400-444). K1 and K2 read float32,
    uint16, int16, uint8, int8, float16 and bfloat16 in place
    (``ops.kernels.KERNEL_DTYPES``); the loader casts any other real dtype
    (float64, int32, ...) to float32 on the tensor's device, one chunk at a
    time.
    Indexing follows ``DeviceMovie``: out-of-range frame lists raise
    instead of clamping, and results stay tensors on the tensor's device."""

    def __init__(self, array: torch.Tensor):
        if not isinstance(array, torch.Tensor):
            array = torch.as_tensor(np.asarray(array))
        if array.dim() != 3:
            raise ValueError("TensorMovie expects a (T, d1, d2) tensor")
        self._array = array.contiguous()

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def device(self) -> torch.device:
        return self._array.device

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self._array.shape)

    @property
    def ndim(self) -> int:
        return 3

    def __getitem__(self, item):
        if isinstance(item, (list, np.ndarray, range)):
            idx = np.asarray(item, dtype=np.int64)
            t = self.shape[0]
            if idx.size and (int(idx.min()) < -t or int(idx.max()) >= t):
                raise IndexError(f"frame indices out of bounds for movie with {t} frames")
            return self.gather(np.where(idx < 0, idx + t, idx))
        return self._array[item]

    def frames(self, rng: slice) -> torch.Tensor:
        """A contiguous frame range: a view, no copy."""
        return self._array[rng]

    def gather(self, idx) -> torch.Tensor:
        """Frames at the indices ``idx``."""
        arr = self._array
        index = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=arr.device)
        if arr.dtype == torch.uint16:
            # PyTorch covers uint16 with few kernels; gather the same bits
            # as int16, which every backend indexes
            return arr.view(torch.int16).index_select(0, index).view(torch.uint16)
        return arr.index_select(0, index)

    def read_into(self, frames, out: np.ndarray) -> np.ndarray:
        """A host tensor's frames into the numpy buffer ``out``."""
        idx = frame_list(frames, self.shape[0])
        got = self.gather(idx).cpu()
        torch.from_numpy(out).copy_(got.reshape(out.shape))
        return out


# the JAX package's name for a device-resident movie
DeviceMovie = TensorMovie


def read_frames_f32(dataset, frames, device) -> torch.Tensor:
    """The frames ``frames`` (a slice or ids) of a dataset (``as_dataset``'s
    result) as a (t, d1, d2) float32 tensor on ``device``: read once, moved
    in the stored dtype, cast there."""
    chunk = dataset[frames]
    if not isinstance(chunk, torch.Tensor):
        chunk = np.asarray(chunk)
        if not chunk.dtype.isnative or chunk.dtype.kind not in "biuf":
            chunk = chunk.astype(np.float32)
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
    chunk = chunk.to(device).to(torch.float32)
    return chunk[None] if chunk.dim() == 2 else chunk


def as_dataset(obj):
    """Normalize user input (PMDDataset | ndarray | tensor | path |
    duck-typed object), as dataset.py:447-469."""
    if isinstance(obj, (PMDDataset, TensorMovie)):
        return obj
    if isinstance(obj, torch.Tensor):
        return TensorMovie(obj)
    if isinstance(obj, np.ndarray):
        return NumpyArray(obj)
    if isinstance(obj, str):
        if obj.endswith((".tif", ".tiff")):
            return TiffArray(obj)
        if obj.endswith(".npy"):
            return NpyArray(obj)
        raise ValueError(f"Cannot infer dataset type from path: {obj}")
    # duck-typed: anything with shape + frame indexing (reference test_pmd.py:54)
    if hasattr(obj, "shape") and hasattr(obj, "__getitem__"):
        return obj
    raise TypeError(f"Cannot interpret {type(obj)} as a PMD dataset")
