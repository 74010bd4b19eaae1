"""Minimal multipage TIFF / BigTIFF reader.

The reference reads movies with ``tifffile`` (reference dataset.py:131-181).
``tifffile`` is not available in this environment, and for the streaming PMD
pipeline we need fast random access to multipage grayscale stacks — the
dominant format for two-photon / widefield / voltage-imaging movies. This
module implements that subset natively:

- Classic TIFF and BigTIFF, little- and big-endian.
- Per-page strip layout (StripOffsets/StripByteCounts) and tiled layout
  (TileWidth/TileLength/TileOffsets/TileByteCounts), contiguous planar
  grayscale pages.
- dtypes: uint8/16/32, int8/16/32, float32/float64 (SampleFormat tag).
- Compression: none (1), LZW (5, native C++ decoder with Python fallback),
  Adobe/legacy Deflate (8/32946, zlib), PackBits (32773), zstd
  (50000/34926, via the zstandard package), LZMA (34925); horizontal
  differencing predictor (tag 317, value 2).
- ImageJ contiguous hyperstacks: a single IFD with ``ImageJ=…\\nimages=N``
  in ImageDescription and N frames stored back-to-back (how ImageJ writes
  ALL of its >4 GB stacks) is expanded to N synthesized pages.
- OME-TIFF: single-file OME stacks are ordinary multipage TIFFs with an
  OME-XML ImageDescription (exposed as ``reader.description``).

Files outside this subset fall back to ``tifffile`` when it is installed
(see :class:`localmd_tpu_torch.dataset.TiffArray`).

Pages are indexed once at open; uncompressed frame reads are
``np.frombuffer`` slices over a single ``mmap``-backed buffer, so
multi-worker prefetch threads can read without re-parsing headers.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# TIFF tag ids we care about
_TAG_IMAGE_WIDTH = 256
_TAG_IMAGE_LENGTH = 257
_TAG_BITS_PER_SAMPLE = 258
_TAG_COMPRESSION = 259
_TAG_IMAGE_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_BYTE_COUNTS = 279
_TAG_PREDICTOR = 317
_TAG_SAMPLE_FORMAT = 339
_TAG_TILE_WIDTH = 322
_TAG_TILE_LENGTH = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_BYTE_COUNTS = 325

_COMP_NONE = 1
_COMP_LZW = 5
_COMP_DEFLATE_ADOBE = 8
_COMP_PACKBITS = 32773
_COMP_DEFLATE = 32946
_COMP_LZMA = 34925          # tifffile/libtiff extension
_COMP_ZSTD_DRAFT = 34926    # early zstd registration
_COMP_ZSTD = 50000          # zstd id written by tifffile/imagecodecs
_SUPPORTED_COMPRESSIONS = (
    _COMP_NONE, _COMP_LZW, _COMP_DEFLATE_ADOBE, _COMP_PACKBITS, _COMP_DEFLATE,
    _COMP_LZMA, _COMP_ZSTD_DRAFT, _COMP_ZSTD,
)

# TIFF type id -> (struct fmt char, byte size)
_TYPE_INFO = {
    1: ("B", 1),   # BYTE
    2: ("c", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL
    6: ("b", 1),   # SBYTE
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8
}


@dataclass
class _Page:
    width: int
    height: int
    dtype: np.dtype
    strip_offsets: Tuple[int, ...]       # strip OR tile data segments
    strip_byte_counts: Tuple[int, ...]
    compression: int = _COMP_NONE
    predictor: int = 1
    rows_per_strip: int = 0              # 0 = single strip covering the page
    tile_width: int = 0                  # >0 = tiled layout
    tile_length: int = 0

    @property
    def is_plain(self) -> bool:
        """True when frames are raw contiguous samples (the mmap fast path).
        Predictor-differenced pages need the decode path even uncompressed."""
        return (
            self.compression == _COMP_NONE
            and self.tile_width == 0
            and self.predictor == 1
        )


# ---------------------------------------------------------------------------
# Segment decoders
# ---------------------------------------------------------------------------

def _lzw_decode_py(data: bytes, expected: int) -> bytes:
    """Pure-Python TIFF-variant LZW (TIFF 6.0 §13): MSB-first codes, 9-bit
    start, ClearCode=256/EOI=257, early-change width bumps. Fallback for when
    the native decoder (csrc/fastio.cpp fastio_lzw_decode) is unavailable."""
    out = bytearray()
    table: List[bytes] = []

    def reset():
        nonlocal table, width, next_code, prev
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        width = 9
        next_code = 258
        prev = None

    width = 9
    next_code = 258
    prev: Optional[bytes] = None
    reset()

    bitbuf = 0
    bitcnt = 0
    pos = 0
    n = len(data)
    while True:
        while bitcnt < width:
            if pos >= n:
                return bytes(out[:expected])
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == 257:  # EOI
            return bytes(out[:expected])
        if code == 256:  # Clear
            reset()
            continue
        if prev is None:
            if code >= 256:
                raise ValueError("corrupt LZW stream: non-literal after clear")
            entry = table[code]
        elif code < next_code:
            entry = table[code]
        elif code == next_code:
            entry = prev + prev[:1]
        else:
            raise ValueError("corrupt LZW stream: code beyond table")
        out += entry
        if prev is not None and next_code < 4096:
            table.append(prev + entry[:1])
            next_code += 1
            if next_code == (1 << width) - 1 and width < 12:
                width += 1
        prev = entry
        if len(out) >= expected:
            # some writers pad the final strip: truncate like libtiff
            return bytes(out[:expected])


def _lzw_decode(data: bytes, expected: int) -> bytes:
    try:
        from localmd_tpu_torch.io.native import lzw_decode

        decoded = lzw_decode(data, expected)
        if decoded is not None:
            return decoded
    except ImportError:  # pragma: no cover
        pass
    except ValueError:
        # The native decoder is strict (e.g. -ENOSPC when a strip decodes to
        # more than `expected` bytes — some writers pad the final strip); the
        # Python decoder truncates at `expected` like libtiff does.
        pass
    return _lzw_decode_py(data, expected)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n and len(out) < expected:
        ctrl = data[pos]
        pos += 1
        if ctrl < 128:  # literal run of ctrl+1 bytes
            out += data[pos : pos + ctrl + 1]
            pos += ctrl + 1
        elif ctrl > 128:  # replicate next byte 257-ctrl times
            out += data[pos : pos + 1] * (257 - ctrl)
            pos += 1
        # ctrl == 128: no-op
    return bytes(out)


def _decode_segment(data: bytes, compression: int, expected: int) -> bytes:
    if compression == _COMP_NONE:
        return data
    if compression == _COMP_LZW:
        return _lzw_decode(data, expected)
    if compression in (_COMP_DEFLATE_ADOBE, _COMP_DEFLATE):
        return zlib.decompress(data)
    if compression == _COMP_PACKBITS:
        return _packbits_decode(data, expected)
    if compression in (_COMP_ZSTD, _COMP_ZSTD_DRAFT):
        try:
            import zstandard
        except ImportError as e:  # pragma: no cover - zstandard is bundled
            raise ValueError(
                "zstd-compressed TIFF requires the 'zstandard' package"
            ) from e
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=expected
        )
    if compression == _COMP_LZMA:
        import lzma

        return lzma.decompress(data)
    raise ValueError(f"unsupported TIFF compression {compression}")


def _undo_predictor(arr: np.ndarray, predictor: int) -> np.ndarray:
    """Invert horizontal differencing (predictor=2) along the last axis.
    Integer cumsum in the sample dtype gives the required modulo wraparound."""
    if predictor == 1:
        return arr
    if predictor == 2:
        if arr.dtype.kind not in ("u", "i"):
            raise ValueError("predictor=2 requires an integer sample type")
        return np.cumsum(arr, axis=-1, dtype=arr.dtype)
    raise ValueError(f"unsupported TIFF predictor {predictor}")


class TiffReader:
    """Index a multipage TIFF once; expose zero-copy frame reads."""

    def __init__(self, filename: str):
        self.filename = filename
        self._file = open(filename, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            # Empty or unmappable file: read fully.
            self._file.seek(0)
            self._buf = self._file.read()
        self._parse_header()
        self.pages: List[_Page] = self._parse_all_pages()
        if not self.pages:
            raise ValueError(f"{filename}: no TIFF pages found")
        p0 = self.pages[0]
        self.frame_shape = (p0.height, p0.width)
        self.dtype = p0.dtype

    # -- header / IFD parsing -------------------------------------------------

    def _parse_header(self):
        magic = bytes(self._buf[:2])
        if magic == b"II":
            self._bo = "<"
        elif magic == b"MM":
            self._bo = ">"
        else:
            raise ValueError(f"{self.filename}: not a TIFF file")
        version = struct.unpack(self._bo + "H", self._buf[2:4])[0]
        if version == 42:
            self._big = False
            self._first_ifd = struct.unpack(self._bo + "I", self._buf[4:8])[0]
        elif version == 43:
            self._big = True
            offsize = struct.unpack(self._bo + "H", self._buf[4:6])[0]
            if offsize != 8:
                raise ValueError("Unsupported BigTIFF offset size")
            self._first_ifd = struct.unpack(self._bo + "Q", self._buf[8:16])[0]
        else:
            raise ValueError(f"{self.filename}: bad TIFF version {version}")

    def _read_entry_values(self, type_id, count, payload):
        fmt, size = _TYPE_INFO.get(type_id, (None, None))
        if fmt is None:
            return None
        total = size * count
        # A corrupt count can claim billions of values; the struct format
        # string alone would then take minutes to build. No out-of-line
        # entry can exceed the file itself.
        if total > len(self._buf):
            return None
        inline_cap = 8 if self._big else 4
        if total <= inline_cap:
            data = payload[:total]
        else:
            off = struct.unpack(self._bo + ("Q" if self._big else "I"),
                                payload[: (8 if self._big else 4)])[0]
            data = bytes(self._buf[off: off + total])
        if type_id == 5:  # RATIONAL -> float
            vals = struct.unpack(self._bo + "I" * 2 * count, data)
            return tuple(vals[i] / max(vals[i + 1], 1) for i in range(0, 2 * count, 2))
        return struct.unpack(self._bo + fmt * count, data)

    def _parse_ifd(self, offset):
        bo = self._bo
        if self._big:
            n = struct.unpack(bo + "Q", self._buf[offset: offset + 8])[0]
            entry_size, base = 20, offset + 8
        else:
            n = struct.unpack(bo + "H", self._buf[offset: offset + 2])[0]
            entry_size, base = 12, offset + 2
        tags = {}
        for i in range(n):
            e = self._buf[base + i * entry_size: base + (i + 1) * entry_size]
            tag, type_id = struct.unpack(bo + "HH", e[:4])
            if self._big:
                count = struct.unpack(bo + "Q", e[4:12])[0]
                payload = e[12:20]
            else:
                count = struct.unpack(bo + "I", e[4:8])[0]
                payload = e[8:12]
            if tag in (
                _TAG_IMAGE_WIDTH, _TAG_IMAGE_LENGTH, _TAG_BITS_PER_SAMPLE,
                _TAG_COMPRESSION, _TAG_STRIP_OFFSETS, _TAG_SAMPLES_PER_PIXEL,
                _TAG_ROWS_PER_STRIP, _TAG_STRIP_BYTE_COUNTS, _TAG_SAMPLE_FORMAT,
                _TAG_PREDICTOR, _TAG_TILE_WIDTH, _TAG_TILE_LENGTH,
                _TAG_TILE_OFFSETS, _TAG_TILE_BYTE_COUNTS,
                _TAG_IMAGE_DESCRIPTION,
            ):
                values = self._read_entry_values(type_id, count, bytes(payload))
                if values is None or not values:
                    # unknown/corrupt entry type id — treat the tag as absent
                    # so defaults apply or a clear "missing tag" error raises
                    continue
                tags[tag] = values
        next_off_pos = base + n * entry_size
        next_ifd = struct.unpack(
            bo + ("Q" if self._big else "I"),
            self._buf[next_off_pos: next_off_pos + (8 if self._big else 4)],
        )[0]
        return tags, next_ifd

    def _page_from_tags(self, tags) -> _Page:
        comp = tags.get(_TAG_COMPRESSION, (1,))[0]
        if comp not in _SUPPORTED_COMPRESSIONS:
            raise ValueError(
                f"{self.filename}: TIFF compression {comp} not supported "
                "(supported: none, LZW, Deflate, PackBits, zstd, LZMA)"
            )
        spp = tags.get(_TAG_SAMPLES_PER_PIXEL, (1,))[0]
        if spp != 1:
            raise ValueError(f"{self.filename}: only single-sample (grayscale) TIFFs supported")
        width = tags[_TAG_IMAGE_WIDTH][0]
        height = tags[_TAG_IMAGE_LENGTH][0]
        bits = tags.get(_TAG_BITS_PER_SAMPLE, (1,))[0]
        fmt = tags.get(_TAG_SAMPLE_FORMAT, (1,))[0]
        kind = {1: "u", 2: "i", 3: "f"}.get(fmt)
        if kind is None:
            raise ValueError(f"{self.filename}: unsupported SampleFormat {fmt}")
        if bits not in (8, 16, 32, 64):
            raise ValueError(f"{self.filename}: unsupported BitsPerSample {bits}")
        dtype = np.dtype(f"{self._bo}{kind}{bits // 8}")
        predictor = tags.get(_TAG_PREDICTOR, (1,))[0]
        if _TAG_TILE_WIDTH in tags:
            return _Page(
                width=width,
                height=height,
                dtype=dtype,
                strip_offsets=tuple(tags[_TAG_TILE_OFFSETS]),
                strip_byte_counts=tuple(tags[_TAG_TILE_BYTE_COUNTS]),
                compression=comp,
                predictor=predictor,
                tile_width=tags[_TAG_TILE_WIDTH][0],
                tile_length=tags[_TAG_TILE_LENGTH][0],
            )
        return _Page(
            width=width,
            height=height,
            dtype=dtype,
            strip_offsets=tuple(tags[_TAG_STRIP_OFFSETS]),
            strip_byte_counts=tuple(tags[_TAG_STRIP_BYTE_COUNTS]),
            compression=comp,
            predictor=predictor,
            rows_per_strip=tags.get(_TAG_ROWS_PER_STRIP, (height,))[0],
        )

    def _parse_all_pages(self) -> List[_Page]:
        pages = []
        offset = self._first_ifd
        seen = set()
        first_description = None
        while offset and offset not in seen:
            seen.add(offset)
            tags, offset = self._parse_ifd(offset)
            if _TAG_IMAGE_WIDTH in tags:
                if first_description is None and _TAG_IMAGE_DESCRIPTION in tags:
                    vals = tags[_TAG_IMAGE_DESCRIPTION]
                    raw = (
                        b"".join(vals)
                        if vals and isinstance(vals[0], bytes)
                        else bytes(v & 0xFF for v in vals)
                    )
                    first_description = raw.split(b"\x00")[0].decode(
                        "utf-8", "replace"
                    )
                pages.append(self._page_from_tags(tags))
        self.description = first_description
        return self._expand_imagej_hyperstack(pages)

    def _expand_imagej_hyperstack(self, pages: List[_Page]) -> List[_Page]:
        """ImageJ writes stacks (and ALWAYS its >4 GB \"raw\" big stacks)
        with a single IFD whose ImageDescription says ``ImageJ=...`` and
        ``images=N``; the remaining N-1 frames follow the first frame's
        samples contiguously with no IFDs of their own. Synthesize the
        missing pages so random access works like any multipage file
        (tifffile's is_imagej handling; reference reads such files through
        tifffile, reference dataset.py:169-181)."""
        if len(pages) != 1 or not self.description:
            return pages
        desc = self.description
        if not desc.startswith("ImageJ="):
            return pages
        n_images = None
        for line in desc.splitlines():
            if line.startswith("images="):
                try:
                    n_images = int(line.split("=", 1)[1])
                except ValueError:
                    return pages
                break
        p0 = pages[0]
        if (
            n_images is None
            or n_images <= 1
            or p0.compression != _COMP_NONE
            or p0.tile_width
            or len(p0.strip_offsets) != 1
        ):
            return pages
        frame_bytes = p0.width * p0.height * p0.dtype.itemsize
        base = p0.strip_offsets[0]
        # never synthesize frames past the file (truncated acquisitions)
        capacity = (len(self._buf) - base) // frame_bytes
        n_images = min(n_images, max(capacity, 1))
        return [
            _Page(
                width=p0.width, height=p0.height, dtype=p0.dtype,
                strip_offsets=(base + k * frame_bytes,),
                strip_byte_counts=(frame_bytes,),
                compression=_COMP_NONE, predictor=p0.predictor,
                rows_per_strip=p0.rows_per_strip,
            )
            for k in range(n_images)
        ]

    # -- frame access ----------------------------------------------------------

    def __len__(self):
        return len(self.pages)

    def read_frame(self, index: int) -> np.ndarray:
        page = self.pages[index]
        n_px = page.width * page.height
        if not page.is_plain:
            return self._read_frame_decoded(page)
        if len(page.strip_offsets) == 1:
            off = page.strip_offsets[0]
            arr = np.frombuffer(self._buf, dtype=page.dtype, count=n_px, offset=off)
        else:
            parts = [
                np.frombuffer(self._buf, dtype=np.uint8, count=cnt, offset=off)
                for off, cnt in zip(page.strip_offsets, page.strip_byte_counts)
            ]
            arr = np.concatenate(parts).view(page.dtype)[:n_px]
        return arr.reshape(page.height, page.width)

    def _segment_bytes(self, off: int, cnt: int) -> bytes:
        return bytes(self._buf[off : off + cnt])

    def _read_frame_decoded(self, page: _Page) -> np.ndarray:
        """Assemble a compressed and/or tiled page: decode each strip/tile
        segment, invert the predictor per segment row, place into the frame."""
        itemsize = page.dtype.itemsize
        if page.tile_width:
            tw, tl = page.tile_width, page.tile_length
            tiles_across = -(-page.width // tw)
            out = np.empty((page.height, page.width), dtype=page.dtype)
            expected = tw * tl * itemsize
            for n, (off, cnt) in enumerate(
                zip(page.strip_offsets, page.strip_byte_counts)
            ):
                raw = _decode_segment(
                    self._segment_bytes(off, cnt), page.compression, expected
                )
                tile = np.frombuffer(raw, dtype=page.dtype, count=tw * tl).reshape(
                    tl, tw
                )
                tile = _undo_predictor(tile, page.predictor)
                r0 = (n // tiles_across) * tl
                c0 = (n % tiles_across) * tw
                h = min(tl, page.height - r0)
                w = min(tw, page.width - c0)
                out[r0 : r0 + h, c0 : c0 + w] = tile[:h, :w]
            return out
        rps = page.rows_per_strip or page.height
        rows = []
        remaining = page.height
        for off, cnt in zip(page.strip_offsets, page.strip_byte_counts):
            n_rows = min(rps, remaining)
            remaining -= n_rows
            expected = n_rows * page.width * itemsize
            raw = _decode_segment(
                self._segment_bytes(off, cnt), page.compression, expected
            )
            strip = np.frombuffer(
                raw, dtype=page.dtype, count=n_rows * page.width
            ).reshape(n_rows, page.width)
            rows.append(_undo_predictor(strip, page.predictor))
        return np.concatenate(rows, axis=0)

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        out = np.empty((len(indices),) + self.frame_shape, dtype=self.dtype)
        if self._try_native_read(indices, out):
            return out
        for i, idx in enumerate(indices):
            out[i] = self.read_frame(idx)
        return out

    def _try_native_read(self, indices: Sequence[int], out: np.ndarray) -> bool:
        """Threaded scatter read of single-strip pages via the fastio C++
        library; returns False to fall back to the mmap path."""
        if any(
            not self.pages[i].is_plain or len(self.pages[i].strip_offsets) != 1
            for i in indices
        ):
            return False
        try:
            from localmd_tpu_torch.io.native import native_available, FastReader

            if not native_available():
                return False
            if not hasattr(self, "_fast_reader"):
                self._fast_reader = FastReader(
                    self.filename, n_threads=getattr(self, "_io_threads", 4)
                )
            offsets = [self.pages[i].strip_offsets[0] for i in indices]
            sizes = [self.pages[i].strip_byte_counts[0] for i in indices]
            self._fast_reader.read_scatter(offsets, sizes, out)
            return True
        except Exception:
            return False

    def close(self):
        if isinstance(self._buf, mmap.mmap):
            self._buf.close()
        self._file.close()


def write_tiff(filename: str, movie: np.ndarray, rows_per_strip: int = 0) -> None:
    """Write a (T, H, W) array as an uncompressed little-endian multipage TIFF.

    Used for tests and for generating benchmark inputs. ``rows_per_strip``
     0/>=H emits one strip per page (what :class:`TiffReader`'s fast native
    path reads); smaller values emit multi-strip pages (exercising the
    reader's strip-concatenation path, as scanners/writers in the wild do).
    """
    movie = np.asarray(movie)
    if movie.ndim != 3:
        raise ValueError("movie must be (T, H, W)")
    write_tiff_stream(
        filename, iter(movie), movie.shape, movie.dtype,
        rows_per_strip=rows_per_strip,
    )


def write_tiff_stream(
    filename: str,
    frames,
    shape: Tuple[int, int, int],
    dtype,
    rows_per_strip: int = 0,
    bigtiff: Optional[bool] = None,
) -> None:
    """Streaming variant of :func:`write_tiff`: consumes an ITERATOR of
    (H, W) frames so a movie larger than RAM can be exported chunk by chunk
    (the uncompressed layout is fully determined by shape/dtype, so all IFDs
    are emitted up front and frame data appended as produced).

    ``bigtiff``: None (default) auto-selects — classic TIFF while every
    offset fits 32 bits, BigTIFF (version 43, 8-byte offsets) once the
    projected file exceeds 4 GB (classic offsets would silently overflow:
    a 512x512x30k float32 export is 31 GB). True/False forces the format;
    forcing classic on a >4 GB layout raises instead of corrupting.
    """
    t, h, w = shape
    dt = np.dtype(dtype).newbyteorder("<")
    kind = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8
    rps = h if rows_per_strip in (0, None) or rows_per_strip >= h else rows_per_strip
    n_strips = -(-h // rps)
    strip_rows = [min(rps, h - i * rps) for i in range(n_strips)]
    strip_bytes = [r * w * dt.itemsize for r in strip_rows]
    frame_bytes = h * w * dt.itemsize

    n_entries = 8
    if bigtiff is None:
        # projected classic layout: if its final byte passes 2^32 any strip
        # offset near the tail would overflow the 4-byte fields
        ifd_c = 2 + n_entries * 12 + 4
        extra_c = (8 * n_strips) if n_strips > 1 else 0
        projected = 8 + t * (ifd_c + extra_c) + t * frame_bytes
        bigtiff = projected > 0xFFFFFFFF

    if bigtiff:
        header_size = 16
        ifd_size = 8 + n_entries * 20 + 8
        # out-of-line LONG8 strip offset/count arrays when n_strips > 1
        extra_per_page = (16 * n_strips) if n_strips > 1 else 0
        off_type, off_word = 16, "Q"  # LONG8
    else:
        header_size = 8
        ifd_size = 2 + n_entries * 12 + 4
        extra_per_page = (8 * n_strips) if n_strips > 1 else 0
        off_type, off_word = 4, "I"  # LONG

    with open(filename, "wb") as f:
        first_ifd = header_size
        if bigtiff:
            f.write(b"II+\x00" + struct.pack("<HHQ", 8, 0, first_ifd))
        else:
            f.write(b"II*\x00" + struct.pack("<I", first_ifd))
        arrays_start = first_ifd + t * ifd_size
        data_start = arrays_start + t * extra_per_page
        if not bigtiff and data_start + t * frame_bytes > 0xFFFFFFFF:
            raise ValueError(
                "classic TIFF cannot address a "
                f"{data_start + t * frame_bytes} byte file; pass "
                "bigtiff=True (or bigtiff=None for auto-selection)"
            )

        if bigtiff:

            def entry(tag, type_id, count, value):
                f.write(struct.pack("<HHQQ", tag, type_id, count, value))

        else:

            def entry(tag, type_id, count, value):
                f.write(struct.pack("<HHI", tag, type_id, count))
                if type_id == 3:
                    f.write(struct.pack("<HH", value, 0))
                else:
                    f.write(struct.pack("<I", value))

        for k in range(t):
            ifd_off = first_ifd + k * ifd_size
            page_data = data_start + k * frame_bytes
            offsets = []
            acc = 0
            for sb in strip_bytes:
                offsets.append(page_data + acc)
                acc += sb
            next_ifd = first_ifd + (k + 1) * ifd_size if k + 1 < t else 0
            assert f.tell() == ifd_off
            if bigtiff:
                f.write(struct.pack("<Q", n_entries))
            else:
                f.write(struct.pack("<H", n_entries))

            arr_off = arrays_start + k * extra_per_page
            entry(_TAG_IMAGE_WIDTH, 4, 1, w)
            entry(_TAG_IMAGE_LENGTH, 4, 1, h)
            entry(_TAG_BITS_PER_SAMPLE, 3, 1, bits)
            entry(_TAG_COMPRESSION, 3, 1, 1)
            if n_strips > 1:
                entry(_TAG_STRIP_OFFSETS, off_type, n_strips, arr_off)
            else:
                entry(_TAG_STRIP_OFFSETS, off_type, 1, offsets[0])
            entry(_TAG_ROWS_PER_STRIP, 4, 1, rps)
            if n_strips > 1:
                entry(
                    _TAG_STRIP_BYTE_COUNTS, off_type, n_strips,
                    arr_off + dt_itemsize_of(off_word) * n_strips,
                )
            else:
                entry(_TAG_STRIP_BYTE_COUNTS, off_type, 1, strip_bytes[0])
            entry(_TAG_SAMPLE_FORMAT, 3, 1, kind)
            f.write(struct.pack("<Q" if bigtiff else "<I", next_ifd))
        if n_strips > 1:
            for k in range(t):
                page_data = data_start + k * frame_bytes
                offsets = []
                acc = 0
                for sb in strip_bytes:
                    offsets.append(page_data + acc)
                    acc += sb
                f.write(struct.pack("<" + off_word * n_strips, *offsets))
                f.write(struct.pack("<" + off_word * n_strips, *strip_bytes))
        n_written = 0
        for frame in frames:
            frame = np.asarray(frame)
            if frame.shape != (h, w):
                raise ValueError(f"frame shape {frame.shape} != {(h, w)}")
            f.write(np.ascontiguousarray(frame).astype(dt, copy=False).tobytes())
            n_written += 1
        if n_written != t:
            raise ValueError(f"iterator yielded {n_written} frames, expected {t}")


def dt_itemsize_of(word: str) -> int:
    return struct.calcsize("<" + word)


# ---------------------------------------------------------------------------
# Compressed / tiled writer (tests + compressed export)
# ---------------------------------------------------------------------------

def _lzw_encode(data: bytes) -> bytes:
    """TIFF-variant LZW encoder (MSB-first, early change). Python-speed —
    meant for test fixtures and occasional export, not the streaming path."""
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code: int, width: int):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    table = {bytes([i]): i for i in range(256)}
    width = 9
    next_code = 258
    emit(256, width)  # Clear
    s = b""
    for b in data:
        c = s + bytes([b])
        if c in table:
            s = c
            continue
        emit(table[s], width)
        table[c] = next_code
        next_code += 1
        # The decoder adds entries one code behind the encoder and bumps its
        # width when its next_code hits (1<<w)-1 ("early change", verified
        # against PIL-written streams); seen from the encoder that is one
        # entry later, i.e. when next_code hits 1<<w.
        if next_code == (1 << width) and width < 12:
            width += 1
        if next_code >= 4094:  # clear before the table fills
            emit(256, width)
            table = {bytes([i]): i for i in range(256)}
            width = 9
            next_code = 258
        s = bytes([b])
    if s:
        emit(table[s], width)
        # The decoder performs a table add (and possibly an early-change
        # width bump) when it reads this final code; mirror it so EOI is
        # emitted at the width the decoder will read it with.
        next_code += 1
        if next_code == (1 << width) and width < 12:
            width += 1
    emit(257, width)  # EOI
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            j = i
            while j < n - 1 and data[j] != data[j + 1] and j - i < 127:
                j += 1
            out.append(j - i)
            out += data[i : j + 1]
            i = j + 1
    return bytes(out)


def _zstd_encode(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor().compress(data)


def _lzma_encode(data: bytes) -> bytes:
    import lzma

    return lzma.compress(data)


_ENCODERS = {
    "none": (_COMP_NONE, lambda b: b),
    "lzw": (_COMP_LZW, _lzw_encode),
    "deflate": (_COMP_DEFLATE_ADOBE, zlib.compress),
    "packbits": (_COMP_PACKBITS, _packbits_encode),
    "zstd": (_COMP_ZSTD, _zstd_encode),
    "lzma": (_COMP_LZMA, _lzma_encode),
}


def _apply_predictor(seg: np.ndarray, predictor: int) -> np.ndarray:
    if predictor == 1:
        return seg
    if predictor != 2:
        raise ValueError("writer supports predictor 1 or 2")
    if seg.dtype.kind not in ("u", "i"):
        raise ValueError("predictor=2 requires an integer sample type")
    diff = seg.copy()
    diff[:, 1:] -= seg[:, :-1]
    return diff


def write_tiff_compressed(
    filename: str,
    movie: np.ndarray,
    compression: str = "lzw",
    rows_per_strip: int = 0,
    predictor: int = 1,
    tile: Optional[Tuple[int, int]] = None,
) -> None:
    """Write a (T, H, W) array as a compressed (and optionally tiled)
    little-endian multipage TIFF.

    ``compression``: "none" | "lzw" | "deflate" | "packbits".
    ``predictor=2`` applies horizontal differencing before compression.
    ``tile=(tw, tl)`` emits a tiled layout (dims must be multiples of 16 per
    the TIFF spec) instead of strips.
    """
    movie = np.asarray(movie)
    if movie.ndim != 3:
        raise ValueError("movie must be (T, H, W)")
    comp_id, encode = _ENCODERS[compression]
    t, h, w = movie.shape
    dt = movie.dtype.newbyteorder("<")
    kind = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8

    # Per-page compressed segments (strips or tiles).
    pages: List[List[bytes]] = []
    for k in range(t):
        frame = np.ascontiguousarray(movie[k]).astype(dt, copy=False)
        segs: List[bytes] = []
        if tile is not None:
            tw, tl = tile
            if tw % 16 or tl % 16:
                raise ValueError("TIFF tile dims must be multiples of 16")
            for r0 in range(0, h, tl):
                for c0 in range(0, w, tw):
                    block = np.zeros((tl, tw), dtype=dt)
                    hh = min(tl, h - r0)
                    ww = min(tw, w - c0)
                    block[:hh, :ww] = frame[r0 : r0 + hh, c0 : c0 + ww]
                    segs.append(
                        encode(_apply_predictor(block, predictor).tobytes())
                    )
        else:
            rps = (
                h
                if rows_per_strip in (0, None) or rows_per_strip >= h
                else rows_per_strip
            )
            for r0 in range(0, h, rps):
                strip = frame[r0 : r0 + min(rps, h - r0)]
                segs.append(encode(_apply_predictor(strip, predictor).tobytes()))
        pages.append(segs)

    n_segs = len(pages[0])
    tags: List[Tuple[int, int, int]] = [  # (tag, type, value-or-late)
        (_TAG_IMAGE_WIDTH, 4, w),
        (_TAG_IMAGE_LENGTH, 4, h),
        (_TAG_BITS_PER_SAMPLE, 3, bits),
        (_TAG_COMPRESSION, 3, comp_id),
    ]
    n_entries = len(tags) + (3 if tile is None else 4) + 1
    if predictor == 2:
        n_entries += 1
    ifd_size = 2 + n_entries * 12 + 4
    extra_per_page = (8 * n_segs) if n_segs > 1 else 0

    with open(filename, "wb") as f:
        f.write(b"II*\x00")
        first_ifd = 8
        f.write(struct.pack("<I", first_ifd))
        arrays_start = first_ifd + t * ifd_size
        data_start = arrays_start + t * extra_per_page
        # absolute offset of every segment
        seg_offsets: List[List[int]] = []
        acc = data_start
        for segs in pages:
            offs = []
            for s in segs:
                offs.append(acc)
                acc += len(s)
            seg_offsets.append(offs)

        for k in range(t):
            next_ifd = first_ifd + (k + 1) * ifd_size if k + 1 < t else 0
            f.write(struct.pack("<H", n_entries))

            def entry(tag, type_id, count, value):
                f.write(struct.pack("<HHI", tag, type_id, count))
                if type_id == 3 and count == 1:
                    f.write(struct.pack("<HH", value, 0))
                else:
                    f.write(struct.pack("<I", value))

            arr_off = arrays_start + k * extra_per_page
            sizes = [len(s) for s in pages[k]]
            off_tag = _TAG_TILE_OFFSETS if tile is not None else _TAG_STRIP_OFFSETS
            cnt_tag = (
                _TAG_TILE_BYTE_COUNTS if tile is not None else _TAG_STRIP_BYTE_COUNTS
            )
            entry(_TAG_IMAGE_WIDTH, 4, 1, w)
            entry(_TAG_IMAGE_LENGTH, 4, 1, h)
            entry(_TAG_BITS_PER_SAMPLE, 3, 1, bits)
            entry(_TAG_COMPRESSION, 3, 1, comp_id)
            if tile is None:
                rps = (
                    h
                    if rows_per_strip in (0, None) or rows_per_strip >= h
                    else rows_per_strip
                )
                entry(
                    off_tag, 4, n_segs,
                    seg_offsets[k][0] if n_segs == 1 else arr_off,
                )
                entry(_TAG_ROWS_PER_STRIP, 4, 1, rps)
                entry(
                    cnt_tag, 4, n_segs,
                    sizes[0] if n_segs == 1 else arr_off + 4 * n_segs,
                )
            if predictor == 2:
                entry(_TAG_PREDICTOR, 3, 1, 2)
            if tile is not None:
                entry(_TAG_TILE_WIDTH, 4, 1, tile[0])
                entry(_TAG_TILE_LENGTH, 4, 1, tile[1])
                entry(
                    off_tag, 4, n_segs,
                    seg_offsets[k][0] if n_segs == 1 else arr_off,
                )
                entry(
                    cnt_tag, 4, n_segs,
                    sizes[0] if n_segs == 1 else arr_off + 4 * n_segs,
                )
            entry(_TAG_SAMPLE_FORMAT, 3, 1, kind)
            f.write(struct.pack("<I", next_ifd))

        if n_segs > 1:
            for k in range(t):
                f.write(struct.pack("<" + "I" * n_segs, *seg_offsets[k]))
                f.write(
                    struct.pack("<" + "I" * n_segs, *[len(s) for s in pages[k]])
                )
        for segs in pages:
            for s in segs:
                f.write(s)
