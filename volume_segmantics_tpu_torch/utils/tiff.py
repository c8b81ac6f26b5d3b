"""Reader of multipage TIFF volumes in numpy and the standard library alone
(the GPU machine has no tifffile, imageio or Pillow).

`read(path)` returns what ``imageio.volread(path)`` returns (through the
tifffile copy that imageio bundles), whenever that is a 3-D array: the
file's first series, in native byte order. The series follow tifffile's
rules, picked by the first page:

- OME-XML descriptions: the first image's planes, its axes of length 1
  squeezed out;
- ImageJ descriptions (``ImageJ=``): ``frames``, ``slices`` and
  ``channels`` before the page's own axes, the images left over as one
  more axis; a single IFD followed by all the images' bytes (how ImageJ
  writes stacks above 4 GB) is read as one contiguous block;
- shaped descriptions (tifffile's ``{"shape": [...]}`` or ``shape=``):
  each such page starts a series of as many pages as its shape holds;
- otherwise (generic): pages grouped by shape, axes and whether their
  compression decodes, in order of each group's first page, so a stack
  interleaved with thumbnails, or followed by a second stack of another
  shape, reads as its first stack.

A page holds one or more samples per pixel (PlanarConfiguration 1 gives
(H, W, S), 2 gives (S, H, W)) of 1, 2 or 4 bits (bool for 1 bit, else
uint8, rows padded to a byte), or 8, 16, 32, 64-bit unsigned, signed,
floating-point or complex samples, in strips or tiles; any photometric
interpretation, as its raw samples; fill order 1 or 2; no compression,
Deflate (8, 32946), LZW (5), PackBits (32773) or LZMA (34925); predictor
1, 2 (horizontal differencing, also on floating-point samples, as
tifffile applies it) or 3 (floating point). II and MM byte orders,
classic TIFF and BigTIFF. The array is allocated once and each strip or
tile is decoded in a thread pool straight into its place (zlib, lzma and
numpy release the GIL).

Everything else raises NotImplementedError naming it: a first series that
is not 3-D (a single 2-D page, RGB stacks, ImageJ hyperstacks of 4 or
more axes), LSM, FluoView, NIH Image, MD Gel and MetaMorph STK files,
multi-file OME-TIFF, JPEG, CCITT and every other compression, sample
sizes tifffile cannot unpack (12-bit and the like), chroma subsampling,
predictor 3 on integers or in tiles, and volume tiles (ImageDepth). A file
that is not a TIFF, or whose data end early, raises ValueError; no partial
array is ever returned.
"""

import json
import lzma
import math
import mmap
import struct
import xml.etree.ElementTree as ElementTree
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .tiff_codecs import (REVERSED_BITS, lzw_decode, packbits_decode,
                          undo_float_predictor, unpack_bits)

__all__ = ["read", "lzw_decode", "unsupported"]

# Baseline and extension tags read here.
IMAGE_WIDTH, IMAGE_LENGTH, BITS_PER_SAMPLE, COMPRESSION = 256, 257, 258, 259
PHOTOMETRIC, FILL_ORDER, IMAGE_DESCRIPTION = 262, 266, 270
STRIP_OFFSETS, SAMPLES_PER_PIXEL, ROWS_PER_STRIP = 273, 277, 278
STRIP_BYTE_COUNTS, PLANAR_CONFIG, PREDICTOR = 279, 284, 317
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTE_COUNTS = 322, 323, 324, 325
SAMPLE_FORMAT, YCBCR_SUBSAMPLING, IMAGE_DEPTH = 339, 530, 32997
# Tags that mark the file formats whose series tifffile reads by rules of
# their own, and the second ImageDescription of a page (kept apart).
MD_FILE_TAG, STK_UIC2, FLUOVIEW_STAMP, LSM_INFO, NIH_HEADER = (
    33445, 33629, 34362, 34412, 43314)
IMAGE_DESCRIPTION_1 = -IMAGE_DESCRIPTION
BLOCK_TAGS = (STRIP_OFFSETS, STRIP_BYTE_COUNTS, TILE_OFFSETS, TILE_BYTE_COUNTS)

# Field types: struct code of one value (None: not decoded, only noted).
FIELD_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: None, 6: "b", 7: None,
               8: "h", 9: "i", 10: None, 11: "f", 12: "d", 13: "I", 16: "Q",
               17: "q", 18: "Q"}
FIELD_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}

DEFLATE, LZW, PACKBITS, LZMA = "Deflate", "LZW", "PackBits", "LZMA"
COMPRESSIONS = {1: None, 5: LZW, 8: DEFLATE, 32946: DEFLATE, 32773: PACKBITS,
                34925: LZMA}
COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                     6: "old-style JPEG", 7: "JPEG", 34712: "JPEG 2000",
                     34926: "Zstandard", 50000: "Zstandard", 50001: "WebP",
                     34887: "LERC"}
# (SampleFormat, BitsPerSample) -> numpy type, as tifffile maps them.
SAMPLE_DTYPES = {
    (1, 1): "?", **{(1, b): "u1" for b in range(2, 9)},
    **{(1, b): "u2" for b in range(9, 17)}, **{(1, b): "u4" for b in range(17, 33)},
    (1, 64): "u8", (2, 8): "i1", (2, 16): "i2", (2, 32): "i4", (2, 64): "i8",
    (3, 16): "f2", (3, 32): "f4", (3, 64): "f8", (6, 64): "c8", (6, 128): "c16",
}
# Sample sizes tifffile unpacks; the others of SAMPLE_DTYPES it refuses.
UNPACKED_BITS = (1, 2, 4, 8, 16, 32, 64, 128)


def unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"TIFF {feature} is not supported by the PyTorch port's TIFF reader "
        "(see utils/tiff.py for what it reads)."
    )


def _text(raw) -> bytes:
    """An ASCII tag's text as tifffile keeps it: up to its last printable
    byte, surrounding white space removed."""
    end = len(raw)
    while end and not 8 < raw[end - 1] < 127:
        end -= 1
    return bytes(raw[:end]).strip()


def _same(values):
    """One value for per-sample tags that agree, else the tuple."""
    return values[0] if all(v == values[0] for v in values) else tuple(values)


class _Page:
    """One IFD: its image's shape and axes as tifffile names them, its
    sample type, codecs and storage blocks. Nothing here raises for a
    feature the reader lacks: `check` does, for the pages it will read."""

    def __init__(self, tags: dict, order: str, offset: int):
        self.tags, self.order, self.offset = tags, order, offset

        def one(tag, default=None):
            value = tags.get(tag)
            return value[0] if value else default

        self.width, self.height = one(IMAGE_WIDTH, 0), one(IMAGE_LENGTH, 0)
        self.depth = one(IMAGE_DEPTH, 1)
        self.spp = one(SAMPLES_PER_PIXEL, 1)
        self.planar = one(PLANAR_CONFIG, 1)
        self.photometric = one(PHOTOMETRIC, 0)
        self.bits = _same(tags.get(BITS_PER_SAMPLE, (1,))[:self.spp])
        self.fmt = _same(tags.get(SAMPLE_FORMAT, (1,))[:self.spp])
        kind = SAMPLE_DTYPES.get((self.fmt, self.bits))
        self.dtype = None if kind is None else np.dtype(kind)
        self.code = one(COMPRESSION, 1)
        self.compression = COMPRESSIONS.get(self.code)
        self.decodable = self.code in COMPRESSIONS
        self.predictor = one(PREDICTOR, 1)
        self.fill_order = one(FILL_ORDER, 1)
        self.subsampled = tags.get(YCBCR_SUBSAMPLING, (1, 1))[:2] != (1, 1)
        self.description = _text(tags.get(IMAGE_DESCRIPTION, b""))
        self.description1 = _text(tags.get(IMAGE_DESCRIPTION_1, b""))

        # tifffile's page shape: the samples make an axis of their own for
        # RGB or more than one sample, after the pixels (planar 1) or
        # before the rows (planar 2).
        height, width = self.height, self.width
        coloured = self.photometric == 2 or self.spp > 1
        self.planes = self.spp if coloured and self.planar == 2 else 1
        self.samples = self.spp if coloured and self.planar != 2 else 1
        z = (self.depth,) if self.depth != 1 else ()
        if not tags:
            self.shape, self.axes = (), ""
        elif coloured and self.planar != 2:
            self.shape = z + (height, width, self.spp)
            self.axes = "Z" * len(z) + "YXS"
        elif coloured:
            self.shape = (self.spp,) + z + (height, width)
            self.axes = "S" + "Z" * len(z) + "YX"
        else:
            self.shape, self.axes = z + (height, width), "Z" * len(z) + "YX"

        self.tiled = TILE_WIDTH in tags
        if self.tiled:
            self.block = (one(TILE_LENGTH, 0), one(TILE_WIDTH, 0))
            self.offsets = tags.get(TILE_OFFSETS, ())
            self.counts = tags.get(TILE_BYTE_COUNTS, ())
        else:
            rows = tags.get(ROWS_PER_STRIP, ())
            rows = rows[0] if len(rows) == 1 else height
            self.block = (max(1, min(rows, height)), width)
            self.offsets = tags.get(STRIP_OFFSETS, ())
            self.counts = tags.get(STRIP_BYTE_COUNTS, ())
        self.contiguous = self._contiguous()
        self.final = (self.contiguous is not None and self.fill_order == 1
                      and self.predictor == 1 and not self.subsampled)

    def _contiguous(self):
        """(offset, byte count) of the image's bytes where they lie in one
        uncompressed run of whole samples, as tifffile finds it; else None."""
        if self.code != 1 or self.bits not in (8, 16, 32, 64):
            return None
        if self.tiled and (self.width != self.block[1]
                           or self.height % max(self.block[0], 1)
                           or self.block[1] % 16 or self.block[0] % 16):
            return None
        offsets, counts = self.offsets, self.counts
        if not offsets or len(offsets) != len(counts):
            return None
        if all(o + c == nxt or c_next == 0 for o, c, nxt, c_next
               in zip(offsets, counts, offsets[1:], counts[1:])):
            return offsets[0], sum(counts)
        return None

    def frame(self, tags: dict, offset: int) -> "_Page":
        """Another IFD read as tifffile reads the pages of an ImageJ,
        shaped or OME series: this page's properties, its own blocks."""
        own = {t: tags[t] for t in BLOCK_TAGS if t in tags}
        return _Page({**self.tags, **own}, self.order, offset)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def file_dtype(self) -> np.dtype:
        return self.dtype.newbyteorder(self.order)

    def check(self) -> None:
        """Raise NotImplementedError for what the reader cannot decode,
        ValueError for what no reader could."""
        if STK_UIC2 in self.tags:
            raise unsupported("MetaMorph STK files")
        if self.depth != 1:
            raise unsupported("volume tiles (ImageDepth)")
        if not self.height or not self.width:
            raise ValueError("TIFF page without ImageWidth or ImageLength")
        if self.dtype is None or self.bits not in UNPACKED_BITS:
            if isinstance(self.bits, tuple):
                raise unsupported(f"samples of differing bit depths {self.bits}")
            if isinstance(self.fmt, tuple):
                raise unsupported(f"samples of differing formats {self.fmt}")
            if self.fmt not in (1, 2, 3):
                raise unsupported(f"SampleFormat {self.fmt} with "
                                  f"{self.bits}-bit samples")
            kind = {1: "", 2: " signed", 3: " floating-point"}[self.fmt]
            raise unsupported(f"{self.bits}-bit{kind} samples")
        if not self.decodable:
            raise unsupported(f"{COMPRESSION_NAMES.get(self.code, 'compression')} "
                              f"compression ({self.code})")
        if self.subsampled:
            raise unsupported("chroma-subsampled (YCbCr) pages")
        if self.predictor not in (1, 2, 3):
            raise unsupported(f"predictor {self.predictor}")
        if self.predictor != 1 and self.bits < 8:
            raise unsupported(f"predictor {self.predictor} on "
                              f"{self.bits}-bit samples")
        if self.predictor == 3 and self.dtype.kind != "f":
            raise unsupported("predictor 3 on samples that are not "
                              "floating point")
        if self.predictor == 3 and self.tiled and self.contiguous is None:
            raise unsupported("predictor 3 in tiles")
        if self.fill_order not in (1, 2):
            raise ValueError(f"TIFF fill order {self.fill_order} does not exist")
        tile_rows, tile_cols = self.block
        if not tile_rows or not tile_cols:
            raise ValueError("TIFF page with tiles of no rows or columns")
        across = -(-self.width // tile_cols)
        down = -(-self.height // tile_rows)
        if not self.offsets or len(self.offsets) != len(self.counts):
            raise ValueError("TIFF page without matching data offsets and "
                             "byte counts")
        if len(self.offsets) != self.planes * down * across:
            raise ValueError(f"TIFF page of {self.planes * down * across} "
                             f"blocks lists {len(self.offsets)}")

    def blocks(self):
        """(plane, row, column, offset, byte count) of each block."""
        tile_rows, tile_cols = self.block
        across = -(-self.width // tile_cols)
        per_plane = across * -(-self.height // tile_rows)
        for i, (o, c) in enumerate(zip(self.offsets, self.counts)):
            k = i % per_plane
            yield i // per_plane, k // across * tile_rows, k % across * tile_cols, o, c

    def decode(self, buf, plane, row, col, offset, count, dst) -> None:
        """Decode one block into dst (planes, height, width * samples)."""
        if offset + count > len(buf):
            raise ValueError("TIFF data end before the end of the file's blocks")
        # Tiles are stored whole; the last strip holds only the rows left.
        rows = self.block[0] if self.tiled else min(self.block[0],
                                                    self.height - row)
        cols, s = self.block[1], self.samples
        if self.bits < 8:
            need = rows * ((cols * s * self.bits + 7) // 8)
        else:
            need = rows * cols * s * self.dtype.itemsize
        if self.compression is None and count < need:
            raise ValueError(f"TIFF block holds {count} bytes of {need}")
        data = buf[offset:offset + count] if self.compression or \
            self.fill_order == 2 else buf
        if self.fill_order == 2:
            data = data.translate(REVERSED_BITS)
        if self.compression is None:
            raw = np.frombuffer(data, np.uint8, need,
                                offset if self.fill_order == 1 else 0)
        elif self.compression == DEFLATE:
            try:
                raw = np.frombuffer(zlib.decompress(data), np.uint8)
            except zlib.error as e:
                raise ValueError(f"TIFF Deflate block does not inflate: {e}") \
                    from None
        elif self.compression == LZMA:
            try:
                raw = np.frombuffer(lzma.decompress(data), np.uint8)
            except lzma.LZMAError as e:
                raise ValueError(f"TIFF LZMA block does not decompress: {e}") \
                    from None
        elif self.compression == PACKBITS:
            raw = packbits_decode(data)
        else:
            raw = lzw_decode(data)
        if raw.size < need:
            raise ValueError(f"TIFF {self.compression} block decodes to "
                             f"{raw.size} bytes of {need}")
        if self.bits < 8:
            block = unpack_bits(raw, rows, cols * s, self.bits)
        elif self.predictor == 3:
            raw = raw[:need]
            if self.contiguous is not None and self.order == ">":
                # tifffile reads a contiguous big-endian page as numbers,
                # swaps them to native order, then undoes the predictor on
                # the swapped bytes.
                raw = raw.reshape(-1, self.dtype.itemsize)[:, ::-1].ravel()
            block = undo_float_predictor(raw, rows, cols, s, self.dtype)
        else:
            block = raw[:need].view(self.file_dtype()).reshape(rows, cols * s)
            if self.predictor == 2:
                native = self.dtype.newbyteorder("=")
                block = np.cumsum(block.reshape(rows, cols, s).astype(native),
                                  axis=1, dtype=native).reshape(rows, cols * s)
        r1, c1 = min(row + rows, self.height), min(col + cols, self.width)
        dst[plane, row:r1, col * s:c1 * s] = block[:r1 - row, :(c1 - col) * s]


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        order = bytes(buf[:2])
        if order not in (b"II", b"MM"):
            raise ValueError("not a TIFF file (no II or MM byte order mark)")
        self.order = "<" if order == b"II" else ">"
        version = self._u("H", 2)
        # Offsets and value counts are 4 bytes in classic TIFF, 8 in
        # BigTIFF; an entry's value sits in its last 4 or 8 bytes when it
        # fits there.
        if version == 42:
            self.offset_fmt, self.count_fmt, self.entry_size = "I", "H", 12
            first = self._u("I", 4)
        elif version == 43:
            if self._u("H", 4) != 8:
                raise ValueError("BigTIFF with an offset size other than 8")
            self.offset_fmt, self.count_fmt, self.entry_size = "Q", "Q", 20
            first = self._u("Q", 8)
        else:
            raise ValueError(f"not a TIFF file (version {version})")
        self.pages = []
        seen = set()
        while first:
            if first in seen:
                raise ValueError("TIFF IFD chain loops")
            seen.add(first)
            tags, following = self._ifd(first)
            self.pages.append(_Page(tags, self.order, first))
            first = following
        if not self.pages:
            raise ValueError("TIFF file without pages")

    def _u(self, fmt, offset):
        size = struct.calcsize(fmt)
        if offset + size > len(self.buf):
            raise ValueError("TIFF file ends inside its header or an IFD")
        return struct.unpack_from(self.order + fmt, self.buf, offset)[0]

    def _ifd(self, offset):
        """The tags of the IFD at `offset` ({tag: tuple of values, or bytes
        for ASCII}; the first of repeated tags, a second description
        apart) and the next IFD's offset."""
        count = self._u(self.count_fmt, offset)
        head = struct.calcsize(self.count_fmt)
        inline = struct.calcsize(self.offset_fmt)
        tags = {}
        for i in range(count):
            at = offset + head + i * self.entry_size
            tag, ftype = self._u("H", at), self._u("H", at + 2)
            n = self._u(self.offset_fmt, at + 4)
            if tag == IMAGE_DESCRIPTION and tag in tags:
                tag = IMAGE_DESCRIPTION_1
            if tag in tags or ftype not in FIELD_SIZES:
                continue  # unknown types are skipped, as TIFF asks
            if FIELD_TYPES[ftype] is None:
                tags[tag] = ()  # noted (it marks some formats), not decoded
                continue
            nbytes = n * FIELD_SIZES[ftype]
            where = at + 4 + inline
            if nbytes > inline:
                where = self._u(self.offset_fmt, where)
            if where + nbytes > len(self.buf):
                raise ValueError(f"TIFF tag {tag} points past the end of the file")
            if ftype == 2:
                tags[tag] = bytes(self.buf[where:where + nbytes])
            else:
                tags[tag] = struct.unpack_from(
                    f"{self.order}{n}{FIELD_TYPES[ftype]}", self.buf, where)
        return tags, self._u(self.offset_fmt, offset + head + count * self.entry_size)


class _Series:
    """The pages of a series (each read with its own or its keyframe's
    properties) and its shape; or, where tifffile reads the series as one
    run of bytes, that run's offset."""

    def __init__(self, pages, shape, run=None):
        self.pages, self.shape, self.run = pages, tuple(shape), run


def _flags(page: _Page):
    for description in (page.description, page.description1):
        if not description:
            return
        yield description


def _imagej_description(page: _Page):
    return next((d for d in _flags(page) if d.startswith(b"ImageJ=")), None)


def _shaped_description(page: _Page):
    return next((d for d in _flags(page) if (d[:1] == b"{" and b'"shape":' in d)
                 or d[:6] == b"shape="), None)


def _generic_series(pages):
    groups = {}
    for page in pages:
        if page.shape:
            key = (page.shape, page.axes, page.decodable)
            groups.setdefault(key, []).append(page)
    if not groups:
        raise ValueError("TIFF file without images")
    first = next(iter(groups.values()))
    shape = first[0].shape if len(first) == 1 else (len(first),) + first[0].shape
    return _Series(first, shape)


def _imagej_series(pages, description: bytes, file_size: int):
    fields = {}
    for line in description.decode("latin-1").splitlines():
        parts = line.split("=")
        if len(parts) != 2:
            continue
        key, value = parts[0].strip(), parts[1].strip()
        for kind in (int, float):
            try:
                value = kind(value)
                break
            except ValueError:
                pass
        else:
            value = {"true": True, "false": False}.get(value.lower(), value)
        fields[key] = value
    page = pages[0]
    images = fields.get("images", 0)
    stack = False  # one IFD followed by every image's bytes
    if page.final and isinstance(images, int) and images > 1:
        offset, count = page.contiguous
        if count != page.size * page.bits // 8 or offset + count * images > file_size:
            return None  # tifffile: invalid ImageJ metadata, read as generic
        stack = len(pages) == 1 or offset + count * images <= pages[1].offset
    members = [page] if stack else [page] + [page.frame(p.tags, p.offset)
                                             for p in pages[1:]]
    shape = []
    for name in ("frames", "slices"):
        if name in fields:
            shape.append(fields[name])
    if "channels" in fields and not (page.photometric == 2
                                     and not fields.get("hyperstack", False)):
        shape.append(fields["channels"])
    if not all(isinstance(n, int) and n > 0 for n in shape):
        raise unsupported(f"ImageJ descriptions with axis lengths {shape}")
    remain = fields.get("images", len(members))
    if not isinstance(remain, int):
        raise unsupported(f"ImageJ descriptions with images={remain}")
    remain //= math.prod(shape)
    if remain > 1:
        shape.append(remain)
    shape.extend(page.shape)
    return _Series(members, shape, page.contiguous[0] if stack else None)


def _shaped_series(pages):
    """tifffile's shaped series; None where it falls back to generic."""
    key = pages[0]
    key.check()
    metadata = _shaped_metadata(key)
    if metadata is None:
        return None
    reshape = tuple(metadata["shape"])
    size = math.prod(reshape)
    npages, mod = divmod(size, key.size)
    if mod:
        return None
    members = [key]
    if 1 < npages <= len(pages):
        if metadata.get("truncated"):
            npages = 1  # the keyframe's data hold the whole series
        elif not (key.final and key.offset + size * key.dtype.itemsize
                  < pages[1].offset):
            # Unless all the data lie between the keyframe and the next
            # IFD, the series' pages are read one by one.
            members += [key.frame(p.tags, p.offset) for p in pages[1:npages]]
    if "axes" in metadata and len(metadata["axes"]) == len(reshape):
        shape = reshape
    else:
        shape = key.shape if len(members) == 1 else (len(members),) + key.shape
        if key.contiguous and size > math.prod(shape) \
                and size % math.prod(shape) == 0:
            shape = (size // math.prod(shape),) + shape
        if math.prod(shape) == size:
            shape = reshape
    run = key.contiguous[0] if len(members) == 1 and key.final else None
    # Later keyframes start later series: only their descriptions matter,
    # since tifffile falls back to the generic series if one lacks its.
    index = npages
    while index < len(pages):
        later = _shaped_metadata(pages[index])
        if later is None:
            return None
        more, mod = divmod(math.prod(later["shape"]), pages[index].size or 1)
        if mod:
            return None
        if not more:
            raise unsupported("shaped descriptions of no pages")
        if 1 < more <= len(pages) - index and later.get("truncated"):
            more = 1
        index += more
    return _Series(members, shape, run)


def _shaped_metadata(page: _Page):
    """A shaped description's fields, None where tifffile would fall back
    to the generic series."""
    description = _shaped_description(page)
    if description is None:
        return None
    if description[:6] == b"shape=":
        return {"shape": [int(i) for i in description[7:-1].split(b",")]}
    if description[-1:] != b"}":
        return None
    return json.loads(description)


def _ome_series(pages, description: bytes):
    """The first image of an OME-XML description with planes in this
    file; None where tifffile falls back to the generic series."""
    try:
        root = ElementTree.fromstring(description)
    except ElementTree.ParseError:
        return None
    uuid = root.attrib.get("UUID")
    for element in root:
        if element.tag.endswith("BinaryOnly"):
            break
        if element.tag.endswith("StructuredAnnotations") and any(
                a.attrib.get("Namespace", "").endswith("modulo") for a in element):
            raise unsupported("OME-XML modulo annotations")
        if not element.tag.endswith("Image"):
            continue
        for pixels in element:
            if not pixels.tag.endswith("Pixels"):
                continue
            axes = pixels.attrib["DimensionOrder"][::-1]
            shape = [int(pixels.attrib["Size" + ax]) for ax in axes]
            planes = [None] * math.prod(shape[:-2])
            for data in pixels:
                if data.tag.endswith("Channel") and int(
                        data.attrib.get("SamplesPerPixel", 1)) != 1:
                    raise unsupported("OME-TIFF channels of several samples")
                if not data.tag.endswith("TiffData"):
                    continue
                attr = data.attrib
                ifd = int(attr.get("IFD", 0))
                num = int(attr.get("PlaneCount", attr.get(
                    "NumPlanes", 1 if "IFD" in attr else 0)))
                try:
                    at = int(np.ravel_multi_index(
                        [int(attr.get("First" + ax, 0)) for ax in axes[:-2]],
                        shape[:-2]))
                except ValueError:
                    continue
                if any(u.tag.endswith("UUID") and u.text != uuid for u in data):
                    raise unsupported("multi-file OME-TIFF")
                for i in range(num or len(pages)):
                    if at + i >= len(planes) or ifd + i >= len(pages):
                        break
                    planes[at + i] = ifd + i
            if all(p is None for p in planes):
                continue
            if any(p is None for p in planes):
                raise unsupported("OME-TIFF images with planes missing")
            # tifffile's keyframe: the first page, or the first plane's.
            key = pages[0] if 0 in planes else pages[planes[0]]
            key.check()
            members = [page if page is key else key.frame(page.tags, page.offset)
                       for page in (pages[p] for p in planes)]
            kept = [n for n, ax in zip(shape, axes) if n > 1 or ax in "XY"]
            return _Series(members, kept)
    return None


def _first_series(pages, file_size: int) -> _Series:
    first = pages[0]
    series = None
    if first.description[:14] == b"<?xml version=" \
            and first.description[-6:] == b"</OME>":
        series = _ome_series(pages, first.description)
    elif _imagej_description(first) is not None:
        series = _imagej_series(pages, _imagej_description(first), file_size)
    elif LSM_INFO in first.tags:
        raise unsupported("Zeiss LSM files")
    elif FLUOVIEW_STAMP in first.tags:
        raise unsupported("Olympus FluoView files")
    elif NIH_HEADER in first.tags:
        raise unsupported("NIH Image files")
    elif MD_FILE_TAG in first.tags or (len(pages) > 1 and MD_FILE_TAG in pages[1].tags):
        raise unsupported("Molecular Dynamics GEL files")
    elif _shaped_description(first) is not None:
        series = _shaped_series(pages)
    return series or _generic_series(pages)


def _result_shape(series: _Series):
    """The shape tifffile gives the series' data: its own where the pages
    hold as many samples, else as many of it as they hold, else the
    pages stacked."""
    if series.run is not None:
        return series.shape
    page_shape = series.pages[0].shape
    total = len(series.pages) * math.prod(page_shape)
    size = math.prod(series.shape)
    if total == size:
        return series.shape
    if size and total % size == 0:
        return (total // size,) + series.shape
    return (len(series.pages),) + page_shape if len(series.pages) > 1 else page_shape


def read(path) -> np.ndarray:
    """The first series of the TIFF file at `path`, as the 3-D array
    ``imageio.volread`` returns, in native byte order."""
    with open(Path(path), "rb") as f:
        try:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            raise ValueError(f"{path} is empty, not a TIFF file") from None
        try:
            return _read(buf)
        finally:
            try:
                buf.close()
            except BufferError:
                pass  # a view held by a raised error's frames; freed with it


def _describe(series: _Series, shape) -> str:
    page = series.pages[0]
    if page.spp > 1 or page.photometric == 2:
        return (f"pixels of {page.spp} samples (SamplesPerPixel) in "
                f"{len(shape)}-D series {shape}")
    if len(shape) == 2:
        return f"single 2-D pages {shape} (no stack)"
    return f"series of {len(shape)} axes {shape}"


def _read(buf) -> np.ndarray:
    series = _first_series(_Reader(buf).pages, len(buf))
    for page in series.pages:
        page.check()
    shape = _result_shape(series)
    if len(shape) != 3:
        raise unsupported(_describe(series, shape))
    key = series.pages[0]
    out_dtype = key.dtype.newbyteorder("=")
    if series.run is not None:
        count = math.prod(shape)
        if series.run + count * key.dtype.itemsize > len(buf):
            raise ValueError(f"TIFF stack of {count} samples ends early")
        data = np.frombuffer(buf, key.file_dtype(), count, series.run)
        return data.reshape(shape).astype(out_dtype)

    out = np.empty((len(series.pages), key.planes, key.height,
                    key.width * key.samples), out_dtype)
    with ThreadPoolExecutor() as pool:
        futures = [pool.submit(page.decode, buf, *block, out[z])
                   for z, page in enumerate(series.pages)
                   for block in page.blocks()]
        for future in futures:
            future.result()
    return out.reshape(shape)
