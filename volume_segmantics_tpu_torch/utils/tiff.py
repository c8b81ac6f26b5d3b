"""Reader of multipage TIFF volumes in numpy and zlib alone (the GPU
machine has no tifffile, imageio or Pillow).

`read(path)` returns the pages as one (pages, height, width) array in
native byte order, as ``imageio.volread`` returns them. It takes both byte
orders (II and MM), classic TIFF and BigTIFF; pages stored in strips or in
tiles, one sample per pixel; 8, 16, 32 and 64-bit unsigned, signed and
floating-point samples; no compression, Deflate (8 and 32946) and LZW (5);
predictor 1 (none) and 2 (horizontal differencing, integer samples); and
ImageJ's contiguous stacks, whose single IFD names ``images=N`` in its
ImageDescription and whose N pages follow each other uncompressed (ImageJ
and Fiji write stacks above 4 GB so). The array is allocated once and each
strip or tile is decoded in a thread pool straight into its place (zlib
and numpy release the GIL).

Everything else raises NotImplementedError naming it: JPEG, PackBits and
every other compression, predictor 3, several samples per pixel, other
bit depths, fill order 2, photometric interpretations other than
BlackIsZero, pages that differ in shape or type, reduced-resolution and
mask pages, volume tiles (ImageDepth) and ImageJ hyperstacks. A file that
is not a TIFF, or whose data ends early, raises ValueError; no partial
array is ever returned.
"""

import mmap
import re
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# Baseline and extension tags read here.
NEW_SUBFILE_TYPE, SUBFILE_TYPE = 254, 255
IMAGE_WIDTH, IMAGE_LENGTH, BITS_PER_SAMPLE, COMPRESSION = 256, 257, 258, 259
PHOTOMETRIC, FILL_ORDER, IMAGE_DESCRIPTION = 262, 266, 270
STRIP_OFFSETS, SAMPLES_PER_PIXEL, ROWS_PER_STRIP = 273, 277, 278
STRIP_BYTE_COUNTS, PREDICTOR = 279, 317
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTE_COUNTS = 322, 323, 324, 325
SAMPLE_FORMAT, IMAGE_DEPTH = 339, 32997

# Field types: struct code of one value (None: not decoded, only skipped).
FIELD_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: None, 6: "b", 7: None,
               8: "h", 9: "i", 10: None, 11: "f", 12: "d", 13: "I", 16: "Q",
               17: "q", 18: "Q"}
FIELD_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}

DEFLATE, LZW = "Deflate", "LZW"
COMPRESSIONS = {1: None, 5: LZW, 8: DEFLATE, 32946: DEFLATE}
COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                     6: "old-style JPEG", 7: "JPEG", 32773: "PackBits",
                     34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard",
                     50001: "WebP", 34887: "LERC"}
SAMPLE_KINDS = {1: "u", 2: "i", 3: "f"}

# TIFF LZW: 9 to 12-bit codes, MSB first, widened one code early.
LZW_CLEAR, LZW_EOI, LZW_FIRST = 256, 257, 258


def unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"TIFF {feature} is not supported by the PyTorch port's TIFF reader "
        "(see utils/tiff.py for what it reads)."
    )


def _lzw_widths():
    """Bit width of the j-th code after a Clear and each code's bit offset
    from the Clear's end. The first code after a Clear adds no table
    entry; each later one adds one, and the width grows when the next
    entry would be 511, 1023 or 2047."""
    j = np.arange(4096)
    width = np.select([j <= 253, j <= 765, j <= 1789], [9, 10, 11], 12)
    return width, np.concatenate([[0], np.cumsum(width)[:-1]])


LZW_WIDTH, LZW_OFFSET = _lzw_widths()


def _lzw_codes(data):
    """The codes of a TIFF LZW stream up to its EOI, Clear codes left out,
    and for each code the index of the first code after its Clear."""
    padded = np.frombuffer(bytes(data) + b"\0\0\0", np.uint8).astype(np.int64)
    nbits = 8 * len(data)
    segments, starts = [], []
    bit = total = 0
    while True:
        offsets = bit + LZW_OFFSET
        fits = offsets + LZW_WIDTH <= nbits
        offsets, widths = offsets[fits], LZW_WIDTH[fits]
        byte = offsets >> 3
        word = (padded[byte] << 16) | (padded[byte + 1] << 8) | padded[byte + 2]
        codes = (word >> (24 - widths - (offsets & 7))) & ((1 << widths) - 1)
        marks = np.flatnonzero((codes == LZW_CLEAR) | (codes == LZW_EOI))
        if len(marks) == 0:
            if len(codes) == len(LZW_WIDTH):
                raise ValueError("corrupt LZW data: a code table overflows "
                                 "without a Clear code")
            raise ValueError("LZW data end before their EOI code")
        k = marks[0]
        if k:
            segments.append(codes[:k])
            starts.append(np.full(k, total, np.int64))
            total += k
        code = codes[k]
        bit = int(offsets[k] + widths[k])
        if code == LZW_EOI:
            break
    if not segments:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(segments), np.concatenate(starts)


def lzw_decode(data) -> np.ndarray:
    """Decode a TIFF LZW stream (as libtiff writes it) into uint8 bytes.

    Each code c >= 258 at position i stands for the output of the code at
    position q = start + c - 258 followed by the first byte of the code
    after it, so its output is a copy of output[pos[q]: pos[q] + len[q] + 1]
    and len[i] = len[q] + 1. Lengths and bytes are then resolved by pointer
    jumping over whole arrays instead of a loop over codes."""
    codes, start = _lzw_codes(data)
    n = len(codes)
    index = np.arange(n)
    copy = codes >= LZW_FIRST
    parent = np.where(copy, start + codes - LZW_FIRST, index)
    if np.any(parent[copy] >= index[copy]):
        raise ValueError("corrupt LZW data: a code before its table entry")
    is_root = ~copy
    depth, up = copy.astype(np.int64), parent
    while not is_root[up].all():
        depth = depth + depth[up]
        up = up[up]
    length = depth + 1
    pos = np.cumsum(length) - length
    size = int(pos[-1] + length[-1]) if n else 0
    owner = np.repeat(index, length)
    offset = np.arange(size) - pos[owner]
    ref = np.where(copy[owner], pos[parent[owner]] + offset, np.arange(size))
    for _ in range(int(length.max(initial=1)).bit_length()):
        ref = ref[ref]
    literal = np.zeros(size, np.uint8)
    literal[pos[is_root]] = codes[is_root]
    return literal[ref]


def _is_contiguous(offsets, counts) -> bool:
    return all(o + c == nxt for o, c, nxt in zip(offsets, counts, offsets[1:]))


class _Page:
    """One IFD's image: its shape, sample type and storage blocks."""

    def __init__(self, tags: dict, byteorder: str):
        def one(tag, default=None):
            value = tags.get(tag)
            return default if value is None else value[0]

        if one(NEW_SUBFILE_TYPE, 0) & 1 or one(SUBFILE_TYPE, 1) == 2:
            raise unsupported("reduced-resolution pages")
        if one(NEW_SUBFILE_TYPE, 0) & 4 or one(SUBFILE_TYPE, 1) == 3:
            raise unsupported("transparency-mask pages")
        if one(IMAGE_DEPTH, 1) != 1:
            raise unsupported("volume tiles (ImageDepth)")
        spp = one(SAMPLES_PER_PIXEL, 1)
        if spp != 1:
            raise unsupported(f"pixels of {spp} samples (SamplesPerPixel)")
        bits = set(tags.get(BITS_PER_SAMPLE, (1,)))
        if len(bits) != 1 or next(iter(bits)) not in (8, 16, 32, 64):
            raise unsupported(f"{'/'.join(map(str, sorted(bits)))}-bit samples")
        bits = bits.pop()
        fmt = one(SAMPLE_FORMAT, 1)
        if fmt not in SAMPLE_KINDS:
            raise unsupported(f"SampleFormat {fmt}")
        if SAMPLE_KINDS[fmt] == "f" and bits == 8:
            raise unsupported("8-bit floating-point samples")
        self.dtype = np.dtype(f"{byteorder}{SAMPLE_KINDS[fmt]}{bits // 8}")
        code = one(COMPRESSION, 1)
        if code not in COMPRESSIONS:
            raise unsupported(f"{COMPRESSION_NAMES.get(code, 'compression')} "
                              f"compression ({code})")
        self.compression = COMPRESSIONS[code]
        self.predictor = one(PREDICTOR, 1)
        if self.predictor == 3:
            raise unsupported("predictor 3 (floating point)")
        if self.predictor not in (1, 2):
            raise unsupported(f"predictor {self.predictor}")
        if self.predictor == 2 and self.dtype.kind == "f":
            raise unsupported("predictor 2 on floating-point samples")
        if one(FILL_ORDER, 1) != 1:
            raise unsupported("fill order 2 (bits in reversed order)")
        photometric = one(PHOTOMETRIC, 1)
        if photometric != 1:
            raise unsupported(f"photometric interpretation {photometric} "
                              "(only BlackIsZero is read)")
        self.shape = (one(IMAGE_LENGTH), one(IMAGE_WIDTH))
        if None in self.shape:
            raise ValueError("TIFF page without ImageWidth or ImageLength")
        height, width = self.shape
        self.tiled = TILE_WIDTH in tags
        if self.tiled:
            self.block = (one(TILE_LENGTH), one(TILE_WIDTH))
            offsets, counts = tags.get(TILE_OFFSETS), tags.get(TILE_BYTE_COUNTS)
            across = -(-width // self.block[1])
        else:
            self.block = (min(one(ROWS_PER_STRIP, height), height), width)
            offsets, counts = tags.get(STRIP_OFFSETS), tags.get(STRIP_BYTE_COUNTS)
            across = 1
        if offsets is None or counts is None or len(offsets) != len(counts):
            raise ValueError("TIFF page without matching data offsets and "
                             "byte counts")
        down = -(-height // self.block[0])
        if len(offsets) != down * across:
            raise ValueError(f"TIFF page of {down * across} blocks lists "
                             f"{len(offsets)}")
        # (row, column, offset, byte count) of each block, row-major.
        self.blocks = [(i // across * self.block[0], i % across * self.block[1],
                        o, c) for i, (o, c) in enumerate(zip(offsets, counts))]
        self.description = tags.get(IMAGE_DESCRIPTION, b"")

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * self.dtype.itemsize


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
        self.ifds = []
        seen = set()
        while first:
            if first in seen:
                raise ValueError("TIFF IFD chain loops")
            seen.add(first)
            tags, first = self._ifd(first)
            self.ifds.append(tags)
        if not self.ifds:
            raise ValueError("TIFF file without pages")

    def _u(self, fmt, offset):
        size = struct.calcsize(fmt)
        if offset + size > len(self.buf):
            raise ValueError("TIFF file ends inside its header or an IFD")
        return struct.unpack_from(self.order + fmt, self.buf, offset)[0]

    def _ifd(self, offset):
        """The tags of the IFD at `offset` ({tag: tuple of values, or bytes
        for ASCII}) and the next IFD's offset."""
        count = self._u(self.count_fmt, offset)
        head = struct.calcsize(self.count_fmt)
        inline = struct.calcsize(self.offset_fmt)
        tags = {}
        for i in range(count):
            at = offset + head + i * self.entry_size
            tag, ftype = self._u("H", at), self._u("H", at + 2)
            n = self._u(self.offset_fmt, at + 4)
            if ftype not in FIELD_SIZES or FIELD_TYPES[ftype] is None:
                continue  # unknown or unread types are skipped, as TIFF asks
            nbytes = n * FIELD_SIZES[ftype]
            where = at + 4 + inline
            if nbytes > inline:
                where = self._u(self.offset_fmt, where)
            if where + nbytes > len(self.buf):
                raise ValueError(f"TIFF tag {tag} points past the end of the file")
            if ftype == 2:
                tags[tag] = bytes(self.buf[where:where + nbytes]).rstrip(b"\0")
            else:
                tags[tag] = struct.unpack_from(
                    f"{self.order}{n}{FIELD_TYPES[ftype]}", self.buf, where)
        return tags, self._u(self.offset_fmt, offset + head + count * self.entry_size)


def _imagej_images(description: bytes):
    """The `images=N` of an ImageJ description (None if not ImageJ)."""
    if not description.startswith(b"ImageJ="):
        return None
    fields = dict(re.findall(rb"^(\w+)=(.*)$", description, re.M))
    for name in (b"channels", b"frames"):
        if int(fields.get(name, 1)) > 1:
            raise unsupported("ImageJ hyperstacks (channels or frames > 1)")
    return int(fields.get(b"images", 1))


def _decode_block(buf, page: _Page, offset: int, count: int, rows: int,
                  cols: int) -> np.ndarray:
    """One strip or tile as a (rows, cols) array of the page's type."""
    need = rows * cols * page.dtype.itemsize
    if offset + count > len(buf):
        raise ValueError("TIFF data end before the end of the file's blocks")
    if page.compression is None:
        if count < need:
            raise ValueError(f"TIFF block holds {count} bytes of {need}")
        raw = np.frombuffer(buf, np.uint8, need, offset)
    elif page.compression == DEFLATE:
        try:
            raw = np.frombuffer(zlib.decompress(buf[offset:offset + count]),
                                np.uint8)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate block does not inflate: {e}") from None
    else:
        raw = lzw_decode(buf[offset:offset + count])
    if raw.size < need:
        raise ValueError(f"TIFF {page.compression} block decodes to "
                         f"{raw.size} bytes of {need}")
    block = raw[:need].view(page.dtype).reshape(rows, cols)
    if page.predictor == 2:
        native = page.dtype.newbyteorder("=")
        block = np.cumsum(block.astype(native), axis=1, dtype=native)
    return block


def read(path) -> np.ndarray:
    """The pages of the TIFF file at `path` as one (pages, height, width)
    array in native byte order."""
    with open(Path(path), "rb") as f:
        try:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            raise ValueError(f"{path} is empty, not a TIFF file") from None
        try:
            return _read(buf)
        finally:
            buf.close()


def _read(buf) -> np.ndarray:
    reader = _Reader(buf)
    pages = [_Page(tags, reader.order) for tags in reader.ifds]
    first = pages[0]
    for page in pages[1:]:
        if (page.shape, page.dtype) != (first.shape, first.dtype):
            raise unsupported("pages that differ in shape or type "
                              f"({first.shape} {first.dtype} and "
                              f"{page.shape} {page.dtype})")
    images = _imagej_images(first.description)
    out_dtype = first.dtype.newbyteorder("=")
    if images is not None and images > len(pages):
        if len(pages) != 1:
            raise unsupported(f"ImageJ stacks of {images} images in "
                              f"{len(pages)} IFDs")
        offsets = [b[2] for b in first.blocks]
        counts = [b[3] for b in first.blocks]
        if first.compression is not None or first.predictor != 1 \
                or not _is_contiguous(offsets, counts):
            raise unsupported("ImageJ stacks that are compressed or not "
                              "contiguous")
        start, total = offsets[0], images * first.nbytes
        if start + total > len(buf):
            raise ValueError(f"ImageJ stack of {images} images ends early")
        data = np.frombuffer(buf, first.dtype, images * first.shape[0]
                             * first.shape[1], start)
        return data.reshape(images, *first.shape).astype(out_dtype)

    out = np.empty((len(pages), *first.shape), out_dtype)
    height, width = first.shape

    def place(z, page, row, col, offset, count):
        # Tiles are stored whole; the last strip holds only the rows left.
        rows = page.block[0] if page.tiled else min(page.block[0], height - row)
        cols = page.block[1]
        block = _decode_block(buf, page, offset, count, rows, cols)
        r1, c1 = min(row + rows, height), min(col + cols, width)
        out[z, row:r1, col:c1] = block[:r1 - row, :c1 - col]

    with ThreadPoolExecutor() as pool:
        futures = [pool.submit(place, z, page, *block)
                   for z, page in enumerate(pages) for block in page.blocks]
        for future in futures:
            future.result()
    return out
