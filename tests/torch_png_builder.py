"""PNG files built chunk by chunk for the PNG reader's tests: any colour
type and bit depth PNG allows (sub-byte samples packed most significant
first, each row padded to a byte), any mix of the five row filters, and
Adam7 interlacing (each pass filtered on its own)."""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """`rows` (H, bytes) with the PNG filter filters[y % len] on row y,
    each byte predicted from the unfiltered neighbours."""
    rows = rows.astype(np.int64)
    out = []
    for y, row in enumerate(rows):
        kind = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        b = rows[y - 1] if y else np.zeros_like(row)
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
        pred = [0, a, b, (a + b) // 2, paeth(a, b, c)][kind]
        out.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def packed_rows(pixels: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, channels) samples as the bytes of each row at `depth` bits:
    16-bit big-endian, sub-byte packed most significant first."""
    h = pixels.shape[0]
    if depth == 16:
        return pixels.astype(">u2").view(np.uint8).reshape(h, -1)
    values = pixels.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return values
    per_byte = 8 // depth
    width = -(-values.shape[1] // per_byte) * per_byte
    wide = np.zeros((h, width), np.uint8)
    wide[:, :values.shape[1]] = values
    shifts = np.arange(8 - depth, -1, -depth)
    return (wide.reshape(h, -1, per_byte) << shifts).sum(axis=2).astype(np.uint8)


def png_bytes(pixels, colour, depth=8, filters=(0,), palette=None,
              interlace=0, extra=()) -> bytes:
    """A PNG of `pixels` ((H, W, channels) integer samples below 2**depth),
    built chunk by chunk."""
    h, w, channels = pixels.shape
    bpp = max(1, channels * depth // 8)
    body = []
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        part = pixels[y0::dy, x0::dx]
        if part.size:
            body.append(filtered_rows(packed_rows(part, depth), bpp, filters))
    parts = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    parts += [chunk(kind, payload) for kind, payload in extra]
    parts.append(chunk(b"IDAT", zlib.compress(b"".join(body))))
    parts.append(chunk(b"IEND", b""))
    return b"".join(parts)
