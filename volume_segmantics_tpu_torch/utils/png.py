"""PNG reader and writer in numpy and zlib alone (the GPU machine has no
Pillow, imageio or OpenCV).

`read_grey(path)` returns what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
returns (OpenCV decodes through libpng), as a 2-D uint8 array, in the
order of libpng's transformations: grey of 1, 2 or 4 bits widened to 8
(``expand_gray_1_2_4_to_8``: each value times 255, 85 or 17); 8-bit grey
as it is stored; 16-bit grey as its high byte (``strip_16``); grey+alpha
(8 or 16-bit) as its grey channel; palette images (1, 2, 4 or 8-bit)
through their palette, then as 8-bit RGB; RGB and RGBA through libpng's
fixed-point BT.601 grey (``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``):
(9797 R + 19234 G + 3737 B) >> 15 at 8 bits, and at 16 bits the same sum
plus 16384, shifted by 15, before ``strip_16`` keeps its high byte; alpha
dropped. It undoes all five row filters, de-interlaces Adam7 (each of the
seven passes filtered on its own) and checks the critical chunks' CRCs.
Any other critical chunk raises NotImplementedError naming it; a file
that is not a PNG, or whose data end early, raises ValueError.

`write(path, image, text=None)` writes a 2-D uint8 array as 8-bit grey or
an (H, W, 3) uint8 array as 8-bit RGB, every row filtered with Up (the
difference from the row above) and deflated at zlib's default level, with
optional ``tEXt`` chunks.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
GREY, RGB, PALETTE, GREY_ALPHA, RGBA = 0, 2, 3, 4, 6
CHANNELS = {GREY: 1, RGB: 3, PALETTE: 1, GREY_ALPHA: 2, RGBA: 4}
CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)
# libpng's png_set_rgb_to_gray_fixed(png, 1, 29900, 58700) coefficients:
# 0.299 and 0.587 of 32768, truncated, and blue the rest.
RGB_TO_GREY = (9797, 19234, 32768 - 9797 - 19234)
# Adam7's passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
DEPTHS = {GREY: (1, 2, 4, 8, 16), RGB: (8, 16), PALETTE: (1, 2, 4, 8),
          GREY_ALPHA: (8, 16), RGBA: (8, 16)}


def unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"PNG {feature} is not supported by the PyTorch port's PNG reader "
        "(see utils/png.py for what it reads)."
    )


def _chunks(data: bytes):
    """(type, payload) of each chunk up to IEND, critical CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    at = 8
    while True:
        if at + 8 > len(data):
            raise ValueError("PNG file ends before its IEND chunk")
        length, kind = struct.unpack_from(">I4s", data, at)
        end = at + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG file ends inside its {kind!r} chunk")
        payload = data[at + 8:end]
        if kind in CRITICAL and zlib.crc32(kind + payload) != \
                struct.unpack_from(">I", data, end)[0]:
            raise ValueError(f"PNG {kind.decode()} chunk fails its CRC")
        if kind[0:1].isupper() and kind not in CRITICAL:
            raise unsupported(f"critical chunk {kind.decode('latin-1')}")
        yield kind, payload
        if kind == b"IEND":
            return
        at = end + 4


def _paeth_row(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 255


def _average_row(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prev[i]) >> 1)) & 255


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of `raw` (height x (1 + stride) bytes)."""
    rows = raw.reshape(height, 1 + stride)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > FILTER_PAETH:
        raise ValueError(f"PNG row filter {int(kinds.max())} does not exist")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, row = kinds[y], rows[y, 1:]
        if kind == FILTER_NONE:
            out[y] = row
        elif kind == FILTER_UP:
            np.add(row, prev, out=out[y])
        elif kind == FILTER_SUB:
            out[y] = row.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).ravel()
        else:
            cur = bytearray(row.tobytes())
            (_paeth_row if kind == FILTER_PAETH else _average_row)(
                cur, prev.tobytes(), bpp)
            out[y] = np.frombuffer(cur, np.uint8)
        prev = out[y]
    return out


def _to_grey(rgb: np.ndarray, depth: int = 8) -> np.ndarray:
    """libpng's rgb_to_gray, then (at 16 bits) strip_16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    rc, gc, bc = RGB_TO_GREY
    if depth == 16:
        return (((rc * r + gc * g + bc * b + 16384) >> 15) >> 8).astype(np.uint8)
    return ((rc * r + gc * g + bc * b) >> 15).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows as (height, width, channels) samples: uint8 below
    16 bits (sub-byte samples unpacked, most significant first), uint16
    at 16."""
    height = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(height, width, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(height, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    values = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return values.reshape(height, -1)[:, :width, None]


def _pixels(raw: np.ndarray, width: int, height: int, depth: int, channels: int,
            interlace: int) -> np.ndarray:
    """The image's samples, (height, width, channels), from its inflated
    data: one pass, or Adam7's seven passes, each filtered on its own."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    out = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue  # an empty pass stores nothing, not even filter bytes
        stride = (w * bits + 7) // 8
        need = h * (1 + stride)
        if raw.size < at + need:
            raise ValueError(f"PNG image data hold {raw.size} bytes of at "
                             f"least {at + need}")
        rows = _unfilter(raw[at:at + need], h, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, w, depth, channels)
        at += need
    return out


def read_grey(path) -> np.ndarray:
    """The PNG at `path` as a 2-D uint8 array, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` reads it."""
    data = Path(path).read_bytes()
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, method, filters, interlace = header
    if colour not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} does not exist")
    if depth not in DEPTHS[colour]:
        raise ValueError(f"{path}: PNG bit depth {depth} with colour type {colour}")
    if method or filters or interlace > 1:
        raise ValueError(f"{path}: PNG compression, filter or interlace method "
                         f"{method}/{filters}/{interlace} does not exist")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        pixels = _pixels(raw, width, height, depth, CHANNELS[colour], interlace)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if colour == PALETTE:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        if pixels.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: PNG pixel outside its palette")
        return _to_grey(palette[pixels[..., 0]])
    if colour in (RGB, RGBA):
        return _to_grey(pixels, depth)
    grey = pixels[..., 0]
    if depth == 16:
        return (grey >> 8).astype(np.uint8)  # strip_16: the high byte
    return grey * np.uint8(255 // ((1 << depth) - 1))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write(path, image: np.ndarray, text: dict = None) -> None:
    """Write a 2-D uint8 array as 8-bit grey, or an (H, W, 3) uint8 array
    as 8-bit RGB, to `path`; `text` maps tEXt keywords to their text."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"PNG writer takes 2-D or (H, W, 3) uint8 arrays, "
                         f"got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    rows = image.reshape(height, -1)
    filtered = np.empty((height, 1 + rows.shape[1]), np.uint8)
    filtered[:, 0] = FILTER_UP
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])
    colour = GREY if image.ndim == 2 else RGB
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, 8, colour, 0, 0, 0))]
    for keyword, value in (text or {}).items():
        parts.append(_chunk(b"tEXt", keyword.encode("latin-1") + b"\0"
                            + str(value).encode("latin-1")))
    parts.append(_chunk(b"IDAT", zlib.compress(filtered.tobytes())))
    parts.append(_chunk(b"IEND", b""))
    Path(path).write_bytes(b"".join(parts))

