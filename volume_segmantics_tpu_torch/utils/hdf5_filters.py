"""Decoders of the HDF5 filters beyond zlib's that h5py writes: LZF (h5py's
filter 32000), scale-offset (6) and n-bit (5), in Python and numpy.

Each takes a chunk's bytes as the filter before it left them and the
filter's client data (`cd`, the values the library's `set_local` stored in
the filter pipeline message), and returns the bytes the filter was given
when the chunk was written. A corrupt chunk raises ValueError; a setting
not decoded here raises NotImplementedError naming it.
"""

import struct

import numpy as np

# Scale-offset client data (H5Zscaleoffset.c): scale type, scale factor,
# elements in a chunk, datatype class, size, sign, byte order, whether a
# fill value is defined, then the fill value's bytes, 4 to a value.
SO_NPARMS = 20
SO_FLOAT_DSCALE, SO_FLOAT_ESCALE, SO_INT = 0, 1, 2
SO_CLS_INTEGER, SO_CLS_FLOAT = 0, 1
SO_HEADER = 21  # minbits (4 bytes), minval's size (1), minval (up to 16)
UNPACK_ELEMENTS = 1 << 18  # elements unpacked at a time

# n-bit client data (H5Znbit.c): the number of values, "no need to
# compress", elements in a chunk, then per atom its class, size, byte
# order, precision and offset.
NBIT_ATOMIC = 1


def lzf_decode(data) -> bytes:
    """The LZF stream `data` decoded (liblzf's lzf_decompress): a control
    byte below 32 starts a literal run of ctrl + 1 bytes; any other starts
    a back reference of (ctrl >> 5) + 2 bytes (a length field of 7 takes
    one more byte) at ((ctrl & 0x1f) << 8) + next + 1 bytes back, which may
    overlap its own output."""
    src = bytes(data)
    n, i = len(src), 0
    out = bytearray()
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            j = i + ctrl + 1
            if j > n:
                raise ValueError("LZF: a literal run passes the end of the data")
            out += src[i:j]
            i = j
            continue
        length = ctrl >> 5
        if length == 7:
            if i >= n:
                raise ValueError("LZF: a back reference passes the end of the data")
            length += src[i]
            i += 1
        if i >= n:
            raise ValueError("LZF: a back reference passes the end of the data")
        start = len(out) - ((ctrl & 0x1F) << 8) - src[i] - 1
        i += 1
        if start < 0:
            raise ValueError("LZF: a back reference points before the output")
        length += 2
        end = start + length
        if end <= len(out):
            out += out[start:end]
        else:  # a run that repeats its last `period` bytes
            period = out[start:]
            out += (period * -(-length // len(period)))[:length]
    return bytes(out)


def _signed(value: int) -> int:
    """A client data value as the C int the library casts it to."""
    return value - (1 << 32) if value >= 1 << 31 else value


def _unpack_bits(buf, n: int, bits: int, width: int) -> np.ndarray:
    """`n` values of `bits` bits each, packed most significant bit first
    one after another, as unsigned `width`-byte integers."""
    if len(buf) < (n * bits + 7) // 8:
        raise ValueError("scale-offset: the chunk is shorter than its values")
    raw = np.frombuffer(buf, np.uint8)
    out = np.empty(n, f">u{width}")
    for first in range(0, n, UNPACK_ELEMENTS):
        count = min(UNPACK_ELEMENTS, n - first)
        lo = first * bits
        skip = lo % 8
        stream = np.unpackbits(raw[lo // 8:(lo + count * bits + 7) // 8])
        padded = np.zeros((count, 8 * width), np.uint8)
        padded[:, 8 * width - bits:] = stream[skip:skip + count * bits].reshape(
            count, bits)
        out[first:first + count] = np.packbits(padded, axis=1).view(
            f">u{width}").ravel()
    return out


def scaleoffset_decode(data, cd, stored: np.dtype) -> bytes:
    """A scale-offset chunk decoded (H5Z__filter_scaleoffset's reverse
    path), as bytes of the dataset's type `stored`.

    Integers: each value is minval plus its `minbits`-bit code, modulo the
    type's width. Floats (D-scale): code / 10^D + min in the type's own
    precision (powf for float32), as the library computes it. Where a fill
    value is defined, the all-ones code is that fill value. A chunk whose
    minbits is the full width holds the values as they are; minbits 0
    means every value is the minimum."""
    if len(cd) != SO_NPARMS:
        raise ValueError(f"scale-offset: {len(cd)} parameters, not {SO_NPARMS}")
    scale_type, factor = cd[0], _signed(cd[1])
    n, cls, size, sign, _order, fill_defined = cd[2:8]
    if (cls, size) not in ((SO_CLS_INTEGER, 1), (SO_CLS_INTEGER, 2),
                           (SO_CLS_INTEGER, 4), (SO_CLS_INTEGER, 8),
                           (SO_CLS_FLOAT, 4), (SO_CLS_FLOAT, 8)):
        raise ValueError(f"scale-offset: datatype class {cls} of size {size}")
    kind = "f" if cls == SO_CLS_FLOAT else ("i" if sign else "u")
    native = np.dtype(f"<{kind}{size}")
    if native.newbyteorder("=") != stored.newbyteorder("="):
        raise ValueError(f"scale-offset: parameters for {native}, data of {stored}")
    if cls == SO_CLS_INTEGER:
        if scale_type != SO_INT:
            raise ValueError(f"scale-offset: scale type {scale_type} for integers")
        factor = max(factor, 0)
        if factor > 8 * size:
            raise ValueError("scale-offset: minimum bits exceed the type's width")
        if factor == 8 * size:  # the filter left the data as it was
            return bytes(data)
    elif scale_type == SO_FLOAT_ESCALE:
        raise NotImplementedError("the scale-offset filter's E-scale method")
    elif scale_type != SO_FLOAT_DSCALE:
        raise ValueError(f"scale-offset: scale type {scale_type} for floats")

    buf = bytes(data)
    if len(buf) < SO_HEADER:
        raise ValueError("scale-offset: the chunk is shorter than its header")
    minbits = int.from_bytes(buf[:4], "little")
    minval = int.from_bytes(buf[5:5 + min(8, buf[4])], "little")
    if minbits > 8 * size:
        raise ValueError(f"scale-offset: {minbits} bits for {size}-byte values")
    if minbits == 8 * size:
        if len(buf) < SO_HEADER + n * size:
            raise ValueError("scale-offset: the chunk is shorter than its values")
        return np.frombuffer(buf, native, n, SO_HEADER).astype(stored).tobytes()
    codes = (_unpack_bits(buf[SO_HEADER:], n, minbits, size) if minbits
             else np.zeros(n, f">u{size}"))
    fill_code = (1 << minbits) - 1
    if fill_defined:
        words = struct.pack(f"<{SO_NPARMS - 8}I", *cd[8:])
        fill = np.frombuffer(words[:size], native)[0]
    if cls == SO_CLS_INTEGER:
        values = (codes.astype(np.uint64) + np.uint64(minval)).astype(
            f"<u{size}").view(native)
    else:
        ints = codes.astype(f"<i{size}")  # the code's bits read as a C int
        minimum = np.frombuffer(minval.to_bytes(8, "little")[:size], native)[0]
        scale = np.power(native.type(10), native.type(factor))
        values = ints.astype(native) / scale + minimum
    if fill_defined:
        values = np.where(codes == fill_code, fill, values)
    return values.astype(stored).tobytes()


def nbit_check(cd, stored: np.dtype) -> None:
    """Read the n-bit filter's parameters against the dataset's type
    `stored`: one atom of its class, size, byte order, full precision and
    offset 0, which the library marks as needing no packing (cd[1]): the
    filter then leaves the data as it is. Anything else raises."""
    if len(cd) < 8 or cd[0] != len(cd):
        raise ValueError(f"n-bit: a parameter list of {len(cd)} values")
    if cd[3] != NBIT_ATOMIC:
        raise NotImplementedError(f"the n-bit filter on datatype class code {cd[3]}")
    size, order, precision, offset = cd[4:8]
    if size != stored.itemsize or (size > 1 and order != (stored.str[0] == ">")):
        raise ValueError(f"n-bit: parameters for a {size}-byte atom in order "
                         f"{order}, data of {stored}")
    if precision != 8 * size or offset or not cd[1]:
        raise NotImplementedError(f"the n-bit filter on reduced-precision types "
                          f"({precision} bits at bit {offset})")
