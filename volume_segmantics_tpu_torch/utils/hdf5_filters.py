"""Decoders of the HDF5 filters beyond zlib's that h5py writes: LZF (h5py's
filter 32000), scale-offset (6), n-bit (5) and szip (4), in Python and
numpy.

Each takes a chunk's bytes as the filter before it left them and the
filter's client data (`cd`, the values the library's `set_local` stored in
the filter pipeline message), and returns the bytes the filter was given
when the chunk was written. A corrupt chunk raises ValueError; a setting
not decoded here raises NotImplementedError naming it.
"""

import bisect
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
# order, precision and offset (one atom: integers are read).
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


# szip client data (H5Zszip.c, libaec's szlib.h): the options mask,
# pixels per block, bits per pixel and pixels per scanline; of the options
# only the sample order and the nearest-neighbour preprocessor change how
# libaec decodes.
SZ_MSB, SZ_NN = 16, 32
SZ_ZERO_RUN_SEGMENT = 64  # blocks a zero-block run may reach to (ROS)
SZ_ROS = 5  # the zero-block count that means "to the end of the segment"
SZ_SE_CODES = 91  # second extension codes: pairs summing to 0..12


def _se_pairs() -> np.ndarray:
    """The (first, second) residual pair of each second-extension code m =
    b (b + 1) / 2 + second, b = first + second."""
    pairs = [(b - d, d) for b in range(13) for d in range(b + 1)]
    return np.array(pairs[:SZ_SE_CODES], np.int64)


def szip_decode(data, cd, stored: np.dtype) -> bytes:
    """An szip chunk decoded as HDF5 does through libaec's szip interface
    (H5Z__filter_szip, SZ_BufftoBuffDecompress): the bytes of `stored` it
    was given, from a 4-byte little-endian count of them and the CCSDS
    121.0 adaptive entropy coded samples.

    Pixels of 32 and 64 bits were coded as bytes, byte 0 of every pixel
    first, then byte 1, and so on; others as samples of their width, in
    big-endian order under the MSB option and little-endian otherwise.
    The samples fall in scanlines of `pixels per scanline`, each padded up
    to whole blocks of `pixels per block`, and a scanline's blocks make one
    reference sample interval (RSI); the intervals follow one another
    without padding. Each block starts with an option ID (3 bits for
    samples of up to 8 bits, 4 up to 16): 0 and one more bit select a run
    of zero blocks (its count as a fundamental sequence, 5 meaning "to the
    end of the 64-block segment or the interval") or the second extension
    (pairs of residuals, one fundamental sequence each); all ones an
    uncompressed block; any other ID a split-sample block with k = ID - 1:
    every sample's high bits as a fundamental sequence (n zeros then a
    one), then every sample's k low bits. Under the nearest-neighbour
    option an interval's first sample is its reference, sent raw after the
    ID (and the zero-block bit), and the rest are mapped differences from
    the sample before (`_unmap_residuals`). A short or corrupt stream
    raises ValueError."""
    if len(cd) < 4:
        raise ValueError(f"szip: a parameter list of {len(cd)} values")
    options, block, bits_per_pixel, per_line = (int(v) for v in cd[:4])
    if bits_per_pixel != 8 * stored.itemsize:
        raise ValueError(f"szip: parameters for {bits_per_pixel}-bit pixels, "
                         f"data of {stored}")
    interleaved = bits_per_pixel in (32, 64)
    bits = 8 if interleaved else bits_per_pixel
    if block < 2 or block % 2 or per_line < 1:
        raise ValueError(f"szip: {block} pixels a block, {per_line} a scanline")
    if len(data) < 4:
        raise ValueError("szip: the chunk is shorter than its size field")
    out_len = int.from_bytes(bytes(data[:4]), "little")
    width = 1 if interleaved else bits // 8
    if out_len % width or (interleaved and out_len % (bits_per_pixel // 8)):
        raise ValueError(f"szip: {out_len} bytes of {bits_per_pixel}-bit pixels")
    n_out = out_len // width
    line_blocks = -(-per_line // block)
    interval = line_blocks * block
    padded = per_line % block != 0
    total = (-(-n_out // per_line) * interval) if padded else n_out
    samples = _szip_samples(bytes(data[4:]), total, block, bits, line_blocks,
                            bool(options & SZ_NN))
    if options & SZ_NN:
        samples = _unmap_residuals(samples, interval, bits)
    samples = samples[:total]
    if padded:
        lines = samples.reshape(-1, interval)[:, :per_line]
        samples = lines.reshape(-1)[:n_out]
    order = ">" if options & SZ_MSB else "<"
    raw = samples.astype(f"{order}u{width}").tobytes()
    if interleaved:
        size = bits_per_pixel // 8
        raw = np.frombuffer(raw, np.uint8).reshape(size, -1).T.tobytes()
    return raw


def _szip_samples(stream: bytes, total: int, block: int, bits: int,
                  line_blocks: int, preprocessed: bool) -> np.ndarray:
    """The first `total` coded samples of `stream` (padded up to whole
    blocks) as int64: mapped residuals, each interval's reference sample
    first under the preprocessor. Blocks are walked one at a time to find
    where each ends; the samples of split-sample and uncompressed blocks
    are then gathered for all of them at once."""
    id_len = 3 if bits <= 8 else 4
    uncompressed = (1 << id_len) - 1
    n_bits = 8 * len(stream)
    padded_stream = stream + bytes(8)
    stream_bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    ones = np.flatnonzero(stream_bits)
    ones_list = ones.tolist()
    n_ones = len(ones_list)
    n_blocks = -(-total // block)
    out = np.zeros(n_blocks * block, np.int64)
    se = _se_pairs()
    split = []  # (block index, first sequence bit, ones index, k)
    raw_blocks = []  # (block index, first bit) of uncompressed blocks
    short = "szip: the stream ends inside a block"
    from_bytes, bisect_left = int.from_bytes, bisect.bisect_left

    def read(p, n):
        if p + n > n_bits:
            raise ValueError(short)
        word = from_bytes(padded_stream[p >> 3:(p >> 3) + 5], "big")
        return (word >> (40 - (p & 7) - n)) & ((1 << n) - 1)

    def sequence(p):
        """(value, next bit) of the fundamental sequence at bit p."""
        i = bisect_left(ones_list, p)
        if i == n_ones:
            raise ValueError(short)
        return ones_list[i] - p, ones_list[i] + 1

    p, b = 0, 0
    while b < n_blocks:
        in_interval = b % line_blocks
        ref = preprocessed and in_interval == 0
        option = read(p, id_len)
        p += id_len
        first = b * block
        if option == 0:
            second_extension = read(p, 1)
            p += 1
            if ref:
                out[first] = read(p, bits)
                p += bits
            if not second_extension:
                count, p = sequence(p)
                count += 1
                if count == SZ_ROS:
                    count = min(line_blocks - in_interval,
                                SZ_ZERO_RUN_SEGMENT - in_interval
                                % SZ_ZERO_RUN_SEGMENT)
                elif count > SZ_ROS:
                    count -= 1
                if in_interval + count > line_blocks:
                    raise ValueError("szip: a zero-block run passes the end "
                                     "of its interval")
                b += count
                continue
            i = first + ref
            for _ in range(block // 2):
                m, p = sequence(p)
                if m >= SZ_SE_CODES:
                    raise ValueError(f"szip: second extension code {m}")
                if (i - first) % 2 == 0:
                    out[i] = se[m, 0]
                    i += 1
                out[i] = se[m, 1]
                i += 1
        elif option == uncompressed:
            raw_blocks.append((b, p))
            p += block * bits
            if p > n_bits:
                raise ValueError(short)
        else:
            k = option - 1
            if ref:
                out[first] = read(p, bits)
                p += bits
            n = block - ref
            i = bisect_left(ones_list, p)
            if i + n > n_ones:
                raise ValueError(short)
            split.append((b, p, i, k))
            p = ones_list[i + n - 1] + 1 + n * k
            if p > n_bits:
                raise ValueError(short)
        b += 1

    def binary(first_bits, n, k):
        """The n k-bit numbers from each of `first_bits`, (len, n)."""
        got = stream_bits[first_bits[:, None] + np.arange(n * k)]
        weights = np.int64(1) << np.arange(k - 1, -1, -1, dtype=np.int64)
        return got.reshape(-1, n, k).astype(np.int64) @ weights

    split = np.array(split, np.int64).reshape(-1, 4)
    starts_interval = (split[:, 0] % line_blocks == 0) & preprocessed
    for k in np.unique(split[:, 3]).tolist():
        for ref in (0, 1):
            where = split[(split[:, 3] == k) & (starts_interval == ref)]
            if not len(where):
                continue
            n = block - ref
            ends = ones[where[:, 2:3] + np.arange(n)]
            starts = np.concatenate([where[:, 1:2] - 1, ends[:, :-1]], axis=1)
            values = (ends - starts - 1) << k
            if k:
                values += binary(ends[:, -1] + 1, n, k)
            out[(where[:, :1] * block + ref + np.arange(n)).ravel()] = (
                values.ravel())
    if raw_blocks:
        where = np.array(raw_blocks, np.int64)
        out[(where[:, :1] * block + np.arange(block)).ravel()] = binary(
            where[:, 1], block, bits).ravel()
    return out


def _unmap_residuals(samples: np.ndarray, interval: int, bits: int):
    """The nearest-neighbour preprocessor undone on each interval of
    `interval` samples: after the reference x, each mapped difference d
    gives x + d / 2 (d even) or x - (d + 1) / 2 (d odd) where ceil(d / 2)
    is at most theta = min(x, 2^bits - 1 - x), and otherwise d itself if
    x is below 2^(bits - 1) or 2^bits - 1 - d if not (libaec's unsigned
    flush). Intervals whose every difference is in range take a
    cumulative sum; the others are walked a sample at a time."""
    top = (1 << bits) - 1
    half = 1 << (bits - 1)
    rows = -(-len(samples) // interval)
    grid = np.zeros(rows * interval, np.int64)
    grid[:len(samples)] = samples
    grid = grid.reshape(rows, interval)
    d = grid[:, 1:]
    delta = np.where(d & 1, -((d + 1) >> 1), d >> 1)
    x = grid[:, :1] + np.cumsum(delta, axis=1)
    before = np.concatenate([grid[:, :1], x[:, :-1]], axis=1)
    inside = ((d + 1) >> 1) <= np.minimum(before, top - before)
    out = np.concatenate([grid[:, :1], x], axis=1)
    for r in np.flatnonzero(~inside.all(axis=1)).tolist():
        row = grid[r].tolist()
        value = row[0]
        for j in range(1, interval):
            m = row[j]
            if (m + 1) >> 1 <= (value if value < half else top - value):
                value += -((m + 1) >> 1) if m & 1 else m >> 1
            else:
                value = m if value < half else top - m
            row[j] = value
        out[r] = row
    return out.reshape(-1)


def _signed(value: int) -> int:
    """A client data value as the C int the library casts it to."""
    return value - (1 << 32) if value >= 1 << 31 else value


def _unpack_bits(buf, n: int, bits: int, width: int) -> np.ndarray:
    """`n` values of `bits` bits each, packed most significant bit first
    one after another, as unsigned `width`-byte integers."""
    if len(buf) < (n * bits + 7) // 8:
        raise ValueError("the chunk is shorter than its packed values")
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


def nbit_check(cd, stored: np.dtype, bits, packed: bool = True) -> None:
    """Read the n-bit filter's parameters against the dataset's type
    `stored` and its (bit offset, precision) `bits` (None at full
    precision): one atom of its class, size, byte order, precision and
    offset. A type the filter does not pack (`packed` False: an
    enumeration) has the three parameters the library gives it, the last
    two "no packing" and the value count. Anything else raises."""
    if not packed:
        if len(cd) != 3 or cd[0] != 3 or not cd[1]:
            raise ValueError(f"n-bit: parameters {tuple(cd)} for a type it "
                             "does not pack")
        return
    if len(cd) < 8 or cd[0] != len(cd):
        raise ValueError(f"n-bit: a parameter list of {len(cd)} values")
    if cd[3] != NBIT_ATOMIC:
        raise NotImplementedError(f"the n-bit filter on datatype class code {cd[3]}")
    size, order, precision, offset = cd[4:8]
    if size != stored.itemsize or (size > 1 and order != (stored.str[0] == ">")):
        raise ValueError(f"n-bit: parameters for a {size}-byte atom in order "
                         f"{order}, data of {stored}")
    if (offset, precision) != (bits or (0, 8 * size)):
        raise ValueError(f"n-bit: parameters for {precision} bits at bit "
                         f"{offset}, data of {bits or 'full precision'}")


def nbit_decode(data, cd, stored: np.dtype) -> bytes:
    """An n-bit chunk decoded (H5Z__filter_nbit's reverse path) as bytes of
    the dataset's integer type `stored`: where the library marked the type
    as needing no packing (cd[1]), the data as they are; else each of the
    chunk's cd[2] values is `precision` bits, most significant first, one
    after another, put back at its bit offset with every other bit 0."""
    if cd[1]:
        return bytes(data)
    n, size, precision, offset = cd[2], cd[4], cd[6], cd[7]
    codes = _unpack_bits(bytes(data), n, precision, size).astype(f"=u{size}")
    unsigned = np.dtype(f"{'>' if stored.str[0] == '>' else '<'}u{size}")
    return (codes << np.array(offset, codes.dtype)).astype(unsigned).tobytes()
