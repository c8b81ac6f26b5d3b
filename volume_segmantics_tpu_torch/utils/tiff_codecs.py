"""The TIFF block codecs of `utils/tiff.py`, in numpy alone: LZW and
PackBits decoding, the fill-order-2 bit reversal, sub-byte sample
unpacking and the floating-point predictor (3). LZMA and Deflate blocks go
to the standard library's `lzma` and `zlib`. Each function takes one strip
or tile; `utils/tiff.py` runs them in its thread pool.
"""

import numpy as np

# TIFF LZW: 9 to 12-bit codes, MSB first, widened one code early.
LZW_CLEAR, LZW_EOI, LZW_FIRST = 256, 257, 258

# Each byte with its bits in reversed order (fill order 2 stores the
# leftmost pixel in the least significant bit).
REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


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


def packbits_decode(data) -> np.ndarray:
    """Decode a PackBits stream into uint8 bytes.

    A header byte h < 128 copies the next h + 1 bytes, h > 128 repeats the
    next byte 257 - h times and 128 does nothing. The headers are found by
    one pass over the runs; the runs are then copied by one gather: a
    literal byte's source advances with its output, a repeat's does not.
    A run cut short by the end of the data ends the stream there."""
    src = bytes(data)
    n = len(src)
    starts, lengths, steps = [], [], []
    i = 0
    while i < n:
        h = src[i]
        if h < 128:
            run = min(h + 1, n - i - 1)
            if run > 0:
                starts.append(i + 1)
                lengths.append(run)
                steps.append(1)
            i += h + 2
        elif h > 128:
            if i + 1 >= n:
                break
            starts.append(i + 1)
            lengths.append(257 - h)
            steps.append(0)
            i += 2
        else:
            i += 1
    if not lengths:
        return np.zeros(0, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    first = np.cumsum(lengths) - lengths  # each run's first output index
    within = np.arange(int(lengths.sum())) - np.repeat(first, lengths)
    index = np.repeat(np.asarray(starts, np.int64), lengths) \
        + np.repeat(np.asarray(steps, np.int64), lengths) * within
    return np.frombuffer(src, np.uint8)[index]


def unpack_bits(raw: np.ndarray, rows: int, cols: int, bits: int) -> np.ndarray:
    """`rows` rows of `cols` samples of 1, 2 or 4 bits, most significant
    first, each row padded to a whole byte: bool for 1 bit, else uint8."""
    row_bytes = (cols * bits + 7) // 8
    packed = raw[:rows * row_bytes].reshape(rows, row_bytes)
    if bits == 1:
        return np.unpackbits(packed, axis=1, count=cols).astype(bool)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    values = (packed[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
    return values.reshape(rows, -1)[:, :cols]


def undo_float_predictor(raw: np.ndarray, rows: int, cols: int, samples: int,
                         dtype: np.dtype) -> np.ndarray:
    """Undo TIFF predictor 3 on `rows` rows of `cols` pixels of `samples`
    floating-point samples: each row holds the samples' byte planes, most
    significant first, each byte stored as the difference from the byte
    `samples` before it. Returns (rows, cols * samples) in native order."""
    size = dtype.itemsize
    planes = raw[:rows * cols * samples * size].reshape(rows, cols * size, samples)
    planes = np.cumsum(planes, axis=1, dtype=np.uint8)
    # (rows, plane, col, sample) -> (rows, col, sample, plane): big-endian.
    big = np.ascontiguousarray(
        planes.reshape(rows, size, cols, samples).transpose(0, 2, 3, 1))
    return big.view(dtype.newbyteorder(">")).reshape(rows, cols * samples) \
        .astype(dtype.newbyteorder("="))
