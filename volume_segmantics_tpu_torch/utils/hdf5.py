"""Reader and writer for HDF5 as h5py writes it, in numpy and zlib alone
(the GPU machine has no h5py).

The reader takes what h5py 3 writes at any `libver` bound, as h5py reads
it:
- a user block before the superblock (looked for at 0, 512, 1024, 2048,
  ..., as the library does; addresses count from the superblock), and
  superblock versions 0 to 3, with offsets and lengths of 2, 4 or 8 bytes
  (`H5Pset_sizes`: every address read at the offsets' size, all ones
  being `UNDEF`, and every length at the lengths', as the library decodes
  them: an unlimited dimension under lengths of 4 bytes reads back as
  2**32 - 1, as h5py's `maxshape` gives it);
- version 1 object headers and version 2 ones (`OHDR`, with their `OCHK`
  continuation blocks);
- groups of both kinds: symbol tables (v1 B-tree, SNOD nodes and a local
  heap), and link messages, either in the object header or, in a dense
  group, in a fractal heap reached through the version 2 B-tree of link
  names;
- hard, soft and external links along a path such as
  ``/entry/final_result_tomo/data``. One lookup follows at most 16 soft or
  external links, as the library does, and raises KeyError past that (a
  cycle; h5py raises RuntimeError there). An external link's file is
  looked for as the library looks for it (`File._other_file`), and a
  dataset reached through one keeps that file open for as long as it
  lives;
- fixed-point (1, 2, 4 or 8 bytes, signed or not) datatypes in either
  byte order, of full precision or of fewer bits at a bit offset (each
  value converted to the full-width type as the library converts it,
  sign-extended), and IEEE float (2, 4 or 8 bytes) of full precision;
  enumerations (class 8) as their integer base, and h5py's booleans (an
  enumeration of exactly FALSE = 0 and TRUE = 1, as h5py writes every
  numpy bool array) as numpy bool, as h5py reads them; a
  datatype committed to the file (a named type: the dataset's or an
  attribute's datatype message shared from the type's object header);
- contiguous, compact and chunked layouts (layout message versions 3 and
  4), with chunks found through each index the library writes: the
  version 1 B-tree, a single chunk, the implicit index, the fixed array,
  the extensible array and the version 2 B-tree; partial edge chunks,
  filtered or (chunk option flag 1, `H5Pset_chunk_opts`) stored raw, and
  chunks never written (these take the fill value);
- the filters deflate, shuffle, Fletcher-32, LZF (h5py's filter 32000),
  scale-offset (integers, and floats with a decimal scale, bit for bit as
  the library decodes them), n-bit (integers of reduced precision, and
  full-precision types, which it leaves as they are) and szip (as libaec
  decodes it) in `hdf5_filters`;
  a chunk's filter mask skips the filters its writer skipped, such as LZF
  or szip on a chunk it cannot shrink;
- external raw storage: the data in segments of raw files, a relative
  name under $HDF5_EXTFILE_PREFIX (``${ORIGIN}`` is the file's directory)
  or else in the working directory, as the library finds them; a missing
  file raises OSError, a short one reads as zeros;
- virtual datasets (layout class 3): the mappings in the global heap,
  their source and virtual selections ("all" and hyperslabs, regular or
  not, in each encoding the library writes), unlimited mappings and
  printf-style (%b) source names, resolved when the dataset is opened as
  h5py's default view resolves them (`shape` follows the sources found
  then); sources of another type converted as the library converts them,
  an enumeration's only from one of the same base and kind.
  A source file is looked for as an external link's, under
  $HDF5_VDS_PREFIX; "." is the same file. A source is opened through this
  reader (chunked, filtered, external or itself virtual) once a dataset; a
  region whose source file or dataset is missing takes the fill value, as
  h5py gives it.

Every checksum the library writes on the way is verified: the superblock
(versions 2 and 3), object headers and their continuation blocks,
version 2 B-tree headers and nodes, fractal heap direct blocks, fixed and
extensible array blocks and pages, the virtual dataset mappings and
Fletcher-32 chunks. A mismatch, or a chunk that does not decode, raises
ValueError.

It returns arrays in native byte order, and `chunks` as h5py's
``dataset.chunks`` gives them. ``ds[sel]`` takes h5py's basic selections
(ints and step-1 slices): a chunked dataset indexes its chunks once and
inflates only those that meet the selection, a virtual one reads only the
mappings that meet it, so a volume larger than host memory is read a slab
at a time. Every chunk a read inflates, through any depth of virtual
datasets, is a job of one thread pool. Every other feature raises
NotImplementedError naming it: other filters, floats of reduced
precision, scale-offset's E-scale method, point selections in virtual
dataset mappings, virtual sources of floats under integers or of other
types under float16, or of enumerations under another type, shared
object header messages kept in the file's shared message index (SOHM),
enumerations of a reduced-precision base, other datatypes, offsets or
lengths of 16 bytes or more, steps and fancy indexing, and more. A path
that is not in the file raises KeyError, as h5py does. `ds.attrs` gives a
dataset's attributes kept in its object header (attribute messages of
versions 1 to 3) whose types the reader knows, committed ones and
enumerations too, numpy scalars for scalar ones as h5py gives them; dense
attribute storage and shared attribute messages raise
NotImplementedError.

The writer makes what ``h5py.File(p, "w").create_dataset(path, data=...,
chunks=..., compression="gzip")`` makes: superblock version 0, chunked,
deflate-compressed datasets at their internal paths (their groups as
symbol-table groups of up to 8 entries), chunks equal to the given
chunking or to h5py's `guess_chunk`, with attributes (`dset.attrs[name] =
value` of integers or floats) as version 1 attribute messages. Chunks are
compressed in a thread pool (zlib releases the GIL) and written in order,
so the file does not depend on the pool.
"""

import bisect
import functools
import itertools
import math
import mmap
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from volume_segmantics_tpu_torch.utils import hdf5_filters
from volume_segmantics_tpu_torch.utils.config import HDF5_GZIP_LEVEL

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # HDF5's undefined address (or unlimited length)
# Sizes of offsets and lengths a superblock may give, and their struct codes.
SIZE_CODES = {2: "H", 4: "I", 8: "Q"}
MAX_LINK_TRAVERSALS = 16  # soft and external links one lookup may follow

# Object header message types.
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x7, 0x8
MSG_FILTERS, MSG_ATTRIBUTE, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0xC, 0x10, 0x11
MSG_ATTRIBUTE_INFO = 0x15
FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32, FILTER_SZIP = 1, 2, 3, 4
FILTER_NBIT, FILTER_SCALEOFFSET, FILTER_LZF = 5, 6, 32000
FILTER_NAMES = {FILTER_DEFLATE: "deflate", FILTER_SHUFFLE: "shuffle",
                FILTER_FLETCHER32: "Fletcher-32", FILTER_SZIP: "szip",
                FILTER_NBIT: "n-bit", FILTER_SCALEOFFSET: "scale-offset",
                FILTER_LZF: "LZF"}
LINK_HARD, LINK_SOFT, LINK_EXTERNAL = 0, 1, 64
SHARED_COMMITTED = 2  # a shared message's kind: in another object's header
LAYOUT_COMPACT, LAYOUT_CONTIGUOUS, LAYOUT_CHUNKED, LAYOUT_VIRTUAL = 0, 1, 2, 3

# Where the library looks for other files: an external link's file, a
# virtual dataset's source file, an external raw data file.
EXT_PREFIX_ENV = "HDF5_EXT_PREFIX"
VDS_PREFIX_ENV = "HDF5_VDS_PREFIX"
EXTFILE_PREFIX_ENV = "HDF5_EXTFILE_PREFIX"
ORIGIN = "${ORIGIN}"

# Dataspace selections as the library serialises them (H5S*.c): the types,
# and the flag of a regular hyperslab's encoding.
SEL_NONE, SEL_POINTS, SEL_HYPERSLABS, SEL_ALL = 0, 1, 2, 3
HYPER_REGULAR = 0x1
VDS_HEAP_VERSION = 0  # the encoding of a virtual dataset's mappings
MAX_VDS_DEPTH = 32  # virtual datasets one read may pass through (cycles)
VDS_PRINTF_GAP = 0  # missing %b sources a search passes (the library's default)
_OPENING = threading.local()  # virtual datasets this thread is resolving

# Chunk indexes: the version 1 B-tree of a version 3 layout message, and
# the index types of a version 4 one.
INDEX_BTREE1, INDEX_SINGLE, INDEX_IMPLICIT = 0, 1, 2
INDEX_FIXED_ARRAY, INDEX_EXTENSIBLE_ARRAY, INDEX_BTREE2 = 3, 4, 5
# Version 2 B-tree record types: link names of a dense group; chunks of a
# dataset without and with filters.
BTREE2_LINK_NAMES, BTREE2_CHUNKS, BTREE2_FILTERED_CHUNKS = 5, 10, 11

# B-tree node capacities of a superblock version 0 file (2K entries a node):
# group nodes K = 16, chunk index nodes K = 32; group leaf (SNOD) K = 4.
GROUP_NODE_ENTRIES, CHUNK_NODE_ENTRIES, SNOD_ENTRIES = 32, 64, 8
DATATYPE_ENUM = 8  # the datatype class of an enumeration
BOOL_MEMBERS = {b"FALSE": 0, b"TRUE": 1}  # h5py's booleans

# IEEE layouts by size: (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias).
IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}

# h5py's guess_chunk constants (h5py/_hl/filters.py).
CHUNK_BASE = 16 * 1024
CHUNK_MIN = 8 * 1024
CHUNK_MAX = 1024 * 1024

MASK32 = 0xFFFFFFFF
FLETCHER_BLOCK = 1 << 20  # 16-bit words summed at a time in int64


def unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"HDF5 {feature} is not supported by the PyTorch port's HDF5 reader, "
        "which reads what h5py writes (see ROADMAP.md)."
    )


def guess_chunk(shape, typesize: int) -> tuple:
    """h5py's chunk guess for a fixed-size dataset (a copy of
    h5py/_hl/filters.py:guess_chunk): halve the axes in turn until a chunk
    is near a target size that grows with the dataset, below 1 MiB."""
    chunks = np.array([x if x != 0 else 1024 for x in shape], dtype="=f8")
    if len(chunks) == 0:
        raise ValueError("Chunks not allowed for scalar datasets.")

    def product(nums):
        prod = 1
        for x in nums:
            prod *= x
        return prod

    dset_size = product(chunks) * typesize
    target_size = CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target_size = min(max(target_size, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = product(chunks) * typesize
        if (chunk_bytes < target_size
                or abs(chunk_bytes - target_size) / target_size < 0.5) \
                and chunk_bytes < CHUNK_MAX:
            break
        if product(chunks) == 1:
            break
        chunks[idx % len(chunks)] = np.ceil(chunks[idx % len(chunks)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# ----------------------------------------------------------------------
# Checksums
# ----------------------------------------------------------------------


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & MASK32


def lookup3(data) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` with seed 0, the checksum of the
    superblock and object headers of superblock version 2 and 3 files (the
    library's H5_checksum_lookup3)."""
    data = bytes(data)
    a = b = c = (0xDEADBEEF + len(data)) & MASK32
    if not data:
        return c
    words = struct.unpack(f"<{-(-len(data) // 12) * 3}I",
                          data + b"\0" * (-len(data) % 12))
    for i in range(0, len(words) - 3, 3):
        a = (a + words[i]) & MASK32
        b = (b + words[i + 1]) & MASK32
        c = (c + words[i + 2]) & MASK32
        a = (a - c) & MASK32 ^ _rot(c, 4)
        c = (c + b) & MASK32
        b = (b - a) & MASK32 ^ _rot(a, 6)
        a = (a + c) & MASK32
        c = (c - b) & MASK32 ^ _rot(b, 8)
        b = (b + a) & MASK32
        a = (a - c) & MASK32 ^ _rot(c, 16)
        c = (c + b) & MASK32
        b = (b - a) & MASK32 ^ _rot(a, 19)
        a = (a + c) & MASK32
        c = (c - b) & MASK32 ^ _rot(b, 4)
        b = (b + a) & MASK32
    a = (a + words[-3]) & MASK32
    b = (b + words[-2]) & MASK32
    c = (c + words[-1]) & MASK32
    c = ((c ^ b) - _rot(b, 14)) & MASK32
    a = ((a ^ c) - _rot(c, 11)) & MASK32
    b = ((b ^ a) - _rot(a, 25)) & MASK32
    c = ((c ^ b) - _rot(b, 16)) & MASK32
    a = ((a ^ c) - _rot(c, 4)) & MASK32
    b = ((b ^ a) - _rot(a, 14)) & MASK32
    return ((c ^ b) - _rot(b, 24)) & MASK32


def fletcher32(data) -> int:
    """The library's Fletcher-32 (H5_checksum_fletcher32) of `data`: sums
    of its big-endian 16-bit words (an odd last byte is a high byte) and of
    their running sums, each kept modulo 65535 in ones' complement (a
    nonzero multiple of 65535 is 0xFFFF)."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size % 2:
        raw = np.append(raw, np.uint8(0))
    words = raw.view(">u2")
    n, sum1, sum2 = words.size, 0, 0
    for start in range(0, n, FLETCHER_BLOCK):
        w = words[start:start + FLETCHER_BLOCK].astype(np.int64)
        # Word i enters the running sums n - i times.
        weights = (n - np.arange(start, start + w.size, dtype=np.int64)) % 65535
        sum1 += int(w.sum())
        sum2 += int((weights * w).sum())

    def fold(s):
        return 0 if s == 0 else (s - 1) % 65535 + 1

    return (fold(sum2) << 16) | fold(sum1)


def _enc_size(n: int) -> int:
    """Bytes the library gives a field that holds numbers up to `n`."""
    return (n.bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _symbol_entry_size(offset_size: int, length_size: int) -> int:
    """Bytes of a symbol table entry: the name's heap offset (a length) and
    the object header's address, the cache type, 4 reserved bytes, 16 of
    scratch."""
    return length_size + offset_size + 24


def _btree_header_size(offset_size: int) -> int:
    """Bytes of a version 1 B-tree node's header: `TREE`, the node type,
    level and entry count, the left and right siblings' addresses."""
    return 8 + 2 * offset_size


# ----------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------


class File:
    """A read-only HDF5 file: ``with File(p) as f: ds = f["/data"]``."""

    def __init__(self, path):
        self.path = Path(path)
        # Where a relative external link's file is looked for first (the
        # library's "extpath"), fixed when the file is opened.
        self._dir = Path(os.path.abspath(self.path)).parent
        self._externals = {}  # files opened through external links, by path
        self._map = self._buf = None
        self._file = open(self.path, "rb")
        try:
            self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._base = self._find_superblock()
            self._buf = memoryview(self._map)[self._base:]
            self._root = self._read_superblock()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Close the file. A file opened through one of its external links
        stays open while a dataset in it lives."""
        self._externals = {}
        try:
            if self._buf is not None:
                self._buf.release()
            if self._map is not None:
                self._map.close()
        except BufferError:
            # A view of the file is still alive (say, in a traceback): the
            # map closes when the last one goes.
            pass
        self._buf = self._map = None
        self._file.close()

    def __del__(self):
        if getattr(self, "_file", None) is not None and not self._file.closed:
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _u(self, fmt, offset):
        return struct.unpack_from("<" + fmt, self._buf, offset)

    def _uint(self, offset, size) -> int:
        return int.from_bytes(self._buf[offset:offset + size], "little")

    def _addr(self, offset, count=None):
        """The address at `offset`, in the superblock's size of offsets
        (`count` of them laid end to end, as a tuple, when given). The
        file's undefined address, all ones, is `UNDEF`, as the library
        decodes it."""
        values = struct.unpack_from(
            f"<{count or 1}{SIZE_CODES[self.offset_size]}", self._buf, offset)
        ones = (1 << 8 * self.offset_size) - 1
        values = tuple(UNDEF if v == ones else v for v in values)
        return values if count is not None else values[0]

    def _length(self, offset, count=None):
        """The length at `offset`, in the superblock's size of lengths
        (`count` of them as a tuple, when given), taken as it is: the
        library gives all ones no meaning of its own below 8 bytes."""
        values = struct.unpack_from(
            f"<{count or 1}{SIZE_CODES[self.length_size]}", self._buf, offset)
        return values if count is not None else values[0]

    def _cstring(self, offset) -> str:
        start = self._base + offset
        return self._map[start:self._map.find(b"\0", start)].decode()

    def _verify(self, start, end, what) -> None:
        """Check the lookup3 checksum stored at `end` of the bytes from
        `start` to `end`."""
        if lookup3(self._buf[start:end]) != self._u("I", end)[0]:
            raise ValueError(f"{self.path}: {what} at {start} fails its "
                             "checksum (the file is corrupt)")

    def _find_superblock(self) -> int:
        """Offset of the superblock: 0, or the end of a user block, which
        is 512 bytes or a larger power of two, as the library looks."""
        offset = 0
        while offset + len(SIGNATURE) <= len(self._map):
            if self._map[offset:offset + len(SIGNATURE)] == SIGNATURE:
                return offset
            offset = 2 * offset if offset else 512
        raise ValueError(f"{self.path} is not an HDF5 file (no superblock at "
                         "0, 512, 1024, 2048, ...)")

    def _read_superblock(self) -> int:
        """The root group's object header address. The base address the
        superblock stores is the superblock's own offset, as the library
        takes it whatever it says."""
        buf = self._buf
        version = buf[8]
        if version in (0, 1):
            sizes = buf[13], buf[14]
        elif version in (2, 3):
            sizes = buf[9], buf[10]
        else:
            raise unsupported(f"superblock version {version}")
        for what, size in zip(("offsets", "lengths"), sizes):
            if size not in SIZE_CODES:
                raise unsupported(f"{what} of {size} bytes (2, 4 and 8 are read)")
        self.offset_size, self.length_size = sizes
        o = self.offset_size
        if version >= 2:
            # The base, extension, end-of-file and root addresses follow.
            self._verify(0, 12 + 4 * o, "superblock")
            return self._addr(12 + 3 * o)
        # Four addresses, then the root's symbol table entry: its name's
        # heap offset (a length), then its object header's address.
        return self._addr((24 if version == 0 else 28) + 4 * o + self.length_size)

    def _messages(self, addr: int) -> dict:
        """{message type: [(flags, data offset, size), ...]} of the object
        header at `addr` (version 1, or version 2 with its checksums
        verified), continuation blocks followed."""
        buf = self._buf
        if buf[addr:addr + 4] == b"OHDR":
            version, flags = buf[addr + 4], buf[addr + 5]
            if version != 2:
                raise ValueError(f"{self.path}: object header version {version}")
            p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x3)
            size = self._uint(p, width)
            p += width
            self._verify(addr, p + size, "object header")
            prefix = 6 if flags & 0x4 else 4  # with creation order
            blocks = [(p, p + size)]
        elif buf[addr] == 1:
            prefix = 8
            blocks = [(addr + 16, addr + 16 + self._u("I", addr + 8)[0])]
        else:
            raise ValueError(f"{self.path}: no object header at {addr}")
        msgs = {}
        while blocks:
            p, end = blocks.pop(0)
            while p + prefix <= end:
                if prefix == 8:
                    mtype, msize, mflags = self._u("HHB", p)
                else:
                    mtype, msize, mflags = self._u("BHB", p)
                if mtype == MSG_CONTINUATION:
                    start = self._addr(p + prefix)
                    length = self._length(p + prefix + self.offset_size)
                    if prefix == 8:
                        blocks.append((start, start + length))
                    else:
                        if buf[start:start + 4] != b"OCHK":
                            raise ValueError(f"{self.path}: no continuation "
                                             f"block at {start}")
                        self._verify(start, start + length - 4,
                                     "object header continuation block")
                        blocks.append((start + 4, start + length - 4))
                elif mtype != MSG_NIL:
                    msgs.setdefault(mtype, []).append((mflags, p + prefix, msize))
                p += prefix + msize
        return msgs

    def _shared(self, d: int, mtype: int) -> int:
        """The data offset of the message of type `mtype` that the shared
        message at `d` points to: one kept in another object's header (a
        committed datatype), read there. One kept in the file's shared
        message index (SOHM) is refused."""
        version, kind = self._buf[d], self._buf[d + 1]
        if version == 1:
            addr = self._addr(d + 8)
        elif version == 2 or (version == 3 and kind == SHARED_COMMITTED):
            addr = self._addr(d + 2)
        elif version == 3:
            raise unsupported(f"shared object header messages (type {mtype}) "
                              "in the file's shared message index (SOHM)")
        else:
            raise unsupported(f"shared message encoding version {version}")
        found = self._messages(addr).get(mtype)
        if not found:
            raise ValueError(f"{self.path}: the shared object at {addr} lacks "
                             f"message {mtype}")
        return found[0][1]

    def _btree_children(self, addr: int, node_type: int, key_size: int):
        """(key offset, child address) of every level-0 entry of the
        version 1 B-tree rooted at `addr`, in order."""
        if self._buf[addr:addr + 4] != b"TREE" or self._buf[addr + 4] != node_type:
            raise ValueError(f"{self.path}: no type {node_type} B-tree node at {addr}")
        level = self._buf[addr + 5]
        used = self._u("H", addr + 6)[0]
        p = addr + _btree_header_size(self.offset_size)
        for _ in range(used):
            child = self._addr(p + key_size)
            if level == 0:
                yield p, child
            else:
                yield from self._btree_children(child, node_type, key_size)
            p += key_size + self.offset_size

    def _btree2_records(self, addr: int, record_type: int):
        """(record size, record offsets in key order) of the version 2
        B-tree whose header is at `addr`."""
        buf = self._buf
        if buf[addr:addr + 4] != b"BTHD" or buf[addr + 5] != record_type:
            raise ValueError(f"{self.path}: no type {record_type} version 2 "
                             f"B-tree at {addr}")
        o = self.offset_size
        # The root's address and record count, then the tree's record count.
        self._verify(addr, addr + 18 + o + self.length_size,
                     "version 2 B-tree header")
        node_size, record_size, depth = self._u("IHH", addr + 6)
        root, root_count = self._addr(addr + 16), self._u("H", addr + 16 + o)[0]
        # The widths of a child pointer's record counts follow from how many
        # records a node of each level can hold (the library's H5B2hdr.c).
        most = (node_size - 10) // record_size  # in a leaf
        count_size = _enc_size(most)
        totals, total_sizes = [most], [0]
        for level in range(1, depth + 1):
            pointer = o + count_size + total_sizes[level - 1]
            n = (node_size - 10 - pointer) // (record_size + pointer)
            totals.append((n + 1) * totals[level - 1] + n)
            total_sizes.append(_enc_size(totals[level]))

        def walk(node, count, level):
            if (buf[node:node + 4] != (b"BTIN" if level else b"BTLF")
                    or buf[node + 5] != record_type):
                raise ValueError(f"{self.path}: no version 2 B-tree node at {node}")
            records = node + 6
            if level == 0:
                self._verify(node, records + count * record_size,
                             "version 2 B-tree leaf node")
                yield from range(records, records + count * record_size,
                                 record_size)
                return
            p = records + count * record_size
            pointer = o + count_size + total_sizes[level - 1]
            self._verify(node, p + (count + 1) * pointer,
                         "version 2 B-tree internal node")
            for i in range(count + 1):
                child = self._addr(p)
                child_count = self._uint(p + o, count_size)
                p += pointer
                yield from walk(child, child_count, level - 1)
                if i < count:
                    yield records + i * record_size

        return record_size, (walk(root, root_count, depth) if root != UNDEF
                             else iter(()))

    def _links(self, addr: int):
        """{name: link} of the group whose object header is at `addr`, or
        None when it is not a group. A link is ("hard", address), ("soft",
        path), ("external", file name, path) or ("user-defined", type)."""
        msgs = self._messages(addr)
        if MSG_SYMBOL_TABLE in msgs:
            return self._symbol_table_links(msgs[MSG_SYMBOL_TABLE][0][1])
        if MSG_LINK_INFO not in msgs:
            return None
        links = dict(self._link(d) for _, d, _ in msgs.get(MSG_LINK, ()))
        links.update(self._dense_links(msgs[MSG_LINK_INFO][0][1]))
        return links

    def _symbol_table_links(self, d) -> dict:
        o, n = self.offset_size, self.length_size
        btree, heap = self._addr(d, 2)
        heap_data = self._local_heap_data(heap)
        links = {}
        # A group node's keys are the heap offsets of names: lengths.
        for _key, snod in self._btree_children(btree, 0, n):
            if self._buf[snod:snod + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol table node at {snod}")
            for i in range(self._u("H", snod + 6)[0]):
                e = snod + 8 + i * _symbol_entry_size(o, n)
                name_off, header = self._length(e), self._addr(e + n)
                cache = self._u("I", e + n + o)[0]
                name = self._cstring(heap_data + name_off)
                if cache == 2:  # a soft link: its value is in the heap
                    value = heap_data + self._u("I", e + n + o + 8)[0]
                    links[name] = ("soft", self._cstring(value))
                else:
                    links[name] = ("hard", header)
        return links

    def _local_heap_data(self, heap: int) -> int:
        """The address of the data of the local heap (`HEAP`) at `heap`:
        after its data size and free list offset, two lengths."""
        if self._buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        return self._addr(heap + 8 + 2 * self.length_size)

    def _link(self, d) -> tuple:
        """(name, link) of the link message at `d`."""
        buf = self._buf
        version, flags = buf[d], buf[d + 1]
        if version != 1:
            raise unsupported(f"link message version {version}")
        p = d + 2
        kind = LINK_HARD
        if flags & 0x8:
            kind = buf[p]
            p += 1
        p += (8 if flags & 0x4 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 0x3)
        size = self._uint(p, width)
        name = bytes(buf[p + width:p + width + size]).decode()
        p += width + size
        if kind == LINK_HARD:
            return name, ("hard", self._addr(p))
        value = bytes(buf[p + 2:p + 2 + self._u("H", p)[0]])
        if kind == LINK_SOFT:
            return name, ("soft", value.decode())
        if kind == LINK_EXTERNAL:  # a version and flags byte, two C strings
            file_name, path, _ = value[1:].split(b"\0", 2)
            return name, ("external", file_name.decode(), path.decode())
        return name, ("user-defined", kind)

    def _dense_links(self, d) -> dict:
        """The links of a dense group, whose link info message is at `d`:
        each record of its name index (a version 2 B-tree) holds the heap ID
        of a link message in its fractal heap. The creation-order index, if
        there is one, indexes the same links."""
        flags = self._buf[d + 1]
        heap, names = self._addr(d + 2 + (8 if flags & 0x1 else 0), 2)
        if names == UNDEF:
            return {}
        heap = _FractalHeap(self, heap)
        _, records = self._btree2_records(names, BTREE2_LINK_NAMES)
        return dict(self._link(heap.object(r + 4)) for r in records)

    def _other_file(self, name: str, env: str):
        """The file an external link or a virtual dataset's mapping names,
        looked for as the library looks for it (H5F_prefix_open_file): an
        absolute name as it is, then (with its directories dropped) under
        each directory of the environment variable `env` (``${ORIGIN}`` is
        this file's directory), in this file's directory, and in the working
        directory. The first candidate that opens as HDF5 is taken; None
        when none does. Each file is opened once."""
        target = Path(name)
        candidates = []
        if target.is_absolute():
            candidates.append(target)
            target = Path(target.name)
        for prefix in os.environ.get(env, "").split(os.pathsep):
            if prefix:
                candidates.append(Path(prefix.replace(ORIGIN, str(self._dir)))
                                  / target)
        candidates += [self._dir / target, target]
        for path in candidates:
            key = os.path.abspath(path)
            if key not in self._externals:
                try:
                    self._externals[key] = File(path)
                except (OSError, ValueError):
                    continue
            return self._externals[key]
        return None

    def _external(self, name: str) -> "File":
        """The file of an external link (see `_other_file`)."""
        f = self._other_file(name, EXT_PREFIX_ENV)
        if f is None:
            raise KeyError(f"Unable to open object (can't open file '{name}' "
                           "of an external link)")
        return f

    def _global_heap_object(self, addr: int, index: int):
        """The bytes of object `index` of the global heap collection
        (`GCOL`) at `addr`."""
        buf = self._buf
        if buf[addr:addr + 4] != b"GCOL" or buf[addr + 4] != 1:
            raise ValueError(f"{self.path}: no global heap collection at {addr}")
        # The collection's header and each object's are padded to 8 bytes:
        # 16 at every size of lengths up to 8.
        end = addr + self._length(addr + 8)
        p = addr + 16
        while p + 16 <= end:
            obj, _refs = self._u("HH", p)
            size = self._length(p + 8)
            if obj == 0:  # the free space: no object follows
                break
            if obj == index:
                if p + 16 + size > end:
                    raise ValueError(f"{self.path}: global heap object {index} "
                                     f"at {addr} passes its collection's end")
                return bytes(buf[p + 16:p + 16 + size])
            p += 16 + size + (-size % 8)
        raise ValueError(f"{self.path}: no object {index} in the global heap "
                         f"collection at {addr}")

    def _resolve(self, path: str, budget: list, group=None) -> tuple:
        """(file, object header address) of `path`, taken from the group at
        `group` of this file when relative, else from the root. `budget`
        holds how many more soft or external links may be followed."""
        f = self
        addr = self._root if group is None or path.startswith("/") else group
        parts = [p for p in path.split("/") if p and p != "."]
        for depth, name in enumerate(parts):
            links = f._links(addr)
            where = "/" + "/".join(parts[:depth])
            if links is None:
                raise KeyError(f"Unable to open object ({where} is not a group)")
            if name not in links:
                raise KeyError(
                    f"Unable to open object (component '{name}' not found)")
            link = links[name]
            if link[0] == "hard":
                addr = link[1]
                continue
            if link[0] == "user-defined":
                raise unsupported(f"user-defined links (type {link[1]}, "
                                  f"{where.rstrip('/')}/{name})")
            budget[0] -= 1
            if budget[0] < 0:
                raise KeyError(f"Unable to open object (too many links: more "
                               f"than {MAX_LINK_TRAVERSALS} soft or external "
                               f"links followed at {where.rstrip('/')}/{name})")
            if link[0] == "soft":
                f, addr = f._resolve(link[1], budget, addr)
            else:
                f, addr = f._external(link[1])._resolve(link[2], budget)
        return f, addr

    def __getitem__(self, path: str) -> "Dataset":
        f, addr = self._resolve(str(path), [MAX_LINK_TRAVERSALS])
        if f._links(addr) is not None:
            raise TypeError(f"{path} in {self.path} is a group, not a dataset")
        return Dataset(f, addr, str(path))


class _FractalHeap:
    """The managed objects of a fractal heap (`FRHP`): its direct blocks,
    found once from its root block, locate each object by its offset in
    the heap."""

    def __init__(self, f: File, addr: int):
        if f._buf[addr:addr + 4] != b"FRHP":
            raise ValueError(f"{f.path}: no fractal heap at {addr}")
        self._f = f
        filter_size = f._u("H", addr + 7)[0]
        self._checksummed = bool(f._buf[addr + 9] & 0x2)  # direct blocks
        if filter_size:
            raise unsupported("filtered fractal heaps")
        # The table's fields follow ten lengths and two addresses.
        o, n = f.offset_size, f.length_size
        p = addr + 14 + 10 * n + 2 * o
        self._width = f._u("H", p)[0]
        self._start, max_direct = f._length(p + 2, 2)
        max_heap_bits = f._u("H", p + 2 + 2 * n)[0]
        root = f._addr(p + 6 + 2 * n)
        rows = f._u("H", p + 6 + 2 * n + o)[0]
        self._offset_size = (max_heap_bits + 7) // 8
        # A block's prefix: signature, version, the heap header's address.
        self._prefix = 5 + o
        self._direct_rows = _log2(max_direct) - _log2(self._start) + 2
        self._blocks = []  # (heap offset, address, size) of each direct block
        if root != UNDEF:
            if rows:
                self._indirect(root, rows)
            else:
                self._direct(root, self._start)
        self._blocks.sort()
        self._starts = [b[0] for b in self._blocks]

    def _direct(self, addr, size):
        f = self._f
        if f._buf[addr:addr + 4] != b"FHDB":
            raise ValueError(f"{f.path}: no fractal heap direct block at {addr}")
        if self._checksummed:
            # The checksum is of the whole block with its own field zeroed.
            at = self._prefix + self._offset_size
            block = bytearray(f._buf[addr:addr + size])
            stored = struct.unpack_from("<I", block, at)[0]
            block[at:at + 4] = bytes(4)
            if lookup3(block) != stored:
                raise ValueError(f"{f.path}: fractal heap direct block at "
                                 f"{addr} fails its checksum (the file is corrupt)")
        self._blocks.append((f._uint(addr + self._prefix, self._offset_size),
                             addr, size))

    def _indirect(self, addr, rows):
        """The direct blocks under the indirect block at `addr`: rows of
        `width` blocks, direct ones of doubling size, then indirect ones."""
        f = self._f
        if f._buf[addr:addr + 4] != b"FHIB":
            raise ValueError(f"{f.path}: no fractal heap indirect block at {addr}")
        p = addr + self._prefix + self._offset_size
        for row in range(rows):
            size = self._start << max(row - 1, 0)
            for child in f._addr(p, self._width):
                if child == UNDEF:
                    continue
                if row < self._direct_rows:
                    self._direct(child, size)
                else:
                    self._indirect(child, _log2(size) - _log2(
                        self._start * self._width) + 1)
            p += f.offset_size * self._width

    def object(self, heap_id: int) -> int:
        """The file offset of the managed object whose heap ID is at
        `heap_id`."""
        f = self._f
        kind = (f._buf[heap_id] >> 4) & 0x3
        if kind:
            raise unsupported(("huge", "tiny", "type 3")[kind - 1]
                              + " fractal heap objects")
        offset = f._uint(heap_id + 1, self._offset_size)
        i = bisect.bisect_right(self._starts, offset) - 1
        if i < 0 or offset >= self._blocks[i][0] + self._blocks[i][2]:
            raise ValueError(f"{f.path}: fractal heap offset {offset} is in "
                             "no direct block")
        start, addr, _ = self._blocks[i]
        return addr + offset - start


class Dataset:
    """One dataset of a `File`: `shape`, `maxshape` (None for an unlimited
    axis), `size`, `ndim`, `dtype` (native byte order), `chunks` (None
    unless chunked), and `ds[sel]` for h5py's basic selections (`ds[()]` is
    the whole array). `inflated_chunks` counts the chunks its reads have
    inflated (through a virtual dataset's sources too), `opened_sources` the
    source files a virtual dataset has opened. It holds its file open."""

    def __init__(self, file: File, addr: int, name: str):
        self._f = file
        self._addr = addr
        self.name = name
        msgs = file._messages(addr)
        for mtype in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT):
            if mtype not in msgs:
                raise ValueError(f"{name}: object header lacks message {mtype}")
        for mtype in (MSG_DATASPACE, MSG_FILL, MSG_FILL_OLD, MSG_LAYOUT,
                      MSG_FILTERS, MSG_EXTERNAL):
            if any(flags & 0x2 for flags, _, _ in msgs.get(mtype, ())):
                raise unsupported(f"shared object header messages (type {mtype})")
        self._index = None  # chunk offset -> storage, read at the first read
        self._lock = threading.Lock()
        self._inflated = 0  # chunks inflated by this object's reads
        self._sources = {}  # a virtual dataset's source datasets, by mapping
        self.opened_sources = 0
        self.shape, maxshape = self._dataspace(msgs[MSG_DATASPACE][0][1])
        self.maxshape = tuple(None if m == UNDEF else m for m in maxshape)
        flags, d, _ = msgs[MSG_DATATYPE][0]
        self._stored, self._bits, self._enum = self._datatype(
            file._shared(d, MSG_DATATYPE) if flags & 0x2 else d)
        self.dtype = _value_type(self._stored, self._enum)
        self._filters = (self._pipeline(msgs[MSG_FILTERS][0][1])
                         if MSG_FILTERS in msgs else [])
        self._fill = self._values(np.array(self._fill_value(msgs),
                                           self._stored))[()]
        self._layout(msgs[MSG_LAYOUT][0][1])
        self._efl = None  # external raw data files: [(name, offset, size)]
        if MSG_EXTERNAL in msgs:
            self._external_files(msgs[MSG_EXTERNAL][0][1])
        if self._layout_class == LAYOUT_VIRTUAL:
            self._mappings = self._resolve_mappings()

    @property
    def inflated_chunks(self) -> int:
        return self._inflated + sum(ds.inflated_chunks
                                    for ds in self._sources.values() if ds)

    def _dataspace(self, d) -> tuple:
        """(dimensions, maximum dimensions; UNDEF where unlimited)."""
        f, buf = self._f, self._f._buf
        version, rank, flags = buf[d], buf[d + 1], buf[d + 2]
        if version == 1:
            p = d + 8
        elif version == 2:
            if buf[d + 3] == 2:
                raise unsupported("null dataspaces")
            p = d + 4
        else:
            raise unsupported(f"dataspace message version {version}")
        dims = f._length(p, rank) if rank else ()
        if flags & 0x1 and rank:
            return dims, f._length(p + f.length_size * rank, rank)
        return dims, dims

    def _datatype(self, d) -> tuple:
        """(the stored type, (bit offset, precision) of an integer type of
        reduced precision, else None, and for an enumeration "bool" where
        h5py reads it as numpy bool, else its members (`_enumeration`),
        else None). An enumeration is stored as its integer base. Floats of
        reduced precision, and enumerations of a reduced-precision base,
        are refused."""
        u, buf = self._f._u, self._f._buf
        cls, bits0 = buf[d] & 0x0F, buf[d + 1]
        size = u("I", d + 4)[0]
        order = ">" if bits0 & 0x1 else "<"
        if cls == DATATYPE_ENUM:
            return self._enumeration(d)
        if cls == 0:
            offset, precision = u("HH", d + 8)
            if size not in (1, 2, 4, 8) or not 0 < precision <= 8 * size - offset:
                raise unsupported(f"{size}-byte fixed-point with precision "
                                  f"{precision} at bit {offset}")
            stored = np.dtype(f"{order}{'i' if bits0 & 0x8 else 'u'}{size}")
            return (stored, None if precision == 8 * size else (offset, precision),
                    None)
        if cls == 1:
            props = u("HHBBBBI", d + 8)
            if (size not in IEEE or bits0 & 0x40 or props[:2] != (0, 8 * size)
                    or props[2:] != IEEE[size] or buf[d + 2] != 8 * size - 1):
                raise unsupported(f"non-IEEE {size}-byte floating point (or "
                                  "reduced precision, as the n-bit filter "
                                  "packs it)")
            return np.dtype(f"{order}f{size}"), None, None
        raise unsupported(f"datatype class {cls} (only integers, IEEE "
                          "floats and enumerations are read)")

    def _enumeration(self, d) -> tuple:
        """`_datatype` of the enumeration at `d`: its base type's message,
        then its member names (NUL-terminated, each padded to 8 bytes before
        version 3), then their values in the base type. Its kind is "bool"
        where the members are h5py's FALSE = 0 and TRUE = 1 (h5py's rule,
        whatever the base), else the ((name, value), ...) members."""
        buf = self._f._buf
        version, count = buf[d] >> 4, self._f._u("H", d + 1)[0]
        stored, bits, _ = self._datatype(d + 8)
        if bits is not None:
            raise unsupported("enumerations of a reduced-precision base")
        p, names = d + 8 + 12, []  # the base: a fixed-point type's message
        for _ in range(count):
            end = self._f._map.find(b"\0", self._f._base + p) - self._f._base
            names.append(bytes(buf[p:end]))
            p = end + 1 if version >= 3 else p + -(-(end + 1 - p) // 8) * 8
        members = tuple(zip(names, np.frombuffer(buf, stored, count,
                                                 offset=p).tolist()))
        return stored, None, "bool" if dict(members) == BOOL_MEMBERS else members

    def _values(self, stored: np.ndarray) -> np.ndarray:
        """Values of the stored type as the dataset's type (`_convert`)."""
        return _convert(stored, self._bits, self._enum)

    def _pipeline(self, d) -> list:
        """The filter pipeline message at `d` as [(filter id, flags, client
        data values)], in the order the filters ran when a chunk was
        written. Filters this reader does not decode raise
        NotImplementedError naming them."""
        u, buf = self._f._u, self._f._buf
        version, count = buf[d], buf[d + 1]
        if version not in (1, 2):
            raise unsupported(f"filter pipeline message version {version}")
        p = d + (8 if version == 1 else 2)
        filters = []
        for _ in range(count):
            fid = u("H", p)[0]
            p += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = u("H", p)[0]
                p += 2
            flags, n_values = u("HH", p)
            p += 4 + name_len
            values = u(f"{n_values}I", p)
            p += 4 * n_values
            if version == 1 and n_values % 2:
                p += 4
            if fid not in FILTER_NAMES:
                raise unsupported(f"filter {fid} (unknown; deflate, shuffle, "
                                  "Fletcher-32, LZF, scale-offset, n-bit and "
                                  "szip are read)")
            if fid == FILTER_NBIT:
                try:
                    hdf5_filters.nbit_check(values, self._stored, self._bits,
                                            packed=self._enum is None)
                except NotImplementedError as e:
                    raise unsupported(str(e)) from None
            filters.append((fid, flags, values))
        return filters

    def _fill_value(self, msgs):
        u, buf = self._f._u, self._f._buf
        value = b""
        if MSG_FILL in msgs:
            d = msgs[MSG_FILL][0][1]
            version = buf[d]
            if version in (1, 2):
                if version == 1 or buf[d + 3]:
                    size = u("I", d + 4)[0]
                    value = buf[d + 8:d + 8 + size]
            elif version == 3:
                if buf[d + 1] & 0x20:
                    size = u("I", d + 2)[0]
                    value = buf[d + 6:d + 6 + size]
            else:
                raise unsupported(f"fill value message version {version}")
        elif MSG_FILL_OLD in msgs:
            d = msgs[MSG_FILL_OLD][0][1]
            size = u("I", d)[0]
            value = buf[d + 4:d + 4 + size]
        if len(value) == self._stored.itemsize:
            return np.frombuffer(value, self._stored)[0]
        return 0

    def _layout(self, d) -> None:
        """Layout message version 3 or 4: compact, contiguous or chunked
        storage; for chunked storage, the chunk shape and the chunk index
        (its type, address, and for a single filtered chunk its size and
        filter mask)."""
        u, buf = self._f._u, self._f._buf
        version, cls = buf[d], buf[d + 1]
        if version not in (3, 4):
            raise unsupported(f"data layout message version {version}")
        self.chunks = None
        f, o = self._f, self._f.offset_size
        self._raw_edges = False  # partial edge chunks stored unfiltered
        if cls == 0:
            self._compact = (d + 4, u("H", d + 2)[0])
        elif cls == 1:
            self._contiguous = (f._addr(d + 2), f._length(d + 2 + o))
        elif cls == 2 and version == 3:
            ndims = buf[d + 2]
            self._index_type, self._index_addr = INDEX_BTREE1, f._addr(d + 3)
            self.chunks = tuple(u(f"{ndims - 1}I", d + 3 + o))
        elif cls == 2:
            flags, ndims, width = buf[d + 2], buf[d + 3], buf[d + 4]
            self._raw_edges = bool(flags & 0x1)
            p = d + 5
            dims = [self._f._uint(p + i * width, width) for i in range(ndims)]
            self.chunks = tuple(dims[:-1])  # the last is the element's size
            self._index_type = buf[p + ndims * width]
            p += ndims * width + 1
            self._single = None  # a single chunk's filtered size and mask
            if self._index_type == INDEX_SINGLE and flags & 0x2:
                self._single = (f._length(p), u("I", p + f.length_size)[0])
                p += f.length_size + 4
            elif self._index_type == INDEX_FIXED_ARRAY:
                p += 1
            elif self._index_type == INDEX_EXTENSIBLE_ARRAY:
                p += 5
            elif self._index_type == INDEX_BTREE2:
                p += 6
            elif self._index_type not in (INDEX_SINGLE, INDEX_IMPLICIT):
                raise unsupported(f"chunk index type {self._index_type}")
            self._index_addr = f._addr(p)
        elif cls == LAYOUT_VIRTUAL and version == 4:
            heap, index = f._addr(d + 2), u("I", d + 2 + o)[0]
            self._stored_mappings = self._virtual_mappings(
                self._f._global_heap_object(heap, index))
        else:
            raise unsupported(f"data layout class {cls} (message version "
                              f"{version})")
        self._layout_class = cls

    def _external_files(self, d) -> None:
        """The external file list message at `d`: the raw data lie, one
        segment after another, in files named in a local heap. A relative
        name is taken under $HDF5_EXTFILE_PREFIX (``${ORIGIN}`` at its start
        is this file's directory), or else in the working directory, as the
        library does (H5D__build_file_prefix, H5_combine_path)."""
        f = self._f
        version, n_used, heap = f._buf[d], f._u("H", d + 6)[0], f._addr(d + 8)
        if version != 1:
            raise unsupported(f"external file list message version {version}")
        if self._layout_class != LAYOUT_CONTIGUOUS:
            raise ValueError(f"{self.name}: external storage of a layout of "
                             f"class {self._layout_class}")
        names = f._local_heap_data(heap)
        prefix = os.environ.get(EXTFILE_PREFIX_ENV, "")
        if prefix.startswith(ORIGIN):
            prefix = str(f._dir) + os.sep + prefix[len(ORIGIN):]
        self._efl = []
        for i in range(n_used):
            # Each slot: the name's heap offset, the offset in the file and
            # the size, three lengths.
            name_off, offset, size = f._length(
                d + 8 + f.offset_size + 3 * f.length_size * i, 3)
            name = f._cstring(names + name_off)
            if prefix and prefix != "." and not os.path.isabs(name):
                name = os.path.join(prefix, name)
            self._efl.append((name, offset, size))

    def _virtual_mappings(self, blob: bytes) -> list:
        """A virtual dataset's mappings from their global heap object: a
        version byte, a count, then per mapping the source file's and
        dataset's names and the source and virtual selections; last, a
        lookup3 checksum of the rest; the count is a length. Returns
        [(file name parts, dataset name parts, source selection, virtual
        selection)] (see `_name_parts` and `_parse_selection`)."""
        if len(blob) < 13 or lookup3(blob[:-4]) != struct.unpack_from(
                "<I", blob, len(blob) - 4)[0]:
            raise ValueError(f"{self._f.path}: {self.name}: the virtual dataset's "
                             "mappings fail their checksum (the file is corrupt)")
        if blob[0] != VDS_HEAP_VERSION:
            raise unsupported(f"virtual dataset mapping encoding version {blob[0]}")
        size = self._f.length_size
        count = int.from_bytes(blob[1:1 + size], "little")
        p, mappings = 1 + size, []
        for _ in range(count):
            names = []
            for _ in range(2):
                end = blob.index(b"\0", p)
                names.append(_name_parts(blob[p:end].decode()))
                p = end + 1
            source, p = _parse_selection(blob, p)
            virtual, p = _parse_selection(blob, p)
            mappings.append((*names, source, virtual))
        return mappings

    def _resolve_mappings(self) -> list:
        """The `_Mapping`s of a virtual dataset as the library resolves them
        when it opens the dataset, under its default view
        (H5D_VDS_LAST_AVAILABLE, printf gap `VDS_PRINTF_GAP`). An unlimited
        mapping (`layout[0:UNLIMITED] = source[0:UNLIMITED]`) takes as
        many slices as its source holds now: none if the source is missing.
        A printf-style mapping (a %b in a name) takes block b from the
        source named with b, for b = 0, 1, ... while the blocks are found,
        a gap of `VDS_PRINTF_GAP` missing ones allowed; a block within that
        run whose source is missing keeps the fill value. Each unlimited
        dimension's extent is the furthest that its unlimited mappings
        reach, and at least what the other mappings need; it replaces the
        stored one in `shape`."""
        key = (os.path.abspath(self._f.path), self._addr)
        opening = _OPENING.__dict__.setdefault("keys", set())
        if key in opening:
            raise ValueError(f"{self._f.path}: {self.name}: an unlimited "
                             "virtual dataset mapping's source is the dataset "
                             "itself (a cycle)")
        opening.add(key)
        try:
            resolved, reach, least = [], {}, [0] * len(self.shape)
            for files, datasets, source, virtual in self._stored_mappings:
                dim = _unlimited_dim(virtual)
                for d, end in enumerate(_bounds_end(virtual, self.shape)):
                    if d != dim:
                        least[d] = max(least[d], end)
                if dim is None:
                    if len(files) > 1 or len(datasets) > 1:
                        raise ValueError(f"{self.name}: a printf-style (%b) "
                                         "mapping of a limited selection")
                    resolved.append((files[0], datasets[0], source, virtual, None))
                    continue
                _, start, stride, count, block = virtual
                if len(files) > 1 or len(datasets) > 1:
                    if count[dim] >= 0:
                        raise ValueError(f"{self.name}: a printf-style (%b) "
                                         "mapping whose blocks are unlimited")
                    found, b = 0, 0
                    while b <= VDS_PRINTF_GAP + found:
                        if self._named_source(str(b).join(files),
                                              str(b).join(datasets)) is not None:
                            found = b + 1
                        b += 1
                    for b in range(found):
                        one = count.copy()
                        one[dim] = 1
                        at = start.copy()
                        at[dim] += b * stride[dim]
                        resolved.append((str(b).join(files), str(b).join(datasets),
                                         source, ("regular", at, stride, one, block),
                                         None))
                    end = (start[dim] + (found - 1) * stride[dim] + block[dim]
                           if found else 0)
                else:
                    src = self._named_source(files[0], datasets[0])
                    slices = 0
                    if src is not None:
                        src_dim = _unlimited_dim(source)
                        if src_dim is None:
                            raise ValueError(f"{self.name}: an unlimited virtual "
                                             "selection mapped to a limited one")
                        slices = len(_Selection(source, src.shape).axes[src_dim])
                    resolved.append((files[0], datasets[0], source, virtual, slices))
                    end = _clip_extent(start[dim], stride[dim], block[dim], slices)
                reach[dim] = max(reach.get(dim, 0), end)
        finally:
            opening.discard(key)
        self.shape = tuple(max(least[d], reach[d]) if d in reach else n
                           for d, n in enumerate(self.shape))
        return [_Mapping(file_name, dataset_name, source,
                         _Selection(virtual, self.shape, slices))
                for file_name, dataset_name, source, virtual, slices in resolved]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def attrs(self) -> dict:
        """{name: value} of the attributes in the dataset's object header."""
        msgs = self._f._messages(self._addr)
        for _, d, _ in msgs.get(MSG_ATTRIBUTE_INFO, ()):
            flags = self._f._buf[d + 1]
            heap = self._f._addr(d + 2 + (2 if flags & 0x1 else 0))
            if heap != UNDEF:
                raise unsupported("dense attribute storage")
        out = {}
        for flags, d, _ in msgs.get(MSG_ATTRIBUTE, ()):
            if flags & 0x2:
                raise unsupported("shared attribute messages")
            name, value = self._attribute(d)
            out[name] = value
        return out

    def _attribute(self, d) -> tuple:
        """(name, value) of the attribute message at `d`: versions 1 (its
        fields padded to 8 bytes), 2 and 3 (a name encoding byte)."""
        buf, u = self._f._buf, self._f._u
        version, flags = buf[d], buf[d + 1]
        name_size, dt_size, ds_size = u("HHH", d + 2)
        if version == 1:
            p, pad = d + 8, lambda n: -(-n // 8) * 8
        elif version in (2, 3):
            if flags & 0x2:
                raise unsupported("attributes of shared dataspaces")
            p, pad = d + 8 + (version == 3), lambda n: n
        else:
            raise unsupported(f"attribute message version {version}")
        name = bytes(buf[p:p + name_size - 1]).decode()
        p += pad(name_size)
        dtype, bits, enum = self._datatype(
            self._f._shared(p, MSG_DATATYPE) if version > 1 and flags & 0x1 else p)
        p += pad(dt_size)
        shape, _ = self._dataspace(p)
        p += pad(ds_size)
        value = _convert(np.frombuffer(buf, dtype, math.prod(shape), offset=p),
                         bits, enum)
        value = value.astype(_value_type(dtype, enum)).reshape(shape)
        return name, value[()] if shape == () else value

    def _selection(self, key):
        """h5py's basic selection: ([(start, stop)] a dimension, the
        result's shape). `key` is (), Ellipsis, or an int, a step-1 slice or
        a tuple of them, negative and empty ranges as numpy takes them."""
        if key is Ellipsis:
            key = ()
        elif not isinstance(key, tuple):
            key = (key,)
        if len(key) > len(self.shape):
            raise ValueError(
                f"{len(key)} indexing arguments for {len(self.shape)} dimensions")
        ranges, shape = [], []
        for dim, size in enumerate(self.shape):
            k = key[dim] if dim < len(key) else slice(None)
            if isinstance(k, slice):
                if k.step not in (None, 1):
                    raise unsupported(f"selections with a step ({k.step}) other "
                                      "than 1")
                start, stop, _ = k.indices(size)
                stop = max(start, stop)
                ranges.append((start, stop))
                shape.append(stop - start)
            elif isinstance(k, (int, np.integer)) and not isinstance(
                    k, (bool, np.bool_)):
                i = int(k) + size if k < 0 else int(k)
                if not 0 <= i < size:
                    raise IndexError(f"Index ({k}) out of range for (0-{size - 1})")
                ranges.append((i, i + 1))
            elif k is Ellipsis:
                raise unsupported("Ellipsis inside a selection tuple")
            else:
                raise unsupported(f"fancy or boolean indexing ({type(k).__name__} "
                                  "in a selection)")
        return ranges, tuple(shape)

    def __getitem__(self, key):
        """The selection `key` (see `_selection`) as a new native-order
        array, or a numpy scalar when every dimension takes an int, as
        h5py's ``ds[key]`` returns it. A chunked dataset inflates only the
        chunks that meet the selection, a virtual one reads only the
        mappings that meet it; contiguous, compact and external ones read
        only the selected bytes."""
        ranges, shape = self._selection(key)
        out = self._read(ranges).reshape(shape)
        return out[()] if not shape else out

    def _read(self, ranges) -> np.ndarray:
        """The box `ranges` [(start, stop)] a dimension. Every chunk to
        inflate and every copy, through any depth of virtual datasets, is
        one job of a single flat thread pool (zlib releases the GIL); the
        steps that gather a virtual dataset's sources run after them, the
        innermost first."""
        full = tuple(b - a for a, b in ranges)
        if 0 in full:
            return np.empty(full, self.dtype)
        out = np.full(full, self._fill, self.dtype)
        jobs, after = [], []
        self._plan(ranges, out, jobs, after, 0)
        if len(jobs) == 1:
            jobs[0]()
        elif jobs:
            with ThreadPoolExecutor() as pool:
                for future in [pool.submit(job) for job in jobs]:
                    future.result()
        for step in after:
            step()
        return out

    def _plan(self, ranges, out, jobs, after, depth) -> None:
        """Add to `jobs` (independent) and `after` (in order, once the jobs
        are done) what fills `out`, which holds the fill value, with the box
        `ranges` of this dataset."""
        region = tuple(slice(a, b) for a, b in ranges)
        if self._layout_class == LAYOUT_CHUNKED:
            self._plan_chunks(ranges, out, jobs)
        elif self._layout_class == LAYOUT_VIRTUAL:
            self._plan_virtual(ranges, out, jobs, after, depth)
        elif self._efl is not None:
            jobs.append(lambda: out.__setitem__(
                ..., self._values(self._read_external(ranges))))
        else:
            addr = (self._compact[0] if self._layout_class == LAYOUT_COMPACT
                    else self._contiguous[0])
            if addr != UNDEF:  # else never written: the fill value

                def copy():
                    stored = np.frombuffer(self._f._buf, self._stored,
                                           count=self.size, offset=addr)
                    out[...] = self._values(stored.reshape(self.shape)[region])

                jobs.append(copy)

    def _read_external(self, ranges) -> np.ndarray:
        """The box `ranges` of a dataset in external raw data files: the
        bytes from its first element to its last, read from the segments
        that hold them (a short file reads as zeros, a missing one raises
        OSError, as the library does), seen through the dataset's strides."""
        itemsize = self._stored.itemsize
        strides = [itemsize * math.prod(self.shape[d + 1:])
                   for d in range(len(self.shape))]
        lo = sum(a * st for (a, _), st in zip(ranges, strides))
        hi = sum((b - 1) * st for (_, b), st in zip(ranges, strides)) + itemsize
        raw = bytearray(hi - lo)
        view, start = memoryview(raw), 0
        for name, offset, size in self._efl:
            end = UNDEF if size == UNDEF else start + size
            if start < hi and end > lo:
                a, b = max(lo, start), min(hi, end)
                with open(name, "rb") as f:
                    f.seek(offset + a - start)
                    f.readinto(view[a - lo:b - lo])
            start = end
            if start >= hi:
                break
        else:
            raise ValueError(f"{self.name}: the read passes the end of the "
                             "external raw data files")
        return np.ndarray(tuple(b - a for a, b in ranges), self._stored, raw,
                          strides=strides)

    def _plan_chunks(self, ranges, out, jobs) -> None:
        """The written chunks that meet the box `ranges`, each inflated and
        placed by one job; the rest of the box keeps the fill value."""
        chunks, index = self.chunks, self._chunk_index()
        grid = itertools.product(*(range(a - a % c, b, c)
                                   for (a, b), c in zip(ranges, chunks)))
        hits = [(offset, index[offset]) for offset in grid if offset in index]

        def place(offset, entry):
            partial = any(o + c > n for o, c, n in zip(offset, chunks, self.shape))
            block = self._values(self._inflate(
                *entry, unfiltered=self._raw_edges and partial))
            src, dst = [], []
            for o, c, (a, b) in zip(offset, chunks, ranges):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = block[tuple(src)]

        with self._lock:
            self._inflated += len(hits)
        jobs.extend(functools.partial(place, *hit) for hit in hits)

    def _plan_virtual(self, ranges, out, jobs, after, depth) -> None:
        """Each mapping whose virtual selection meets the box `ranges`:
        its source's box is read into a buffer (holding the source's fill
        value) by the source's own plan, then gathered into `out` in mapping
        order (a later mapping wins where two overlap). A mapping whose
        source file or dataset is missing leaves the fill value."""
        if depth >= MAX_VDS_DEPTH:
            raise ValueError(f"{self._f.path}: {self.name}: virtual dataset "
                             f"sources nest deeper than {MAX_VDS_DEPTH} (a cycle?)")
        for i, m in enumerate(self._mappings):
            inside = m.virtual.inside(ranges)
            if inside is None:
                continue
            source = self._source(i)
            if source is None:
                continue
            dst, src, pointwise = m.pairs(inside, ranges, source.shape)
            box = [(int(c.min()), int(c.max()) + 1) for c in src]
            buffer = np.full(tuple(b - a for a, b in box), source._fill,
                             source.dtype)
            source._plan(box, buffer, jobs, after, depth + 1)
            src = [c - a for c, (a, _) in zip(src, box)]
            after.append(functools.partial(
                _gather, out, dst, buffer, src, pointwise,
                _conversion(source, self)))

    def _source(self, i: int):
        """The source dataset of mapping `i`, opened once a dataset: None
        when its file or its dataset is missing, as the library then leaves
        the mapping's region to the fill value."""
        m = self._mappings[i]
        return self._named_source(m.file_name, m.dataset_name)

    def _named_source(self, file_name: str, dataset_name: str):
        key = (file_name, dataset_name)
        with self._lock:
            if key not in self._sources:
                self._sources[key] = self._open_source(*key)
            return self._sources[key]

    def _open_source(self, file_name: str, dataset_name: str):
        if file_name == ".":
            f = self._f
        else:
            self.opened_sources += 1
            f = self._f._other_file(file_name, VDS_PREFIX_ENV)
            if f is None:
                return None
        try:
            source = f[dataset_name]
        except (KeyError, TypeError):
            return None
        _conversion(source, self)  # refuses what is not read
        return source

    def _chunk_index(self) -> dict:
        """{chunk offset: (address, stored bytes, filter mask)} of every
        written chunk, from one walk of the chunk index."""
        with self._lock:
            if self._index is None:
                self._index = self._walk_chunk_index()
        return self._index

    def _walk_chunk_index(self) -> dict:
        f, rank, addr = self._f, len(self.shape), self._index_addr
        chunk_bytes = math.prod(self.chunks) * self._stored.itemsize
        index = {}
        if addr == UNDEF:  # no chunk was ever written
            return index
        if self._index_type == INDEX_BTREE1:
            for key, chunk in f._btree_children(addr, 1, 8 + 8 * (rank + 1)):
                nbytes, mask = f._u("II", key)
                index[f._u(f"{rank}Q", key + 8)] = (chunk, nbytes, mask)
        elif self._index_type == INDEX_SINGLE:
            nbytes, mask = self._single or (chunk_bytes, 0)
            index[(0,) * rank] = (addr, nbytes, mask)
        elif self._index_type == INDEX_IMPLICIT:
            # Every chunk is allocated, in order over the maximal chunk grid.
            for scaled in itertools.product(*(range(-(-s // c)) for s, c in
                                              zip(self.shape, self.chunks))):
                i = self._linear_index(scaled)
                index[self._offset(scaled)] = (addr + i * chunk_bytes,
                                               chunk_bytes, 0)
        elif self._index_type == INDEX_BTREE2:
            index = self._btree2_chunks(addr, chunk_bytes)
        else:
            entry, filtered, elements = (
                self._fixed_array(addr)
                if self._index_type == INDEX_FIXED_ARRAY
                else self._extensible_array(addr))
            # An entry: the chunk's address, then for filtered chunks its
            # size and filter mask.
            o = f.offset_size
            size_width = entry - o - 4 if filtered else 0
            for i, e in elements:
                chunk = f._addr(e)
                if chunk == UNDEF:
                    continue
                stored = ((f._uint(e + o, size_width), f._u("I", e + o + size_width)[0])
                          if filtered else (chunk_bytes, 0))
                index[self._offset(self._scaled(i))] = (chunk, *stored)
        return index

    def _offset(self, scaled) -> tuple:
        return tuple(s * c for s, c in zip(scaled, self.chunks))

    def _chunk_grid(self):
        """The dimensions in the order the array and implicit indexes
        number chunks, slowest first, with the chunk count of each over the
        maximal shape: an extensible array puts its unlimited dimension
        first (the library's swizzled order)."""
        counts = [None if m is None else -(-m // c)
                  for m, c in zip(self.maxshape, self.chunks)]
        order = list(range(len(counts)))
        if None in counts:
            unlimited = counts.index(None)
            order.remove(unlimited)
            order.insert(0, unlimited)
        return order, counts

    def _linear_index(self, scaled) -> int:
        order, counts = self._chunk_grid()
        i = 0
        for d in order:
            i = i * (counts[d] or 1) + scaled[d]
        return i

    def _scaled(self, i: int) -> tuple:
        """The chunk coordinates of element `i` of an array index."""
        order, counts = self._chunk_grid()
        scaled = [0] * len(counts)
        for d in reversed(order[1:]):
            i, scaled[d] = divmod(i, counts[d])
        scaled[order[0]] = i
        return tuple(scaled)

    def _bit(self, bitmap: int, k: int) -> bool:
        """Bit `k` of the page bitmap at `bitmap` (first bit the highest)."""
        return bool(self._f._buf[bitmap + k // 8] & (0x80 >> (k % 8)))

    def _fixed_array(self, addr):
        """(entry size, filtered, [(index, entry offset)]) of a fixed array
        (`FAHD`): its data block holds the entries, in pages of 2^bits
        entries once there are more than that; an uninitialised page holds
        no chunk."""
        f = self._f
        if f._buf[addr:addr + 4] != b"FAHD":
            raise ValueError(f"{f.path}: no fixed array header at {addr}")
        n, block = f._length(addr + 8), f._addr(addr + 8 + f.length_size)
        f._verify(addr, addr + 8 + f.length_size + f.offset_size,
                  "fixed array header")
        filtered, entry, page_bits = f._buf[addr + 5:addr + 8]
        if f._buf[block:block + 4] != b"FADB":
            raise ValueError(f"{f.path}: no fixed array data block at {block}")
        page = 1 << page_bits
        start = block + 6 + f.offset_size  # past the header's address
        if n <= page:
            f._verify(block, start + n * entry, "fixed array data block")
            return entry, filtered, [(i, start + i * entry) for i in range(n)]
        pages = -(-n // page)
        p = start + (pages + 7) // 8
        f._verify(block, p, "fixed array data block")
        p += 4
        elements = []
        for k in range(pages):
            count = min(page, n - k * page)
            if self._bit(start, k):
                f._verify(p, p + count * entry, "fixed array data block page")
                elements += [(k * page + i, p + i * entry) for i in range(count)]
            p += count * entry + 4
        return entry, filtered, elements

    def _extensible_array(self, addr):
        """(entry size, filtered, [(index, entry offset)]) of an extensible
        array (`EAHD`): the index block holds the first entries, then the
        addresses of the first data blocks and of the super blocks that hold
        the addresses of the rest. Super block s has 2^(s/2) data blocks of
        m 2^((s+1)/2) entries (the library's H5EAhdr.c); a data block longer
        than a page is paged, and its super block says which pages were
        initialised."""
        f, buf = self._f, self._f._buf
        if buf[addr:addr + 4] != b"EAHD":
            raise ValueError(f"{f.path}: no extensible array header at {addr}")
        (filtered, entry, max_bits, iblock_entries, min_entries, min_pointers,
         page_bits) = buf[addr + 5:addr + 12]
        # Six lengths (the last two the highest index set plus 1 and the
        # elements realised), then the index block's address.
        n, o = f.length_size, f.offset_size
        f._verify(addr, addr + 12 + 6 * n + o, "extensible array header")
        used = f._length(addr + 12 + 4 * n)
        iblock = f._addr(addr + 12 + 6 * n)
        if iblock == UNDEF:
            return entry, filtered, []
        if buf[iblock:iblock + 4] != b"EAIB":
            raise ValueError(f"{f.path}: no extensible array index block at {iblock}")
        page = 1 << page_bits
        # A block's prefix: signature, version, client, the header's
        # address and, in a data or super block, its offset in the array.
        prefix = 6 + o + (max_bits + 7) // 8
        n_super = 1 + max_bits - _log2(min_entries)
        in_iblock = 2 * _log2(min_pointers)  # super blocks the index block holds
        p = iblock + 6 + o
        elements = [(i, p + i * entry) for i in range(min(iblock_entries, used))]
        p += iblock_entries * entry
        n_dblocks = 2 * (min_pointers - 1)
        dblocks = f._addr(p, n_dblocks)
        sblocks = f._addr(p + o * n_dblocks, n_super - in_iblock)
        f._verify(iblock, p + o * (n_dblocks + n_super - in_iblock),
                  "extensible array index block")

        def data_block(dblock, first, count, initialised):
            if buf[dblock:dblock + 4] != b"EADB":
                raise ValueError(f"{f.path}: no extensible array data block at {dblock}")
            if count <= page:
                f._verify(dblock, dblock + prefix + count * entry,
                          "extensible array data block")
                elements.extend((first + i, dblock + prefix + i * entry)
                                for i in range(min(count, used - first)))
                return
            if initialised is None:
                raise unsupported("paged data blocks in an extensible array's "
                                  "index block")
            f._verify(dblock, dblock + prefix, "extensible array data block")
            q = dblock + prefix + 4
            for k in range(count // page):
                if initialised(k):
                    f._verify(q, q + page * entry, "extensible array data block page")
                    elements.extend((first + k * page + i, q + i * entry)
                                    for i in range(min(page, used - first - k * page)))
                q += page * entry + 4

        first, dblock_index = iblock_entries, 0
        for s in range(n_super):
            if first >= used:
                break
            n_blocks, count = 1 << (s // 2), min_entries << ((s + 1) // 2)
            if s < in_iblock:
                for j in range(n_blocks):
                    if dblocks[dblock_index + j] != UNDEF:
                        data_block(dblocks[dblock_index + j], first + j * count,
                                   count, None)
                dblock_index += n_blocks
            elif sblocks[s - in_iblock] != UNDEF:
                sblock = sblocks[s - in_iblock]
                if buf[sblock:sblock + 4] != b"EASB":
                    raise ValueError(f"{f.path}: no extensible array super "
                                     f"block at {sblock}")
                # One bit a page, data block after data block, in bytes
                # sized for each data block's pages.
                pages = count // page if count > page else 0
                q = sblock + prefix + n_blocks * ((pages + 7) // 8)
                f._verify(sblock, q + o * n_blocks, "extensible array super block")
                for j, dblock in enumerate(f._addr(q, n_blocks)):
                    if dblock != UNDEF:
                        data_block(dblock, first + j * count, count,
                                   lambda k, j=j: self._bit(sblock + prefix,
                                                            j * pages + k))
            first += n_blocks * count
        return entry, filtered, elements

    def _btree2_chunks(self, addr, chunk_bytes) -> dict:
        """The chunks of a version 2 B-tree index: records of an address,
        for filtered chunks their size and filter mask, then the chunk's
        coordinates in chunks."""
        f, rank = self._f, len(self.shape)
        filtered = bool(self._filters)
        record_type = BTREE2_FILTERED_CHUNKS if filtered else BTREE2_CHUNKS
        record_size, records = f._btree2_records(addr, record_type)
        o = f.offset_size
        size_width = record_size - o - 4 - 8 * rank if filtered else 0
        index = {}
        for r in records:
            chunk = f._addr(r)
            stored = ((f._uint(r + o, size_width), f._u("I", r + o + size_width)[0])
                      if filtered else (chunk_bytes, 0))
            scaled = f._u(f"{rank}Q", r + record_size - 8 * rank)
            index[self._offset(scaled)] = (chunk, *stored)
        return index

    def _inflate(self, addr, nbytes, mask, unfiltered=False) -> np.ndarray:
        """One stored chunk, unfiltered, as a (chunks) array of the stored
        type (a read-only view of the decoded bytes). The filters run in
        reverse, each skipped where the chunk's filter mask says the writer
        skipped it (as an optional filter that failed, such as LZF on a
        chunk it cannot shrink), and all of them, Fletcher-32 too, for an
        `unfiltered` chunk (a partial edge chunk under chunk option flag 1,
        which the library stores raw whatever its mask says). A Fletcher-32
        checksum that does not match, or a corrupt stream, raises
        ValueError."""
        raw = self._f._buf[addr:addr + nbytes]
        if unfiltered:
            if nbytes != math.prod(self.chunks) * self._stored.itemsize:
                raise ValueError(f"{self._f.path}: {self.name}: the unfiltered "
                                 f"edge chunk at {addr} holds {nbytes} bytes")
            return np.frombuffer(raw, self._stored).reshape(self.chunks)
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, _flags, values = self._filters[i]
            if fid == FILTER_SHUFFLE:
                raw = _unshuffle(raw, values[0] if values else self._stored.itemsize)
            elif fid == FILTER_FLETCHER32:
                raw = self._fletcher32_checked(raw, addr)
            else:
                try:
                    if fid == FILTER_NBIT:
                        raw = hdf5_filters.nbit_decode(raw, values, self._stored)
                    elif fid == FILTER_DEFLATE:
                        raw = zlib.decompress(raw)
                    elif fid == FILTER_LZF:
                        raw = hdf5_filters.lzf_decode(raw)
                    elif fid == FILTER_SZIP:
                        raw = hdf5_filters.szip_decode(raw, values, self._stored)
                    else:
                        raw = hdf5_filters.scaleoffset_decode(raw, values,
                                                              self._stored)
                except NotImplementedError as e:
                    raise unsupported(str(e)) from None
                except (zlib.error, ValueError) as e:
                    raise ValueError(f"{self._f.path}: {self.name}: the chunk "
                                     f"at {addr} does not decode ({e})") from None
        return np.frombuffer(raw, self._stored).reshape(self.chunks)

    def _fletcher32_checked(self, raw, addr):
        """`raw` without its trailing Fletcher-32 checksum, once checked. As
        the library does, the checksum with the bytes of each 16-bit half
        swapped (written by HDF5 before 1.6.3) is taken too."""
        body = raw[:len(raw) - 4]
        stored = struct.unpack_from("<I", raw, len(raw) - 4)[0]
        got = fletcher32(body)
        swapped = ((got & 0x00FF00FF) << 8) | ((got >> 8) & 0x00FF00FF)
        if stored not in (got, swapped):
            raise ValueError(f"{self._f.path}: {self.name}: the chunk at {addr} "
                             "fails its Fletcher-32 checksum (data error)")
        return body


def _reduced(stored: np.ndarray, offset: int, precision: int) -> np.ndarray:
    """Integers of a reduced-precision type as the library converts them to
    the full-width type of their size (H5T__conv_i_i): the `precision` bits
    from bit `offset`, sign-extended for a signed type; the padding bits
    around them are dropped."""
    native = stored.dtype.newbyteorder("=")
    bits = 8 * native.itemsize
    unsigned = stored.astype(native).view(f"u{native.itemsize}")
    value = (unsigned >> offset) & np.array((1 << precision) - 1, unsigned.dtype)
    if native.kind == "i" and precision < bits:
        sign = np.array(1 << (precision - 1), unsigned.dtype)
        value = (value ^ sign) - sign  # wraps: the sign bit extended
    return value.view(native)


def _value_type(stored: np.dtype, enum) -> np.dtype:
    """The type a read returns for values stored as `stored` (`enum` as
    `Dataset._datatype` gives it): numpy bool for h5py's booleans, else
    the stored type in native byte order."""
    return np.dtype(np.bool_) if enum == "bool" else stored.newbyteorder("=")


def _convert(stored: np.ndarray, bits, enum) -> np.ndarray:
    """Values of the stored type as a read returns them: as they are at
    full precision (an enumeration as its base); a reduced-precision
    integer as the library converts it (`_reduced`); h5py's booleans as
    h5py reads them. On a 1-byte signed base, h5py's own boolean type, its
    bytes are taken as they are; any other base the library converts
    member by member to that type, 0 and 1 staying and every value that is
    no member becoming 0xFF."""
    if bits is not None:
        return _reduced(stored, *bits)
    if enum != "bool":
        return stored
    if stored.dtype.itemsize == 1 and stored.dtype.kind == "i":
        return stored.view(np.bool_)
    out = np.where(stored > 1, 0xFF, stored).astype(np.uint8)
    out[stored < 0] = 0xFF
    return out.view(np.bool_)


def _unshuffle(raw, size: int):
    """Undo the shuffle filter (H5Z__filter_shuffle): the first n * size
    bytes hold byte 0 of every element, then byte 1, and so on; bytes past
    the last whole element are as they were."""
    n = len(raw) // size
    if size <= 1 or n <= 1:
        return raw
    body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
    return body + bytes(raw[n * size:])


def _name_parts(name: str) -> tuple:
    """A mapping's source file or dataset name as the library parses it:
    its printf-style escapes undone ("%%" is "%"), cut at each "%b" (the
    block number of a printf-style mapping), so that
    ``str(b).join(parts)`` names block b's source."""
    parts, literal, i = [], [], 0
    while (j := name.find("%", i)) >= 0:
        literal.append(name[i:j])
        spec = name[j + 1:j + 2]
        if spec == "b":
            parts.append("".join(literal))
            literal = []
        elif spec == "%":
            literal.append("%")
        else:
            raise ValueError(f"invalid format specifier in the virtual dataset "
                             f"source name {name!r}")
        i = j + 2
    return (*parts, "".join(literal) + name[i:])


def _unlimited_dim(raw):
    """The dimension in which a parsed selection is unlimited, or None."""
    if raw[0] != "regular":
        return None
    unlimited = np.flatnonzero((raw[3] < 0) | (raw[4] < 0))
    if len(unlimited) > 1:
        raise ValueError("a selection unlimited in more than one dimension")
    return int(unlimited[0]) if len(unlimited) else None


def _bounds_end(raw, extent) -> list:
    """1 + the last index a parsed selection takes in each dimension (of
    an unlimited dimension, its first block's)."""
    if raw[0] == "all":
        return list(extent)
    if raw[0] == "blocks":
        ends = raw[2].max(axis=0) if len(raw[2]) else np.full(len(extent), -1)
        return [int(e) + 1 for e in ends]
    _, start, stride, count, block = raw
    return [int(s + max(c - 1, 0) * st + max(b, 1)) for s, st, c, b in
            zip(start, stride, count, block)]


def _clip_extent(start: int, stride: int, block: int, slices: int) -> int:
    """The extent of an unlimited dimension that holds the first `slices`
    indices of a virtual selection (H5S__hyper_get_clip_extent_real, not
    counting the space after the last block)."""
    if slices == 0:
        return 0
    if block < 0 or block == stride:
        return start + slices
    blocks, rest = divmod(slices, block)
    if rest:
        return start + blocks * stride + rest
    return start + (blocks - 1) * stride + block


def _regular_axis(start, stride, count, block, extent, slices=None):
    """The indices a regular hyperslab takes along one dimension, in order.
    An unlimited count or block (-1) takes them up to `extent`, or only the
    first `slices` of them."""
    if count >= 0 and block >= 0:
        return (start + np.arange(count)[:, None] * stride + np.arange(block)).ravel()
    if block < 0:
        return start + np.arange(max(0, extent - start) if slices is None else slices)
    if slices is None:
        blocks = max(0, -(-(extent - start) // stride))
    else:
        blocks = -(-slices // block)
    axis = (start + np.arange(blocks)[:, None] * stride + np.arange(block)).ravel()
    return axis[axis < extent] if slices is None else axis[:slices]


def _parse_selection(blob: bytes, p: int) -> tuple:
    """The serialised selection at `p` of `blob` and the offset past it:
    ("all",), ("regular", start, stride, count, block) with an array of
    each a dimension (a count or block of -1 is unlimited), or ("blocks",
    starts, ends) with an array (blocks, rank) of each, ends inclusive.
    Hyperslabs come in version 1 (blocks, 4-byte numbers), 2 (regular,
    8-byte) and 3 (either, 2, 4 or 8 bytes)."""
    kind, version = struct.unpack_from("<II", blob, p)
    p += 8
    if kind == SEL_ALL and version == 1:
        return ("all",), p + 8
    if kind == SEL_POINTS:
        raise unsupported("point selections in virtual dataset mappings")
    if kind != SEL_HYPERSLABS:
        raise unsupported(f"selections of type {kind} (version {version}) in "
                          "virtual dataset mappings")
    if version == 1:
        rank, n = struct.unpack_from("<8xII", blob, p)
        p, flags, size = p + 16, 0, 4
    elif version == 2:
        flags, rank = struct.unpack_from("<B4xI", blob, p)
        p, size = p + 9, 8
        if not flags & HYPER_REGULAR:
            raise unsupported("irregular hyperslab selections of encoding "
                              "version 2")
    elif version == 3:
        flags, size, rank = struct.unpack_from("<BBI", blob, p)
        p += 6
        if size not in (2, 4, 8):
            raise ValueError(f"a hyperslab selection in {size}-byte numbers")
    else:
        raise unsupported(f"hyperslab selection encoding version {version}")
    code = f"<u{size}"
    if flags & HYPER_REGULAR:
        raw = np.frombuffer(blob, code, 4 * rank, p).reshape(rank, 4)
        values = raw.astype(np.int64)
        values[:, 2:][raw[:, 2:] == np.iinfo(code).max] = -1  # unlimited
        return ("regular", *values.T), p + 4 * rank * size
    if version == 3:
        n = int.from_bytes(blob[p:p + size], "little")
        p += size
    coords = np.frombuffer(blob, code, 2 * rank * n, p).astype(np.int64)
    coords = coords.reshape(n, 2, rank)
    return ("blocks", coords[:, 0], coords[:, 1]), p + 2 * rank * n * size


class _Selection:
    """A selection of an extent's points, in the order the library pairs
    them (row-major): a product of sorted index arrays, one a dimension
    (`axes`), or else sorted flat indices (`flat`). An unlimited dimension
    takes the indices below the extent, or its first `slices`."""

    def __init__(self, raw: tuple, extent, slices=None):
        self.extent = tuple(int(n) for n in extent)
        self.axes = self.flat = None
        rank = len(self.extent)
        if raw[0] == "all":
            self.axes = [np.arange(n) for n in self.extent]
        elif raw[0] == "regular":
            _, start, stride, count, block = raw
            if len(start) != rank:
                raise ValueError(f"a rank {len(start)} selection of a rank "
                                 f"{rank} extent")
            self.axes = [_regular_axis(*dim, slices) for dim in
                         zip(start, stride, count, block, self.extent)]
        else:
            _, starts, ends = raw
            if starts.shape[1] != rank:
                raise ValueError(f"a rank {starts.shape[1]} selection of a rank "
                                 f"{rank} extent")
            self.axes = self._product(starts, ends)
            if self.axes is None:
                strides = [math.prod(self.extent[d + 1:]) for d in range(rank)]
                self.flat = np.unique(np.concatenate([
                    sum(np.arange(lo[d], hi[d] + 1).reshape(
                        [-1 if e == d else 1 for e in range(rank)]) * strides[d]
                        for d in range(rank)).ravel()
                    for lo, hi in zip(starts, ends)]))
        if self.axes is not None:
            if any(len(ax) and ax[-1] >= n for ax, n in zip(self.axes, self.extent)):
                raise ValueError(f"a selection past its extent {self.extent}")
            self.npoints = math.prod(len(ax) for ax in self.axes)
        else:
            if len(self.flat) and self.flat[-1] >= math.prod(self.extent):
                raise ValueError(f"a selection past its extent {self.extent}")
            self.npoints = len(self.flat)

    @staticmethod
    def _product(starts, ends):
        """The blocks as index arrays a dimension, where they are every
        combination of disjoint intervals of each dimension; else None."""
        intervals = []
        for d in range(starts.shape[1]):
            iv = sorted(set(zip(starts[:, d].tolist(), ends[:, d].tolist())))
            if any(b[0] <= a[1] for a, b in zip(iv, iv[1:])):
                return None
            intervals.append(iv)
        if math.prod(len(iv) for iv in intervals) != len(starts):
            return None
        return [np.concatenate([np.arange(a, b + 1) for a, b in iv])
                for iv in intervals]

    def inside(self, ranges):
        """The selection's points in the box `ranges`: ("spans", [(first,
        stop)] positions in each axis), or ("points", their positions in
        the selection, their coordinates); None when there are none."""
        if self.axes is not None:
            spans = [(int(np.searchsorted(ax, a)), int(np.searchsorted(ax, b)))
                     for ax, (a, b) in zip(self.axes, ranges)]
            return ("spans", spans) if all(i < j for i, j in spans) else None
        coords = np.unravel_index(self.flat, self.extent)
        keep = np.ones(len(self.flat), bool)
        for c, (a, b) in zip(coords, ranges):
            keep &= (c >= a) & (c < b)
        k = np.flatnonzero(keep)
        return ("points", k, [c[k] for c in coords]) if len(k) else None

    def coordinates(self, k) -> list:
        """The coordinates of the points at positions `k` in the order."""
        if self.axes is not None:
            grid = np.unravel_index(k, [len(ax) for ax in self.axes])
            return [ax[i] for ax, i in zip(self.axes, grid)]
        return list(np.unravel_index(self.flat[k], self.extent))


class _Mapping:
    """One mapping of a virtual dataset: the source file's and dataset's
    names, the source selection (made against the source's extent once the
    source is open) and the virtual selection."""

    def __init__(self, file_name, dataset_name, source_raw, virtual):
        self.file_name, self.dataset_name = file_name, dataset_name
        self._source_raw, self.virtual = source_raw, virtual
        self._source = None

    def pairs(self, inside, ranges, extent) -> tuple:
        """(destination, source, pointwise): for the virtual points
        `inside` (see `_Selection.inside`), their coordinates in the box
        `ranges` and those of the source points they take, paired in order.
        Both are lists of index arrays a dimension: each array alone (to
        combine as `np.ix_` does) where both selections are products of one
        shape, else (pointwise) one coordinate a point."""
        if self._source is None or self._source.extent != tuple(extent):
            self._source = _Selection(self._source_raw, extent)
        source, virtual = self._source, self.virtual
        if source.npoints != virtual.npoints:
            raise ValueError(f"a virtual dataset mapping of {virtual.npoints} "
                             f"points to {source.npoints} source points")
        if inside[0] == "spans":
            spans = inside[1]
            if source.axes is not None and [len(a) for a in source.axes] == [
                    len(a) for a in virtual.axes]:
                return ([ax[i:j] - a for ax, (i, j), (a, _) in
                         zip(virtual.axes, spans, ranges)],
                        [ax[i:j] for ax, (i, j) in zip(source.axes, spans)], False)
            grid = np.meshgrid(*(np.arange(i, j) for i, j in spans), indexing="ij")
            k = np.ravel_multi_index(grid, [len(ax) for ax in virtual.axes]).ravel()
            dst = [c - a for c, (a, _) in zip(virtual.coordinates(k), ranges)]
        else:
            _, k, coords = inside
            dst = [c - a for c, (a, _) in zip(coords, ranges)]
        return dst, source.coordinates(k), True


def _index(arrays, pointwise: bool) -> tuple:
    """An index for coordinate arrays a dimension: point by point, or else
    their product, as slices where each is a range."""
    if pointwise:
        return tuple(arrays)
    if all(len(a) == 1 or (np.diff(a) == 1).all() for a in arrays):
        return tuple(slice(int(a[0]), int(a[-1]) + 1) for a in arrays)
    return np.ix_(*arrays)


def _gather(out, dst, buffer, src, pointwise: bool, convert) -> None:
    values = buffer[_index(src, pointwise)]
    out[_index(dst, pointwise)] = values if convert is None else convert(values)


def _conversion(source_ds: Dataset, target_ds: Dataset):
    """How a source's values become a virtual dataset's of another type, as
    the library converts them: an enumeration (booleans too) only from one
    of the same type, base and members, taken as it is, and no other
    conversion to or from one; None where numpy's cast is exact; integers
    saturated at the target's range; to float32 or float64, rounded to
    nearest, a float past the target's largest finite value made
    infinite (numpy would round it back to that value). Floats to integers
    are refused (the library's result for NaN and out-of-range values
    follows the platform's C conversion), and so is float16 (the library's
    own conversion there is neither numpy's nor IEEE rounding)."""
    source, target = source_ds.dtype, target_ds.dtype
    if source_ds._enum or target_ds._enum:
        if (source_ds._enum, source_ds._stored) == (target_ds._enum,
                                                    target_ds._stored):
            return None
        raise unsupported(
            f"virtual dataset sources of type {source_ds._stored} under a dataset "
            f"of type {target_ds._stored}, either an enumeration, unless both "
            "are the same enumeration")
    if np.can_cast(source, target, "safe"):
        return None
    if target.kind == "f" and target.itemsize >= 4:
        top = np.finfo(target).max

        def to_float(values):
            with np.errstate(over="ignore"):
                out = values.astype(target)
            if values.dtype.kind == "f":
                out[values > top] = np.inf
                out[values < -top] = -np.inf
            return out
        return to_float
    if source.kind in "iu" and target.kind in "iu":
        lo, hi = np.iinfo(target).min, np.iinfo(target).max
        src_lo, src_hi = np.iinfo(source).min, np.iinfo(source).max

        def saturate(values):
            out = values.astype(target)
            if src_hi > hi:
                out[values > source.type(hi)] = hi
            if src_lo < lo:
                out[values < source.type(lo)] = lo
            return out
        return saturate
    raise unsupported(f"virtual dataset sources of type {source} under a "
                      f"dataset of type {target}")


def read(path, internal_path: str = "/data"):
    """(array, chunks) of the dataset at `internal_path`."""
    with File(path) as f:
        ds = f[internal_path]
        return ds[()], ds.chunks


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "ui" and size in (1, 2, 4, 8):
        bits = 0x8 if dtype.kind == "i" else 0
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in IEEE:
        return (struct.pack("<B3BIHH", 0x11, 0x20, 8 * size - 1, 0, size, 0,
                            8 * size) + struct.pack("<BBBBI", *IEEE[size]))
    raise ValueError(f"cannot write dtype {dtype} to HDF5 (integers and "
                     "IEEE floats only)")


class _Writer:
    def __init__(self, f):
        self.f = f

    def put(self, blob: bytes) -> int:
        addr = self.f.tell()
        self.f.write(blob)
        return addr

    def btree(self, node_type, entries, right_key, capacity, key_size) -> int:
        """Write a version 1 B-tree over `entries` [(key bytes, child
        address)], leaves first, every node at its full size; returns the
        root's address. A node's last key is its right neighbour's first
        (`right_key` at the right edge), as libhdf5 shares them."""
        node_size = _btree_header_size(8) + capacity * 8 + (capacity + 1) * key_size
        level = 0
        while True:
            groups = [entries[i:i + capacity]
                      for i in range(0, len(entries), capacity)]
            start = self.f.tell()
            parents = []
            for j, group in enumerate(groups):
                last = groups[j + 1][0][0] if j + 1 < len(groups) else right_key
                left = start + (j - 1) * node_size if j else UNDEF
                right = start + (j + 1) * node_size if j + 1 < len(groups) else UNDEF
                node = struct.pack("<4sBBHQQ", b"TREE", node_type, level,
                                   len(group), left, right)
                node += b"".join(k + struct.pack("<Q", c) for k, c in group) + last
                parents.append((group[0][0],
                                self.put(node + b"\0" * (node_size - len(node)))))
            if len(parents) == 1:
                return parents[0][1]
            entries, level = parents, level + 1

    def group(self, entries) -> tuple:
        """A symbol-table group of `entries` [(name, child address)], at
        most SNOD_ENTRIES; returns its object header's, B-tree's and local
        heap's addresses."""
        if len(entries) > SNOD_ENTRIES:
            raise ValueError(f"a group of {len(entries)} entries (the writer "
                             f"makes groups of up to {SNOD_ENTRIES})")
        entries = sorted(entries, key=lambda e: e[0].encode())
        heap_data, offsets = b"\0" * 8, []
        for name, _ in entries:
            offsets.append(len(heap_data))
            heap_data += name.encode() + b"\0"
            heap_data += b"\0" * (-len(heap_data) % 8)
        heap_addr = self.f.tell()
        # Free list head 1 is libhdf5's "no free block" (H5HL_FREE_NULL).
        self.put(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), 1,
                             heap_addr + 32) + heap_data)
        snod = struct.pack("<4sBxH", b"SNOD", 1, len(entries))
        for offset, (_, child) in zip(offsets, entries):
            snod += struct.pack("<QQI4x16x", offset, child, 0)
        snod += b"\0" * (8 + SNOD_ENTRIES * _symbol_entry_size(8, 8) - len(snod))
        snod_addr = self.put(snod)
        btree = self.btree(0, [(struct.pack("<Q", 0), snod_addr)],
                           struct.pack("<Q", offsets[-1]), GROUP_NODE_ENTRIES, 8)
        header = _object_header([_message(
            MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))])
        return self.put(header), btree, heap_addr


def _attribute_message(name: str, value) -> bytes:
    """A version 1 attribute message of a number or an array of them."""
    value = np.asarray(value)
    dtype = value.dtype.newbyteorder("<")
    dt = _datatype_message(dtype)
    ds = struct.pack(f"<BBB5x{value.ndim}Q", 1, value.ndim, 0, *value.shape)
    nm = name.encode() + b"\0"
    pad = lambda b: b + b"\0" * (-len(b) % 8)
    return _message(MSG_ATTRIBUTE, struct.pack("<BxHHH", 1, len(nm), len(dt),
                                               len(ds))
                    + pad(nm) + pad(dt) + pad(ds) + value.astype(dtype).tobytes())


def _write_dataset(w: _Writer, data, chunks, attrs) -> int:
    """Write `data` chunked and deflated, with `attrs`; returns its object
    header's address."""
    shape = tuple(int(s) for s in data.shape)
    if not shape or 0 in shape:
        raise ValueError(f"cannot write an empty or scalar dataset {shape}")
    dtype = np.dtype(data.dtype).newbyteorder("<")
    dtype_msg = _datatype_message(dtype)
    if chunks is True or chunks is None:
        chunks = guess_chunk(shape, dtype.itemsize)
    chunks = tuple(int(c) for c in chunks)
    if len(chunks) != len(shape) or min(chunks) < 1:
        raise ValueError(f"chunk shape {chunks} does not fit data {shape}")
    if any(c > s for c, s in zip(chunks, shape)):
        raise ValueError(
            "Chunk shape must not be greater than data shape in any "
            f"dimension. {chunks} is not compatible with {shape}")
    rank = len(shape)
    offsets = list(itertools.product(
        *(range(0, s, c) for s, c in zip(shape, chunks))))

    def compress(offset):
        region = tuple(slice(o, o + c) for o, c in zip(offset, chunks))
        block = np.asarray(data[region], dtype=dtype)
        if block.shape != chunks:
            full = np.zeros(chunks, dtype)
            full[tuple(slice(0, b) for b in block.shape)] = block
            block = full
        return zlib.compress(np.ascontiguousarray(block).tobytes(),
                             HDF5_GZIP_LEVEL)

    entries = []
    with ThreadPoolExecutor() as pool:
        for offset, blob in zip(offsets, pool.map(compress, offsets)):
            key = struct.pack(f"<II{rank + 1}Q", len(blob), 0, *offset, 0)
            entries.append((key, w.put(blob)))
    last = [o + c for o, c in zip(offsets[-1], chunks)]
    right_key = struct.pack(f"<II{rank + 1}Q", 0, 0, *last, 0)
    btree = w.btree(1, entries, right_key, CHUNK_NODE_ENTRIES, 8 + 8 * (rank + 1))
    return w.put(_object_header([
        _message(MSG_DATASPACE, struct.pack(f"<BBB5x{rank}Q", 1, rank, 0,
                                            *shape)),
        _message(MSG_DATATYPE, dtype_msg, flags=1),
        # Version 2, incremental allocation, fill if set, the default
        # fill value (zeros), as h5py writes it.
        _message(MSG_FILL, struct.pack("<BBBBI", 2, 3, 2, 1, 0), flags=1),
        _message(MSG_LAYOUT, struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1,
                                         btree, *chunks, dtype.itemsize)),
        _message(MSG_FILTERS, struct.pack("<BB6xHHHH8sI4x", 1, 1,
                                          FILTER_DEFLATE, 8, 1, 1,
                                          b"deflate", HDF5_GZIP_LEVEL),
                 flags=1),
        *(_attribute_message(k, v) for k, v in (attrs or {}).items()),
    ]))


def write(path, data, internal_path: str = "/data", chunks=True,
          attrs: dict = None) -> None:
    """Write `data` as one chunked, deflate-compressed dataset at
    `internal_path` of a new file, with `attrs` ({name: number}). `chunks`
    is a tuple, or True or None for h5py's guess. Blocks are read from
    `data` a chunk at a time, so a memmapped source is never copied
    whole."""
    write_datasets(path, {internal_path: (data, attrs)}, chunks)


def write_datasets(path, datasets: dict, chunks=True) -> None:
    """`write` of several datasets into one new file: `datasets` maps each
    internal path to (data, attrs or None); `chunks` applies to each."""
    tree = {}
    for internal_path, (data, attrs) in datasets.items():
        parts = [p for p in str(internal_path).split("/") if p]
        if not parts:
            raise ValueError("the internal path must name a dataset")
        node = tree
        for name in parts[:-1]:
            node = node.setdefault(name, {})
            if not isinstance(node, dict):
                raise ValueError(f"{internal_path}: {name} is a dataset")
        if parts[-1] in node:
            raise ValueError(f"{internal_path} is given twice")
        node[parts[-1]] = (data, attrs)

    with open(path, "wb") as f:
        w = _Writer(f)
        w.put(b"\0" * 96)  # the superblock, written last

        def emit(node) -> tuple:
            entries = [(name, emit(child)[0] if isinstance(child, dict)
                        else _write_dataset(w, child[0], chunks, child[1]))
                       for name, child in node.items()]
            return w.group(entries)

        addr, btree, heap = emit(tree)
        eof = f.tell()
        f.seek(0)
        f.write(SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0)
                + struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
                + struct.pack("<QQI4xQQ", 0, addr, 1, btree, heap))
