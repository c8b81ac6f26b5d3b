"""Reader and writer for HDF5 as h5py writes it, in numpy and zlib alone
(the GPU machine has no h5py).

The reader takes what h5py 3 writes at any `libver` bound, as h5py reads
it:
- a user block before the superblock (looked for at 0, 512, 1024, 2048,
  ..., as the library does; addresses count from the superblock), and
  superblock versions 0 to 3, with the checksum of versions 2 and 3
  verified;
- version 1 object headers and version 2 ones (`OHDR`, with their `OCHK`
  continuation blocks), each checksum verified;
- groups of both kinds: symbol tables (v1 B-tree, SNOD nodes and a local
  heap), and link messages, either in the object header or, in a dense
  group, in a fractal heap reached through the version 2 B-tree of link
  names;
- hard, soft and external links along a path such as
  ``/entry/final_result_tomo/data``. One lookup follows at most 16 soft or
  external links, as the library does, and raises KeyError past that (a
  cycle; h5py raises RuntimeError there). An external link's file is
  looked for as the library looks for it (`File._external`), and a dataset
  reached through one keeps that file open for as long as it lives;
- fixed-point (1, 2, 4 or 8 bytes, signed or not) and IEEE float (2, 4 or
  8 bytes) datatypes in either byte order;
- contiguous, compact and chunked layouts (layout message versions 3 and
  4), with chunks found through each index the library writes: the
  version 1 B-tree, a single chunk, the implicit index, the fixed array,
  the extensible array and the version 2 B-tree; partial edge chunks, and
  chunks never written (these take the fill value);
- the deflate, shuffle and Fletcher-32 filters; each Fletcher-32 checksum is
  verified, and a mismatch raises ValueError.

It returns arrays in native byte order, and `chunks` as h5py's
``dataset.chunks`` gives them. ``ds[sel]`` takes h5py's basic selections
(ints and step-1 slices): a chunked dataset indexes its chunks once and
inflates only those that meet the selection, so a volume larger than host
memory is read a slab at a time. Every other feature (LZF, szip, n-bit and
scale-offset filters, virtual and external-storage layouts, shared object
header messages, other datatypes, offsets that are not 8 bytes, steps and
fancy indexing, ...) raises NotImplementedError naming it; a path that is
not in the file raises KeyError, as h5py does.

The writer makes what ``h5py.File(p, "w").create_dataset(path, data=...,
chunks=..., compression="gzip")`` makes: superblock version 0, one chunked,
deflate-compressed dataset at the internal path (its groups as symbol-table
groups), chunks equal to the given chunking or to h5py's `guess_chunk`.
Chunks are compressed in a thread pool (zlib releases the GIL) and written
in order, so the file does not depend on the pool.
"""

import bisect
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

from volume_segmantics_tpu_torch.utils.config import HDF5_GZIP_LEVEL

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # HDF5's undefined address
MAX_LINK_TRAVERSALS = 16  # soft and external links one lookup may follow

# Object header message types.
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x7, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3
FILTER_NAMES = {4: "szip", 5: "n-bit", 6: "scale-offset", 32000: "LZF"}
LINK_HARD, LINK_SOFT, LINK_EXTERNAL = 0, 1, 64

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
SYMBOL_ENTRY_SIZE = 40
BTREE_HEADER_SIZE = 24

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
        if sizes != (8, 8):
            raise unsupported("offsets or lengths that are not 8 bytes")
        if version >= 2:
            self._verify(0, 44, "superblock")
            return self._u("Q", 36)[0]
        return self._u("Q", (24 if version == 0 else 28) + 40)[0]

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
                    start, length = self._u("QQ", p + prefix)
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

    def _btree_children(self, addr: int, node_type: int, key_size: int):
        """(key offset, child address) of every level-0 entry of the
        version 1 B-tree rooted at `addr`, in order."""
        if self._buf[addr:addr + 4] != b"TREE" or self._buf[addr + 4] != node_type:
            raise ValueError(f"{self.path}: no type {node_type} B-tree node at {addr}")
        level = self._buf[addr + 5]
        used = self._u("H", addr + 6)[0]
        p = addr + BTREE_HEADER_SIZE
        for _ in range(used):
            child = self._u("Q", p + key_size)[0]
            if level == 0:
                yield p, child
            else:
                yield from self._btree_children(child, node_type, key_size)
            p += key_size + 8

    def _btree2_records(self, addr: int, record_type: int):
        """(record size, record offsets in key order) of the version 2
        B-tree whose header is at `addr`."""
        buf = self._buf
        if buf[addr:addr + 4] != b"BTHD" or buf[addr + 5] != record_type:
            raise ValueError(f"{self.path}: no type {record_type} version 2 "
                             f"B-tree at {addr}")
        node_size, record_size, depth = self._u("IHH", addr + 6)
        root, root_count = self._u("QH", addr + 16)
        # The widths of a child pointer's record counts follow from how many
        # records a node of each level can hold (the library's H5B2hdr.c).
        most = (node_size - 10) // record_size  # in a leaf
        count_size = _enc_size(most)
        totals, total_sizes = [most], [0]
        for level in range(1, depth + 1):
            pointer = 8 + count_size + total_sizes[level - 1]
            n = (node_size - 10 - pointer) // (record_size + pointer)
            totals.append((n + 1) * totals[level - 1] + n)
            total_sizes.append(_enc_size(totals[level]))

        def walk(node, count, level):
            if (buf[node:node + 4] != (b"BTIN" if level else b"BTLF")
                    or buf[node + 5] != record_type):
                raise ValueError(f"{self.path}: no version 2 B-tree node at {node}")
            records = node + 6
            if level == 0:
                yield from range(records, records + count * record_size,
                                 record_size)
                return
            p = records + count * record_size
            for i in range(count + 1):
                child = self._u("Q", p)[0]
                child_count = self._uint(p + 8, count_size)
                p += 8 + count_size + total_sizes[level - 1]
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
        btree, heap = self._u("QQ", d)
        if self._buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        heap_data = self._u("Q", heap + 24)[0]
        links = {}
        for _key, snod in self._btree_children(btree, 0, 8):
            if self._buf[snod:snod + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol table node at {snod}")
            for i in range(self._u("H", snod + 6)[0]):
                e = snod + 8 + i * SYMBOL_ENTRY_SIZE
                name_off, header, cache = self._u("QQI", e)
                name = self._cstring(heap_data + name_off)
                if cache == 2:  # a soft link: its value is in the heap
                    value = heap_data + self._u("I", e + 24)[0]
                    links[name] = ("soft", self._cstring(value))
                else:
                    links[name] = ("hard", header)
        return links

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
            return name, ("hard", self._u("Q", p)[0])
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
        heap, names = self._u("QQ", d + 2 + (8 if flags & 0x1 else 0))
        if names == UNDEF:
            return {}
        heap = _FractalHeap(self, heap)
        _, records = self._btree2_records(names, BTREE2_LINK_NAMES)
        return dict(self._link(heap.object(r + 4)) for r in records)

    def _external(self, name: str) -> "File":
        """The file an external link names, looked for as the library does:
        an absolute name as it is, then (with its directories dropped) under
        each directory of $HDF5_EXT_PREFIX (``${ORIGIN}`` is this file's
        directory), in this file's directory, and in the working directory.
        The first candidate that opens as HDF5 is taken."""
        target = Path(name)
        candidates = []
        if target.is_absolute():
            candidates.append(target)
            target = Path(target.name)
        for prefix in os.environ.get("HDF5_EXT_PREFIX", "").split(os.pathsep):
            if prefix:
                candidates.append(Path(prefix.replace("${ORIGIN}",
                                                      str(self._dir))) / target)
        candidates += [self._dir / target, target]
        for path in candidates:
            key = os.path.abspath(path)
            if key not in self._externals:
                try:
                    self._externals[key] = File(path)
                except (OSError, ValueError):
                    continue
            return self._externals[key]
        raise KeyError(f"Unable to open object (can't open file '{name}' of "
                       "an external link)")

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
        if filter_size:
            raise unsupported("filtered fractal heaps")
        (self._width, self._start, max_direct, max_heap_bits, _, root,
         rows) = f._u("HQQHHQH", addr + 110)
        self._offset_size = (max_heap_bits + 7) // 8
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
        self._blocks.append((f._uint(addr + 13, self._offset_size), addr, size))

    def _indirect(self, addr, rows):
        """The direct blocks under the indirect block at `addr`: rows of
        `width` blocks, direct ones of doubling size, then indirect ones."""
        f = self._f
        if f._buf[addr:addr + 4] != b"FHIB":
            raise ValueError(f"{f.path}: no fractal heap indirect block at {addr}")
        p = addr + 13 + self._offset_size
        for row in range(rows):
            size = self._start << max(row - 1, 0)
            for child in f._u(f"{self._width}Q", p):
                if child == UNDEF:
                    continue
                if row < self._direct_rows:
                    self._direct(child, size)
                else:
                    self._indirect(child, _log2(size) - _log2(
                        self._start * self._width) + 1)
            p += 8 * self._width

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
    inflated. It holds its file open."""

    def __init__(self, file: File, addr: int, name: str):
        self._f = file
        self.name = name
        msgs = file._messages(addr)
        for mtype in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT):
            if mtype not in msgs:
                raise ValueError(f"{name}: object header lacks message {mtype}")
        if MSG_EXTERNAL in msgs:
            raise unsupported("external storage")
        for mtype in (MSG_DATASPACE, MSG_DATATYPE, MSG_FILL, MSG_FILL_OLD,
                      MSG_LAYOUT, MSG_FILTERS):
            if any(flags & 0x2 for flags, _, _ in msgs.get(mtype, ())):
                raise unsupported(f"shared object header messages (type {mtype})")
        self.shape, maxshape = self._dataspace(msgs[MSG_DATASPACE][0][1])
        self.maxshape = tuple(None if m == UNDEF else m for m in maxshape)
        self._stored = self._datatype(msgs[MSG_DATATYPE][0][1])
        self.dtype = self._stored.newbyteorder("=")
        self._filters = (self._filter_ids(msgs[MSG_FILTERS][0][1])
                         if MSG_FILTERS in msgs else [])
        self._fill = self._fill_value(msgs)
        self._layout(msgs[MSG_LAYOUT][0][1])
        self._index = None  # chunk offset -> storage, read at the first read
        self._lock = threading.Lock()
        self.inflated_chunks = 0  # chunks inflated by this object's reads

    def _dataspace(self, d) -> tuple:
        """(dimensions, maximum dimensions; UNDEF where unlimited)."""
        u, buf = self._f._u, self._f._buf
        version, rank, flags = buf[d], buf[d + 1], buf[d + 2]
        if version == 1:
            p = d + 8
        elif version == 2:
            if buf[d + 3] == 2:
                raise unsupported("null dataspaces")
            p = d + 4
        else:
            raise unsupported(f"dataspace message version {version}")
        dims = tuple(u(f"{rank}Q", p)) if rank else ()
        if flags & 0x1 and rank:
            return dims, tuple(u(f"{rank}Q", p + 8 * rank))
        return dims, dims

    def _datatype(self, d) -> np.dtype:
        u, buf = self._f._u, self._f._buf
        cls, bits0 = buf[d] & 0x0F, buf[d + 1]
        size = u("I", d + 4)[0]
        order = ">" if bits0 & 0x1 else "<"
        if cls == 0:
            offset, precision = u("HH", d + 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise unsupported(f"{size}-byte fixed-point with precision "
                                  f"{precision} at bit {offset}")
            return np.dtype(f"{order}{'i' if bits0 & 0x8 else 'u'}{size}")
        if cls == 1:
            props = u("HHBBBBI", d + 8)
            if (size not in IEEE or bits0 & 0x40 or props[:2] != (0, 8 * size)
                    or props[2:] != IEEE[size] or buf[d + 2] != 8 * size - 1):
                raise unsupported(f"non-IEEE {size}-byte floating point")
            return np.dtype(f"{order}f{size}")
        raise unsupported(f"datatype class {cls} (only integers and IEEE "
                          "floats are read)")

    def _filter_ids(self, d) -> list:
        u, buf = self._f._u, self._f._buf
        version, count = buf[d], buf[d + 1]
        if version not in (1, 2):
            raise unsupported(f"filter pipeline message version {version}")
        p = d + (8 if version == 1 else 2)
        ids = []
        for _ in range(count):
            fid = u("H", p)[0]
            p += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = u("H", p)[0]
                p += 2
            _flags, n_values = u("HH", p)
            p += 4 + name_len + 4 * n_values
            if version == 1 and n_values % 2:
                p += 4
            if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32):
                name = FILTER_NAMES.get(fid, "unknown")
                raise unsupported(f"filter {fid} ({name}; only deflate, shuffle "
                                  "and Fletcher-32 are read)")
            ids.append(fid)
        return ids

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
        if cls == 0:
            self._compact = (d + 4, u("H", d + 2)[0])
        elif cls == 1:
            self._contiguous = u("QQ", d + 2)
        elif cls == 2 and version == 3:
            ndims = buf[d + 2]
            self._index_type, self._index_addr = INDEX_BTREE1, u("Q", d + 3)[0]
            self.chunks = tuple(u(f"{ndims - 1}I", d + 11))
        elif cls == 2:
            flags, ndims, width = buf[d + 2], buf[d + 3], buf[d + 4]
            if flags & 0x1:
                raise unsupported("unfiltered partial edge chunks (chunk "
                                  "option flag 1)")
            p = d + 5
            dims = [self._f._uint(p + i * width, width) for i in range(ndims)]
            self.chunks = tuple(dims[:-1])  # the last is the element's size
            self._index_type = buf[p + ndims * width]
            p += ndims * width + 1
            self._single = None  # a single chunk's filtered size and mask
            if self._index_type == INDEX_SINGLE and flags & 0x2:
                self._single = u("QI", p)
                p += 12
            elif self._index_type == INDEX_FIXED_ARRAY:
                p += 1
            elif self._index_type == INDEX_EXTENSIBLE_ARRAY:
                p += 5
            elif self._index_type == INDEX_BTREE2:
                p += 6
            elif self._index_type not in (INDEX_SINGLE, INDEX_IMPLICIT):
                raise unsupported(f"chunk index type {self._index_type}")
            self._index_addr = u("Q", p)[0]
        elif cls == 3:
            raise unsupported("virtual dataset layout")
        else:
            raise unsupported(f"data layout class {cls}")
        self._layout_class = cls

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

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
        chunks that meet the selection; contiguous and compact ones copy
        only the selected bytes."""
        ranges, shape = self._selection(key)
        full = tuple(b - a for a, b in ranges)
        if 0 in full:
            out = np.empty(full, self.dtype)
        elif self._layout_class == 2:
            out = self._read_chunked(ranges)
        else:
            addr = (self._compact[0] if self._layout_class == 0
                    else self._contiguous[0])
            if addr == UNDEF:  # never written
                out = np.full(full, self._fill, self.dtype)
            else:
                stored = np.frombuffer(self._f._buf, self._stored,
                                       count=self.size, offset=addr)
                region = tuple(slice(a, b) for a, b in ranges)
                out = stored.reshape(self.shape)[region].astype(self.dtype)
                del stored  # the mmap cannot close while a view exports it
        out = out.reshape(shape)
        return out[()] if not shape else out

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
            size_width = entry - 12 if filtered else 0
            for i, e in elements:
                chunk = f._u("Q", e)[0]
                if chunk == UNDEF:
                    continue
                stored = ((f._uint(e + 8, size_width), f._u("I", e + 8 + size_width)[0])
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
        filtered, entry, page_bits = f._buf[addr + 5:addr + 8]
        n, block = f._u("QQ", addr + 8)
        if f._buf[block:block + 4] != b"FADB":
            raise ValueError(f"{f.path}: no fixed array data block at {block}")
        page = 1 << page_bits
        if n <= page:
            return entry, filtered, [(i, block + 14 + i * entry) for i in range(n)]
        pages = -(-n // page)
        p = block + 14 + (pages + 7) // 8 + 4  # past the bitmap and checksum
        elements = []
        for k in range(pages):
            count = min(page, n - k * page)
            if self._bit(block + 14, k):
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
        used = f._u("Q", addr + 44)[0]  # 1 + the highest index ever set
        iblock = f._u("Q", addr + 60)[0]
        if iblock == UNDEF:
            return entry, filtered, []
        if buf[iblock:iblock + 4] != b"EAIB":
            raise ValueError(f"{f.path}: no extensible array index block at {iblock}")
        page = 1 << page_bits
        prefix = 14 + (max_bits + 7) // 8  # of a data or super block
        n_super = 1 + max_bits - _log2(min_entries)
        in_iblock = 2 * _log2(min_pointers)  # super blocks the index block holds
        p = iblock + 14
        elements = [(i, p + i * entry) for i in range(min(iblock_entries, used))]
        p += iblock_entries * entry
        dblocks = f._u(f"{2 * (min_pointers - 1)}Q", p)
        sblocks = f._u(f"{n_super - in_iblock}Q", p + 16 * (min_pointers - 1))

        def data_block(dblock, first, count, initialised):
            if buf[dblock:dblock + 4] != b"EADB":
                raise ValueError(f"{f.path}: no extensible array data block at {dblock}")
            if count <= page:
                elements.extend((first + i, dblock + prefix + i * entry)
                                for i in range(min(count, used - first)))
                return
            if initialised is None:
                raise unsupported("paged data blocks in an extensible array's "
                                  "index block")
            q = dblock + prefix + 4
            for k in range(count // page):
                if initialised(k):
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
                for j, dblock in enumerate(f._u(f"{n_blocks}Q", q)):
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
        size_width = record_size - 8 - 4 - 8 * rank if filtered else 0
        index = {}
        for r in records:
            chunk = f._u("Q", r)[0]
            stored = ((f._uint(r + 8, size_width), f._u("I", r + 8 + size_width)[0])
                      if filtered else (chunk_bytes, 0))
            scaled = f._u(f"{rank}Q", r + record_size - 8 * rank)
            index[self._offset(scaled)] = (chunk, *stored)
        return index

    def _inflate(self, addr, nbytes, mask) -> np.ndarray:
        """One stored chunk, unfiltered, as a (chunks) array of the stored
        type (a read-only view of the inflated bytes). A Fletcher-32
        checksum that does not match raises ValueError."""
        raw = self._f._buf[addr:addr + nbytes]
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            if self._filters[i] == FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            elif self._filters[i] == FILTER_SHUFFLE:
                raw = (np.frombuffer(raw, np.uint8)
                       .reshape(self._stored.itemsize, -1).T.tobytes())
            else:
                raw = self._fletcher32_checked(raw, addr)
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

    def _read_chunked(self, ranges) -> np.ndarray:
        """The box `ranges` of a chunked dataset: the written chunks that
        meet it are inflated in a thread pool (zlib releases the GIL); the
        rest of the box takes the fill value."""
        chunks, index = self.chunks, self._chunk_index()
        out = np.full(tuple(b - a for a, b in ranges), self._fill, self.dtype)
        grid = itertools.product(*(range(a - a % c, b, c)
                                   for (a, b), c in zip(ranges, chunks)))
        hits = [(offset, index[offset]) for offset in grid if offset in index]

        def place(hit):
            offset, entry = hit
            block = self._inflate(*entry)
            src, dst = [], []
            for o, c, (a, b) in zip(offset, chunks, ranges):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = block[tuple(src)]

        with self._lock:
            self.inflated_chunks += len(hits)
        if len(hits) == 1:
            place(hits[0])
        elif hits:
            with ThreadPoolExecutor() as pool:
                list(pool.map(place, hits))
        return out


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
        node_size = BTREE_HEADER_SIZE + capacity * 8 + (capacity + 1) * key_size
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

    def group(self, name: str, child: int) -> int:
        """A symbol-table group holding one entry, `name` -> `child`;
        returns its object header's, B-tree's and local heap's addresses."""
        heap_data = b"\0" * 8 + name.encode() + b"\0"
        heap_data += b"\0" * (-len(heap_data) % 8)
        heap_addr = self.f.tell()
        # Free list head 1 is libhdf5's "no free block" (H5HL_FREE_NULL).
        self.put(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), 1,
                             heap_addr + 32) + heap_data)
        snod = struct.pack("<4sBxH", b"SNOD", 1, 1)
        snod += struct.pack("<QQI4x16x", 8, child, 0)
        snod += b"\0" * (8 + SNOD_ENTRIES * SYMBOL_ENTRY_SIZE - len(snod))
        snod_addr = self.put(snod)
        btree = self.btree(0, [(struct.pack("<Q", 0), snod_addr)],
                           struct.pack("<Q", 8), GROUP_NODE_ENTRIES, 8)
        header = _object_header([_message(
            MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))])
        return self.put(header), btree, heap_addr


def write(path, data, internal_path: str = "/data", chunks=True) -> None:
    """Write `data` as one chunked, deflate-compressed dataset at
    `internal_path` of a new file. `chunks` is a tuple, or True or None for
    h5py's guess. Blocks are read from `data` a chunk at a time, so a
    memmapped source is never copied whole."""
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
    parts = [p for p in str(internal_path).split("/") if p]
    if not parts:
        raise ValueError("the internal path must name a dataset")
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

    with open(path, "wb") as f:
        w = _Writer(f)
        w.put(b"\0" * 96)  # the superblock, written last
        entries = []
        with ThreadPoolExecutor() as pool:
            for offset, blob in zip(offsets, pool.map(compress, offsets)):
                key = struct.pack(f"<II{rank + 1}Q", len(blob), 0, *offset, 0)
                entries.append((key, w.put(blob)))
        last = [o + c for o, c in zip(offsets[-1], chunks)]
        right_key = struct.pack(f"<II{rank + 1}Q", 0, 0, *last, 0)
        btree = w.btree(1, entries, right_key, CHUNK_NODE_ENTRIES, 8 + 8 * (rank + 1))
        addr = w.put(_object_header([
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
        ]))
        for name in reversed(parts):
            addr, btree, heap = w.group(name, addr)
        eof = f.tell()
        f.seek(0)
        f.write(SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0)
                + struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
                + struct.pack("<QQI4xQQ", 0, addr, 1, btree, heap))
