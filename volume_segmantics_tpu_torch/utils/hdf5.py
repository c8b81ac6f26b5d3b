"""Reader and writer for the subset of HDF5 that h5py writes by default,
in numpy and zlib alone (the GPU machine has no h5py).

The reader takes superblock version 0 or 1; version 1 object headers and
their continuation blocks; symbol-table groups (v1 B-tree, SNOD nodes and a
local heap) along a path such as ``/entry/final_result_tomo/data``;
fixed-point (1, 2, 4 or 8 bytes, signed or not) and IEEE float (2, 4 or 8
bytes) datatypes in either byte order; contiguous, compact and chunked
layouts, chunks found through the version 1 B-tree, partial edge chunks
and chunks never written (these take the fill value); and the deflate and
shuffle filters. It returns arrays in native byte order, and `chunks` as
h5py's ``dataset.chunks`` gives them. ``ds[sel]`` takes h5py's basic
selections (ints and step-1 slices): a chunked dataset indexes its chunks
once and inflates only those that meet the selection, so a volume larger
than host memory is read a slab at a time. Every other feature (steps,
fancy indexing, an Ellipsis inside a tuple) raises NotImplementedError
naming it; a path that is not in the file raises KeyError, as h5py does.

The writer makes what ``h5py.File(p, "w").create_dataset(path, data=...,
chunks=..., compression="gzip")`` makes: superblock version 0, one chunked,
deflate-compressed dataset at the internal path (its groups as symbol-table
groups), chunks equal to the given chunking or to h5py's `guess_chunk`.
Chunks are compressed in a thread pool (zlib releases the GIL) and written
in order, so the file does not depend on the pool.
"""

import itertools
import math
import mmap
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from volume_segmantics_tpu_torch.utils.config import HDF5_GZIP_LEVEL

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # HDF5's undefined address

# Object header message types.
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x7, 0x8
MSG_GROUP_INFO, MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xA, 0xB, 0x10, 0x11
FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2

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


def unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"HDF5 {feature} is not supported by the PyTorch port's HDF5 reader, "
        "which reads what h5py writes by default (see ROADMAP.md)."
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
# Reader
# ----------------------------------------------------------------------


class File:
    """A read-only HDF5 file: ``with File(p) as f: ds = f["/data"]``."""

    def __init__(self, path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._root = self._read_superblock()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        buf = getattr(self, "_buf", None)
        if buf is not None:
            buf.close()
            self._buf = None
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _u(self, fmt, offset):
        return struct.unpack_from("<" + fmt, self._buf, offset)

    def _read_superblock(self) -> int:
        if self._buf[:8] != SIGNATURE:
            raise ValueError(
                f"{self.path} is not an HDF5 file with its superblock at "
                "offset 0 (files with a user block are not supported)."
            )
        version = self._buf[8]
        if version not in (0, 1):
            raise unsupported(
                f"superblock version {version} (files written with "
                "libver='latest' or a later low bound)"
            )
        if (self._buf[13], self._buf[14]) != (8, 8):
            raise unsupported("offsets or lengths that are not 8 bytes")
        p = 24 if version == 0 else 28
        base, _free, _eof, _driver = self._u("4Q", p)
        if base != 0:
            raise unsupported("base address other than 0")
        return self._u("Q", p + 32 + 8)[0]  # root entry's object header

    def _messages(self, addr: int) -> dict:
        """{message type: [(flags, data offset, size), ...]} of the version 1
        object header at `addr`, continuation blocks followed."""
        if self._buf[addr:addr + 4] == b"OHDR":
            raise unsupported("version 2 object headers")
        if self._buf[addr] != 1:
            raise ValueError(f"{self.path}: no object header at {addr}")
        size = self._u("I", addr + 8)[0]
        blocks, msgs = [(addr + 16, size)], {}
        while blocks:
            start, length = blocks.pop(0)
            p = start
            while p + 8 <= start + length:
                mtype, msize, flags = self._u("HHB", p)
                if mtype == MSG_CONTINUATION:
                    blocks.append(self._u("QQ", p + 8))
                elif mtype != MSG_NIL:
                    msgs.setdefault(mtype, []).append((flags, p + 8, msize))
                p += 8 + msize
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

    def _group_entries(self, addr: int) -> dict:
        """{name: (object header address, cache type)} of a symbol-table
        group."""
        msgs = self._messages(addr)
        if MSG_SYMBOL_TABLE not in msgs:
            if {MSG_LINK, MSG_LINK_INFO, MSG_GROUP_INFO} & set(msgs):
                raise unsupported(
                    "new-style groups (link messages, fractal-heap groups)")
            return None  # not a group
        btree, heap = self._u("QQ", msgs[MSG_SYMBOL_TABLE][0][1])
        if self._buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        heap_data = self._u("Q", heap + 24)[0]
        entries = {}
        for _key, snod in self._btree_children(btree, 0, 8):
            if self._buf[snod:snod + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol table node at {snod}")
            for i in range(self._u("H", snod + 6)[0]):
                e = snod + 8 + i * SYMBOL_ENTRY_SIZE
                name_off, header, cache = self._u("QQI", e)
                start = heap_data + name_off
                name = self._buf[start:self._buf.find(b"\0", start)].decode()
                entries[name] = (header, cache)
        return entries

    def __getitem__(self, path: str) -> "Dataset":
        addr = self._root
        parts = [p for p in str(path).split("/") if p]
        for depth, name in enumerate(parts):
            entries = self._group_entries(addr)
            where = "/" + "/".join(parts[:depth])
            if entries is None:
                raise KeyError(f"Unable to open object ({where} is not a group)")
            if name not in entries:
                raise KeyError(
                    f"Unable to open object (component '{name}' not found)")
            addr, cache = entries[name]
            if cache == 2:
                raise unsupported(f"soft links ({where.rstrip('/')}/{name})")
        if self._group_entries(addr) is not None:
            raise TypeError(f"{path} in {self.path} is a group, not a dataset")
        return Dataset(self, addr, str(path))


class Dataset:
    """One dataset of a `File`: `shape`, `size`, `ndim`, `dtype` (native
    byte order), `chunks` (None unless chunked), and `ds[sel]` for h5py's
    basic selections (`ds[()]` is the whole array). `inflated_chunks`
    counts the chunks its reads have inflated."""

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
        self.shape = self._dataspace(msgs[MSG_DATASPACE][0][1])
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
        u, buf = self._f._u, self._f._buf
        version, rank = buf[d], buf[d + 1]
        if version == 1:
            p = d + 8
        elif version == 2:
            if buf[d + 3] == 2:
                raise unsupported("null dataspaces")
            p = d + 4
        else:
            raise unsupported(f"dataspace message version {version}")
        return tuple(u(f"{rank}Q", p)) if rank else ()

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
            if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
                raise unsupported(f"filter {fid} (only deflate and shuffle)")
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
        u, buf = self._f._u, self._f._buf
        version, cls = buf[d], buf[d + 1]
        if version != 3:
            raise unsupported(f"data layout message version {version}")
        self.chunks = None
        if cls == 0:
            size = u("H", d + 2)[0]
            self._compact = (d + 4, size)
        elif cls == 1:
            self._contiguous = u("QQ", d + 2)
        elif cls == 2:
            ndims = buf[d + 2]
            self._btree = u("Q", d + 3)[0]
            self.chunks = tuple(u(f"{ndims - 1}I", d + 11))
        else:
            raise unsupported("virtual dataset layout")
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
        written chunk, from one walk of the chunk B-tree."""
        with self._lock:
            if self._index is None:
                self._index = self._walk_chunk_btree()
        return self._index

    def _walk_chunk_btree(self) -> dict:
        f, rank, index = self._f, len(self.shape), {}
        if self._btree != UNDEF:  # else no chunk was ever written
            for key, addr in f._btree_children(self._btree, 1, 8 + 8 * (rank + 1)):
                nbytes, mask = f._u("II", key)
                index[f._u(f"{rank}Q", key + 8)] = (addr, nbytes, mask)
        return index

    def _inflate(self, addr, nbytes, mask) -> np.ndarray:
        """One stored chunk, unfiltered, as a (chunks) array of the stored
        type (a read-only view of the inflated bytes)."""
        raw = self._f._buf[addr:addr + nbytes]
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            if self._filters[i] == FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            else:
                raw = (np.frombuffer(raw, np.uint8)
                       .reshape(self._stored.itemsize, -1).T.tobytes())
        return np.frombuffer(raw, self._stored).reshape(self.chunks)

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
