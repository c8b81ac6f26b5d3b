"""The port's HDF5 reader (`utils/hdf5.py`) on files as h5py writes them
at every `libver`: superblock versions 2 and 3, version 2 object headers,
user blocks, layout message version 4 with each of its chunk indexes
(single chunk, implicit, fixed array, paged or not, extensible array, in
its index block, super blocks and paged data blocks, and version 2
B-tree), Fletcher-32. Each reads equal to h5py, and through the port's
`numpy_from_hdf5` and `LazyHDF5Volume` equal to the JAX package's, with the
same `chunks`; partial reads inflate only the chunks they meet; corrupt
checksums raise where h5py raises; what stays unsupported raises
NotImplementedError naming it."""

import itertools
import struct

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu.utils import base_data_utils as jax_utils
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils import hdf5

SHAPE = (24, 40, 48)
CHUNKS = (7, 16, 13)  # partial edge chunks on every axis


def volume(dtype="<u2", shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 300).astype(dtype)


# name -> (File keyword arguments, create_dataset keyword arguments, the
# region written after creation or None for data=, the chunk index).
VARIANTS = {
    "default_gzip": ({}, dict(chunks=True, compression="gzip"), None, "btree1"),
    "latest_fixed_array": ({"libver": "latest"},
                           dict(chunks=CHUNKS, compression="gzip"), None, "fixed"),
    "latest_fixed_array_max": ({"libver": "latest"},
                               dict(chunks=CHUNKS, maxshape=(30, 45, 50)),
                               np.s_[2:20, 3:30, 10:40], "fixed"),
    "latest_extensible_array": ({"libver": "latest"},
                                dict(chunks=CHUNKS, maxshape=(None, 40, 48),
                                     compression="gzip", shuffle=True),
                                None, "extensible"),
    "latest_extensible_array_middle": ({"libver": "latest"},
                                       dict(chunks=CHUNKS, maxshape=(30, None, 50)),
                                       np.s_[5:9, 3:20, :], "extensible"),
    "latest_btree2": ({"libver": "latest"},
                      dict(chunks=CHUNKS, maxshape=(None, None, 48),
                           compression="gzip"), None, "btree2"),
    "latest_btree2_unfiltered": ({"libver": "latest"},
                                 dict(chunks=CHUNKS, maxshape=(None, None, None)),
                                 np.s_[:10, 20:, 5:30], "btree2"),
    "latest_single_chunk": ({"libver": "latest"}, dict(chunks=SHAPE), None,
                            "single"),
    "latest_single_chunk_filtered": ({"libver": "latest"},
                                     dict(chunks=SHAPE, compression="gzip",
                                          fletcher32=True), None, "single"),
    "latest_single_chunk_unwritten": ({"libver": "latest"},
                                      dict(chunks=SHAPE, compression="gzip"),
                                      np.s_[0:0], "single"),
    "latest_contiguous": ({"libver": "latest"}, {}, None, None),
    "v108_superblock_2": ({"libver": ("v108", "latest")},
                          dict(chunks=CHUNKS, compression="gzip"), None, "btree1"),
    "user_block_512": ({"userblock_size": 512},
                       dict(chunks=True, compression="gzip"), None, "btree1"),
    "user_block_4096_latest": ({"userblock_size": 4096, "libver": "latest"},
                               dict(chunks=CHUNKS, maxshape=(None, 40, 48)),
                               None, "extensible"),
    "fletcher32": ({}, dict(chunks=CHUNKS, compression="gzip", shuffle=True,
                            fletcher32=True), None, "btree1"),
    "fletcher32_latest": ({"libver": "latest"},
                          dict(chunks=CHUNKS, maxshape=(None, 40, 48),
                               shuffle=True, compression="gzip",
                               fletcher32=True), np.s_[3:17], "extensible"),
    "fletcher32_alone": ({"libver": "latest"},
                         dict(chunks=CHUNKS, fletcher32=True), None, "fixed"),
}


def write_variant(path, name, dtype="<u2"):
    file_kw, ds_kw, region, _ = VARIANTS[name]
    vol = volume(dtype)
    with h5py.File(path, "w", **file_kw) as f:
        if region is None:
            f.create_dataset("data", data=vol, **ds_kw)
        else:
            ds = f.create_dataset("data", shape=SHAPE, dtype=dtype,
                                  fillvalue=np.array(17, dtype), **ds_kw)
            ds[region] = vol[region]
    return path


def write_implicit(path, dtype="<u2"):
    """The implicit index: chunks allocated when the dataset is made (early
    allocation, no filter), some of them written."""
    vol = volume(dtype)
    with h5py.File(path, "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(CHUNKS)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        dcpl.set_fill_value(np.array(17, dtype))
        h5py.h5d.create(f.id, b"data", h5py.h5t.py_create(np.dtype(dtype)),
                        h5py.h5s.create_simple(SHAPE), dcpl=dcpl)
        f["data"][:10, 5:] = vol[:10, 5:]
    return path


def chunk_index_type(path, name="data"):
    """The chunk index h5py's file uses, from the library's own answer."""
    with h5py.File(path, "r") as f:
        dcpl = f[name].id.get_create_plist()
        if dcpl.get_layout() != h5py.h5d.CHUNKED:
            return None
    with hdf5.File(path) as f:
        kind = f[name]._index_type
    return {hdf5.INDEX_BTREE1: "btree1", hdf5.INDEX_SINGLE: "single",
            hdf5.INDEX_IMPLICIT: "implicit", hdf5.INDEX_FIXED_ARRAY: "fixed",
            hdf5.INDEX_EXTENSIBLE_ARRAY: "extensible",
            hdf5.INDEX_BTREE2: "btree2"}[kind]


def assert_reads_equal(path, name="/data"):
    """The port reads `name` as h5py does; `numpy_from_hdf5` and
    `LazyHDF5Volume` as the JAX package's, with the same chunks."""
    with h5py.File(path, "r") as f:
        ref, ref_chunks, ref_max = f[name][()], f[name].chunks, f[name].maxshape
    with hdf5.File(path) as f:
        ds = f[name]
        got = ds[()]
        assert (ds.chunks, ds.maxshape, ds.shape) == (ref_chunks, ref_max,
                                                      ref.shape)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype.newbyteorder("=")
    ours, chunks = utils.numpy_from_hdf5(path, hdf5_path=name)
    theirs, jax_chunks = jax_utils.numpy_from_hdf5(path, hdf5_path=name)
    np.testing.assert_array_equal(ours, theirs)
    assert chunks == jax_chunks == ref_chunks
    lazy = utils.LazyHDF5Volume(path, hdf5_path=name)
    jax_lazy = jax_utils.LazyHDF5Volume(path, hdf5_path=name)
    try:
        assert lazy.chunks == jax_lazy.chunks
        np.testing.assert_array_equal(lazy[3:11], jax_lazy[3:11])
    finally:
        lazy.close()
        jax_lazy.close()
    return got


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variants_read_equal_h5py_and_jax(tmp_path, name):
    path = write_variant(tmp_path / "v.h5", name)
    assert chunk_index_type(path) == VARIANTS[name][3]
    got = assert_reads_equal(path)
    if VARIANTS[name][2] is not None:
        assert (got == 17).any()  # chunks never written take the fill value


@pytest.mark.parametrize("dtype", ["u1", ">i2", "<f4", ">f8"])
def test_implicit_index_reads_equal(tmp_path, dtype):
    path = write_implicit(tmp_path / "v.h5", dtype)
    assert chunk_index_type(path) == "implicit"
    assert (assert_reads_equal(path) == 17).any()


@pytest.mark.parametrize("dtype", [">u2", "<f4", "i1"])
@pytest.mark.parametrize("name", ["latest_fixed_array", "latest_extensible_array",
                                  "latest_btree2", "fletcher32"])
def test_indexes_in_other_types_read_equal(tmp_path, name, dtype):
    assert_reads_equal(write_variant(tmp_path / "v.h5", name, dtype))


SELECTIONS = [np.s_[3:11, :, 5], np.s_[0:1], np.s_[:, 15:17, 12:14],
              np.s_[-1, -1], np.s_[20:24, 39, 47], np.s_[5:5]]


def written_chunks(name, chunks):
    """The offsets of the chunks a variant wrote: those that meet its
    written region (every chunk of the implicit index is allocated). The
    library's own chunk query is not used: for an extensible array whose
    unlimited axis is not the first it gives other offsets."""
    region = None if name == "implicit" else VARIANTS[name][2]
    grid = itertools.product(*(range(0, s, c) for s, c in zip(SHAPE, chunks)))
    if region is None:
        return list(grid)
    return [o for o in grid if chunks_met([o], chunks, region, SHAPE)]


def chunks_met(offsets, chunks, sel, shape):
    ranges = []
    for k, size in itertools.zip_longest(sel if isinstance(sel, tuple) else (sel,),
                                         shape):
        if k is None:
            k = slice(None)
        if isinstance(k, slice):
            start, stop, _ = k.indices(size)
        else:
            start, stop = k % size, k % size + 1
        ranges.append((start, stop))
    return sum(all(o < b and o + c > a and b > a
                   for o, c, (a, b) in zip(offset, chunks, ranges))
               for offset in offsets)


@pytest.mark.parametrize("name", ["latest_fixed_array",
                                  "latest_fixed_array_max",
                                  "latest_extensible_array_middle",
                                  "latest_btree2", "latest_btree2_unfiltered",
                                  "latest_single_chunk", "default_gzip",
                                  "implicit", "fletcher32_latest"])
def test_partial_reads_inflate_only_the_chunks_they_meet(tmp_path, name):
    path = tmp_path / "v.h5"
    if name == "implicit":
        write_implicit(path)
    else:
        write_variant(path, name)
    with h5py.File(path, "r") as f, hdf5.File(path) as ours:
        ref_ds, ds = f["data"], ours["data"]
        offsets = written_chunks(name, ds.chunks)
        for sel in SELECTIONS:
            before = ds.inflated_chunks
            np.testing.assert_array_equal(ds[sel], ref_ds[sel])
            assert ds.inflated_chunks - before == chunks_met(
                offsets, ds.chunks, sel, ds.shape), sel


def test_paged_fixed_array(tmp_path):
    """More chunks than a page (1024) holds: the data block is paged, and
    a page never written is not initialised."""
    path = tmp_path / "v.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("full", data=np.arange(64 * 64, dtype="<f4").reshape(64, 64),
                         chunks=(1, 2), compression="gzip")
        sparse = f.create_dataset("sparse", shape=(64, 64), dtype="<f4",
                                  chunks=(1, 2), fillvalue=1.5)
        sparse[40:41] = 3
    for name in ("full", "sparse"):
        assert chunk_index_type(path, name) == "fixed"
        assert_reads_equal(path, name)
    with hdf5.File(path) as f:
        ds = f["sparse"]
        assert len(ds._chunk_index()) == 32
        ds[39:42]
        assert ds.inflated_chunks == 32


def test_extensible_array_super_blocks(tmp_path):
    """300 chunks along the unlimited axis: the index block's own entries,
    the data blocks it points to, then secondary super blocks."""
    path = tmp_path / "v.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("data", data=np.arange(300 * 16, dtype=">u2").reshape(
            300, 4, 4), chunks=(1, 4, 4), maxshape=(None, 4, 4))
        sparse = f.create_dataset("sparse", shape=(300, 4, 4), dtype="u1",
                                  chunks=(1, 4, 4), maxshape=(None, 4, 4),
                                  fillvalue=9)
        sparse[250:260] = 1
        sparse[3:5] = 2
    assert_reads_equal(path, "data")
    assert_reads_equal(path, "sparse")


def test_extensible_array_paged_data_blocks(tmp_path):
    """Past 131,060 chunks along the unlimited axis a data block holds
    2,048 entries, more than a page: its super block says which pages were
    initialised."""
    path = tmp_path / "v.h5"
    n = 140_000
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("data", shape=(n,), dtype="u1", chunks=(1,),
                             maxshape=(None,), fillvalue=9)
        d[:131_100] = np.arange(131_100) % 251
        d[132_000:133_500] = 5
        d[139_990:] = 7
        ref = d[131_000:]
    with hdf5.File(path) as f:
        ds = f["data"]
        assert ds._index_type == hdf5.INDEX_EXTENSIBLE_ARRAY
        assert len(ds._chunk_index()) == 131_100 + 1_500 + 10
        np.testing.assert_array_equal(ds[131_000:], ref)
        assert ds.inflated_chunks == 100 + 1_500 + 10


# ----------------------------------------------------------------------
# Checksums
# ----------------------------------------------------------------------


def corrupt(path, offset, out):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x10
    out.write_bytes(bytes(data))
    return out


@pytest.fixture()
def latest_file(tmp_path):
    path = tmp_path / "v.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("data", data=volume(), chunks=CHUNKS, fletcher32=True,
                         maxshape=(None, 40, 48))
    return path


def test_a_corrupt_superblock_raises(latest_file, tmp_path):
    bad = corrupt(latest_file, 30, tmp_path / "bad.h5")  # its EOF address
    with pytest.raises(OSError, match="checksum"):
        h5py.File(bad, "r")
    with pytest.raises(ValueError, match="superblock at 0 fails its checksum"):
        hdf5.File(bad)


@pytest.mark.parametrize("which", ["root", "dataset"])
def test_a_corrupt_object_header_raises(latest_file, tmp_path, which):
    data = latest_file.read_bytes()
    start = data.find(b"OHDR")
    if which == "dataset":
        start = data.find(b"OHDR", start + 4)
    bad = corrupt(latest_file, start + 30, tmp_path / "bad.h5")
    with pytest.raises(KeyError, match="checksum"):
        with h5py.File(bad, "r") as f:
            f["data"]
    with pytest.raises(ValueError, match=f"object header at {start} fails"):
        with hdf5.File(bad) as f:
            f["data"]


def test_a_corrupt_chunk_fails_its_fletcher32_checksum(latest_file, tmp_path):
    with h5py.File(latest_file, "r") as f:
        dsid = f["data"].id
        info = next(dsid.get_chunk_info(i) for i in range(dsid.get_num_chunks())
                    if dsid.get_chunk_info(i).chunk_offset[0] >= 7)
    bad = corrupt(latest_file, info.byte_offset + 100, tmp_path / "bad.h5")
    start = info.chunk_offset
    region = tuple(slice(o, o + c) for o, c in zip(start, CHUNKS))
    with h5py.File(bad, "r") as f:
        np.testing.assert_array_equal(f["data"][:7], volume()[:7])
        with pytest.raises(OSError):
            f["data"][region]
    with hdf5.File(bad) as f:
        np.testing.assert_array_equal(f["data"][:7], volume()[:7])
        with pytest.raises(ValueError, match="Fletcher-32"):
            f["data"][region]
        with pytest.raises(ValueError, match="Fletcher-32"):
            f["data"][()]


def test_checksum_functions_match_the_library():
    """lookup3 against the values in Bob Jenkins' lookup3.c driver, and
    Fletcher-32 against a plain loop of the library's, with its folds."""
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 719, 720, 721, 5001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        sum1 = sum2 = 0
        for start in range(0, n // 2, 360):
            for i in range(start, min(start + 360, n // 2)):
                sum1 += (data[2 * i] << 8) | data[2 * i + 1]
                sum2 += sum1
            sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
            sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
        if n % 2:
            sum1 += data[-1] << 8
            sum2 += sum1
            sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
            sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
        assert hdf5.fletcher32(data) == (sum2 << 16) | sum1, n
    assert hdf5.fletcher32(b"\xff\xff" * 3) == 0xFFFFFFFF


# ----------------------------------------------------------------------
# Features that stay unsupported
# ----------------------------------------------------------------------


def test_refused_features_raise_not_implemented_by_name(tmp_path, monkeypatch):
    """A filter the reader does not know and strings stay refused by name,
    and so do shared messages kept in the file's shared message index
    (SOHM) and dense attribute storage; h5py writes the last alone, and
    the first is patched into a file it writes (a committed datatype's
    shared message made an index entry), its header checksum made again.
    LZF, scale-offset, n-bit (at full and reduced precision), szip,
    external storage, virtual datasets and unfiltered partial edge chunks
    (chunk option flag 1, patched into a layout message here), refused
    before, now read as h5py reads them (tests/test_torch_hdf5_filters.py,
    _virtual.py and _edge_chunks.py test them in full, and committed
    datatypes and reduced precision below)."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "r.h5"
    vol = volume("u1")
    (tmp_path / "raw.bin").write_bytes(bytes(range(10)))
    with h5py.File(path, "w") as f:
        f.create_dataset("lzf", data=vol, compression="lzf")
        f.create_dataset("szip", data=vol.astype("<i4"), compression="szip")
        f.create_dataset("scaleoffset", data=vol.astype("<i4"), scaleoffset=0)
        f.create_dataset("external", shape=(10,), dtype="u1",
                         external=[(str(tmp_path / "raw.bin"), 0, 10)])
        layout = h5py.VirtualLayout(shape=(4,), dtype="u1")
        layout[:] = h5py.VirtualSource(str(tmp_path / "other.h5"), "data",
                                       shape=(4,))
        f.create_virtual_dataset("virtual", layout)
        f["strings"] = np.array([b"ab", b"cd"])
        for name, precision in (("nbit", 8), ("nbit_reduced", 5)):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((8, 8))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT)
            datatype = h5py.h5t.STD_U8LE.copy()
            datatype.set_precision(precision)
            h5py.h5d.create(f.id, name.encode(), datatype,
                            h5py.h5s.create_simple((16, 16)), dcpl=dcpl)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8, 8))
        dcpl.set_filter(307, h5py.h5z.FLAG_OPTIONAL, (9,))  # bzip2
        h5py.h5d.create(f.id, b"bzip2", h5py.h5t.STD_U8LE,
                        h5py.h5s.create_simple((16, 16)), dcpl=dcpl)
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f["t"] = np.dtype("<u2")
        f.create_dataset("sohm", data=np.arange(6, dtype="<u2"), dtype=f["t"])
        f.create_dataset("partial_edge", data=np.arange(400, dtype="u1").reshape(
            20, 20), chunks=(16, 16))
        dense = f.create_dataset("dense", data=np.arange(4))
        for i in range(12):  # more than the 8 an object header holds
            dense.attrs[f"a{i}"] = i
    with hdf5.File(latest) as f:
        sohm = f._messages(f._resolve("sohm", [16])[1])[hdf5.MSG_DATATYPE][0][1]
        edge = f._messages(f._resolve("partial_edge", [16])[1])[hdf5.MSG_LAYOUT][0][1]
        base = f._base
    # Version 3 of the shared message encoding, kind 1: a heap ID in the
    # index where h5py wrote version 2, kind 2 (another object's header).
    patch_object_header(latest, "sohm", base + sohm, bytes([3, 1]))
    patch_object_header(latest, "partial_edge", base + edge + 2, bytes([1]))
    for file, name, feature in (
            (path, "bzip2", "filter 307 \\(unknown"),
            (path, "strings", "datatype class 3"),
            (latest, "sohm", "shared message index \\(SOHM\\)")):
        with pytest.raises(NotImplementedError, match=feature):
            hdf5.read(file, name)
    with h5py.File(latest, "r") as f:
        np.testing.assert_array_equal(hdf5.read(latest, "partial_edge")[0],
                                      f["partial_edge"][()])
    with hdf5.File(latest) as f, pytest.raises(NotImplementedError,
                                               match="dense attribute storage"):
        f["dense"].attrs
    for name in ("lzf", "szip", "scaleoffset", "nbit", "nbit_reduced", "external",
                 "virtual"):
        with h5py.File(path, "r") as f:
            ref = f[name][()]
        np.testing.assert_array_equal(hdf5.read(path, name)[0], ref)


def patch_object_header(path, name, offset, new: bytes):
    """`new` written at `offset` of the file, inside the version 2 object
    header of `name`, whose lookup3 checksum is then made again."""
    with hdf5.File(path) as f:
        addr = f._resolve(name, [16])[1]
        flags = f._buf[addr + 5]
        p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 0x3)
        start, end = f._base + addr, f._base + p + width + f._uint(p, width)
    raw = bytearray(path.read_bytes())
    assert start < offset < end
    raw[offset:offset + len(new)] = new
    struct.pack_into("<I", raw, end, hdf5.lookup3(bytes(raw[start:end])))
    path.write_bytes(bytes(raw))


# ----------------------------------------------------------------------
# Committed datatypes and reduced-precision integers
# ----------------------------------------------------------------------


def assert_reads_equal_everywhere(path, name="data", selections=()):
    """`assert_reads_equal`, the basic `selections` equal to h5py's, and
    the port's `get_numpy_from_path` equal to the JAX package's."""
    got = assert_reads_equal(path, name)
    with h5py.File(path, "r") as f:
        refs = [f[name][sel] for sel in selections]
    with hdf5.File(path) as f:
        for sel, ref in zip(selections, refs):
            np.testing.assert_array_equal(f[name][sel], ref)
    ours, chunks = utils.get_numpy_from_path(path, name)
    theirs, jax_chunks = jax_utils.get_numpy_from_path(path, name)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype.newbyteorder("=") and chunks == jax_chunks
    return got


@pytest.mark.parametrize("dtype", ["u1", "<i2", ">u2", "<i4", ">u4", "<i8", "<f4",
                                   ">f8"])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_committed_datatypes_read_equal_h5py_and_jax(tmp_path, libver, dtype):
    """A dataset and an attribute typed by a committed (named) datatype:
    their datatype messages are shared messages (encoding version 2 at
    either libver) pointing at the type's own object header."""
    path = tmp_path / "committed.h5"
    data = volume(dtype)
    with h5py.File(path, "w", libver=libver) as f:
        f["types/voxel"] = np.dtype(dtype)
        chunked = f.create_dataset("data", data=data, dtype=f["types/voxel"],
                                   chunks=CHUNKS, compression="gzip")
        chunked.attrs.create("scale", data[0, 0, :3], dtype=f["types/voxel"])
        f.create_dataset("contiguous", data=data, dtype=f["types/voxel"])
    with hdf5.File(path) as f:
        flags = f._messages(f._resolve("data", [16])[1])[hdf5.MSG_DATATYPE][0][0]
        attrs = f["data"].attrs
    assert flags & 0x2  # shared
    with h5py.File(path, "r") as f:
        ref_attrs = dict(f["data"].attrs)
    np.testing.assert_array_equal(attrs["scale"], ref_attrs["scale"])
    assert attrs["scale"].dtype == ref_attrs["scale"].dtype.newbyteorder("=")
    for name in ("data", "contiguous"):
        got = assert_reads_equal_everywhere(path, name, SELECTIONS)
        np.testing.assert_array_equal(got, data)


# (base type, precision, bit offset): the library refuses a type that leaves
# a whole byte unused.
REDUCED = [("STD_U8LE", 5, 2), ("STD_I8LE", 7, 1), ("STD_U16LE", 12, 0),
           ("STD_U16BE", 12, 3), ("STD_I16LE", 11, 5), ("STD_I16BE", 10, 6),
           ("STD_U32LE", 27, 2), ("STD_I32BE", 30, 2), ("STD_I64LE", 61, 3)]


def reduced_type(base, precision, offset):
    datatype = getattr(h5py.h5t, base).copy()
    datatype.set_precision(precision)
    datatype.set_offset(offset)
    return datatype


def reduced_values(datatype, shape=SHAPE, seed=0):
    """Values that fit `datatype`'s precision, in its full-width numpy
    type."""
    precision, size = datatype.get_precision(), datatype.get_size()
    signed = datatype.get_sign() == h5py.h5t.SGN_2
    lo, hi = ((-(1 << (precision - 1)), (1 << (precision - 1)) - 1) if signed
              else (0, (1 << precision) - 1))
    values = np.random.default_rng(seed).integers(lo, hi, shape, endpoint=True)
    return values.astype(f"{'i' if signed else 'u'}{size}")


@pytest.mark.parametrize("chunked", [False, True], ids=["contiguous", "chunked"])
@pytest.mark.parametrize("base, precision, offset", REDUCED,
                         ids=[f"{b}-{p}-{o}" for b, p, o in REDUCED])
def test_reduced_precision_integers_read_equal_h5py_and_jax(tmp_path, base,
                                                            precision, offset,
                                                            chunked):
    """Integers of `precision` bits from bit `offset`, unfiltered (the
    n-bit filter's packing is tests/test_torch_hdf5_filters.py's): the
    library converts each to the full-width type, sign-extended."""
    datatype = reduced_type(base, precision, offset)
    data = reduced_values(datatype)
    path = tmp_path / "reduced.h5"
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        if chunked:
            dcpl.set_chunk(CHUNKS)
            dcpl.set_fill_value(data[:1, :1, :1].ravel())
        ds = h5py.h5d.create(f.id, b"data", datatype,
                             h5py.h5s.create_simple(SHAPE), dcpl=dcpl)
        region = np.s_[:, :32] if chunked else np.s_[...]  # whole chunks
        f["data"][region] = data[region]
    got = assert_reads_equal_everywhere(path, "data", SELECTIONS)
    expected = data.copy()
    if chunked:  # chunks never written take the (converted) fill value
        expected[:, 32:] = data[0, 0, 0]
    np.testing.assert_array_equal(got, expected)
    with hdf5.File(path) as f:
        assert f["data"]._bits == (offset, precision)


def test_padding_bits_of_reduced_precision_types_are_dropped(tmp_path):
    """h5py reads a reduced-precision integer as the library converts it:
    the bits outside the precision (here set, in full-width data whose
    type is then patched to 9 bits at bit 3, and signed 12 at bit 2) are
    dropped, and the sign bit extended."""
    path = tmp_path / "padded.h5"
    rng = np.random.default_rng(4)
    unsigned = rng.integers(0, 1 << 16, (6, 7), dtype=np.uint16)
    signed = rng.integers(-(1 << 15), 1 << 15, (6, 7), dtype=np.int16)
    with h5py.File(path, "w") as f:
        f["unsigned"] = unsigned
        f["signed"] = signed
    raw = bytearray(path.read_bytes())
    with hdf5.File(path) as f:
        for name, (offset, precision) in (("unsigned", (3, 9)), ("signed", (2, 12))):
            d = f._messages(f._resolve(name, [16])[1])[hdf5.MSG_DATATYPE][0][1]
            struct.pack_into("<HH", raw, f._base + d + 8, offset, precision)
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as f:
        ref = {name: f[name][()] for name in ("unsigned", "signed")}
    np.testing.assert_array_equal(ref["unsigned"], (unsigned >> 3) & 0x1FF)
    twelve = (signed.view(np.uint16) >> 2) & 0xFFF
    np.testing.assert_array_equal(ref["signed"], np.where(
        twelve & 0x800, twelve.astype(np.int32) - 0x1000, twelve))
    for name in ("unsigned", "signed"):
        got = hdf5.read(path, name)[0]
        assert got.dtype == ref[name].dtype
        np.testing.assert_array_equal(got, ref[name])
