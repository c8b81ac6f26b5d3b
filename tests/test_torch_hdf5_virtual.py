"""The port's HDF5 reader (`utils/hdf5.py`) on data that lie in other
files: external raw storage (segments of raw files, found as the library
finds them, in the working directory or under $HDF5_EXTFILE_PREFIX) and
virtual datasets (mappings from sources in the same file, a sibling file,
a missing file or another virtual dataset; "all", regular, strided and
irregular selections in each encoding the library writes; found under
$HDF5_VDS_PREFIX, beside the virtual dataset's file and in the working
directory). Each file is built here by h5py and read whole and by basic
selections equal to h5py's reading. A partial read opens only the sources
and inflates only the chunks its box meets, in one thread pool. What
stays unsupported raises NotImplementedError naming it. End to end, the
port's `numpy_from_hdf5` and `LazyHDF5Volume` equal the JAX package's
`numpy_from_hdf5` on a NeXus file whose data is a virtual dataset over LZF
sources."""

import json
import os
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu.utils import base_data_utils as jax_utils
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils import hdf5

SELECTIONS = [(), np.s_[1], np.s_[1:6, 3:11, 2:9], np.s_[-1, :, 4], np.s_[5, 2, 7],
              np.s_[2:2]]


def volume(shape, dtype="<u2", seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, shape).astype(dtype)


def assert_reads_equal(path, name, selections=SELECTIONS):
    with h5py.File(path, "r") as f:
        refs = [f[name][sel] for sel in selections]
        ref_chunks = f[name].chunks
    with hdf5.File(path) as f:
        ds = f[name]
        assert ds.chunks == ref_chunks
        for sel, ref in zip(selections, refs):
            got = ds[sel]
            assert np.asarray(got).dtype == np.asarray(ref).dtype.newbyteorder("=")
            np.testing.assert_array_equal(got, ref)
    return refs[0]


def h5py_read_with_env(path, name, env):
    """h5py's reading in a new process: the library reads
    $HDF5_EXTFILE_PREFIX and $HDF5_VDS_PREFIX when it starts."""
    code = ("import sys, json, h5py; f = h5py.File(sys.argv[1], 'r'); "
            "print(json.dumps(f[sys.argv[2]][()].tolist()))")
    out = subprocess.run([sys.executable, "-c", code, str(path), name],
                         env={**os.environ, **env}, capture_output=True,
                         text=True, check=True)
    return np.array(json.loads(out.stdout))


# ----------------------------------------------------------------------
# External raw storage
# ----------------------------------------------------------------------


def write_external(folder, data, names, sizes, offsets):
    """`data` in external segments: its bytes cut at `sizes` (the last
    unlimited), each written at its offset into its file (files may be
    shared)."""
    raw = data.tobytes()
    files, start = {}, 0
    for name, size, offset in zip(names, sizes, offsets):
        part = raw[start:] if size is None else raw[start:start + size]
        start += len(part)
        blob = files.setdefault(name, bytearray())
        blob.extend(bytes(max(0, offset + len(part) - len(blob))))
        blob[offset:offset + len(part)] = part
    for name, blob in files.items():
        (folder / name).parent.mkdir(parents=True, exist_ok=True)
        (folder / name).write_bytes(bytes(blob))
    return [(name, offset, h5py.h5f.UNLIMITED if size is None else size)
            for name, size, offset in zip(names, sizes, offsets)]


@pytest.mark.parametrize("dtype", ["u1", ">i2", "<f4"])
def test_external_storage_reads_equal_h5py(tmp_path, monkeypatch, dtype):
    """Segments of 1000, 333 and the rest bytes (cut inside elements and
    rows), in two files, one at an offset; relative names are found in
    the working directory, as h5py 3.14 finds them."""
    monkeypatch.chdir(tmp_path)
    data = volume((8, 12, 16), dtype)
    external = write_external(tmp_path, data, ["a.raw", "b.raw", "a.raw"],
                              [1000, 333, None], [0, 7, 1500])
    with h5py.File("ext.h5", "w") as f:
        f.create_dataset("data", shape=data.shape, dtype=data.dtype,
                         external=external)
    np.testing.assert_array_equal(assert_reads_equal("ext.h5", "data"), data)


def test_external_storage_short_and_missing_files(tmp_path, monkeypatch):
    """A file shorter than its segment reads as zeros past its end; a
    missing file raises OSError, as h5py's read does; a partial read
    touches only the segments it needs."""
    monkeypatch.chdir(tmp_path)
    data = volume((6, 10, 10), "u1")
    external = write_external(tmp_path, data, ["a.raw", "b.raw"], [300, 300],
                              [0, 0])
    with h5py.File("ext.h5", "w") as f:
        f.create_dataset("data", shape=data.shape, dtype=data.dtype,
                         external=external)
    (tmp_path / "b.raw").write_bytes(data.tobytes()[300:450])  # 150 bytes short
    got = assert_reads_equal("ext.h5", "data")
    np.testing.assert_array_equal(got.ravel()[:450], data.ravel()[:450])
    np.testing.assert_array_equal(got.ravel()[450:], 0)
    (tmp_path / "b.raw").unlink()
    with hdf5.File("ext.h5") as f:
        np.testing.assert_array_equal(f["data"][:3], data[:3])
        with h5py.File("ext.h5", "r") as ref, pytest.raises(OSError):
            ref["data"][3]
        with pytest.raises(OSError):
            f["data"][3]


def test_external_storage_under_the_extfile_prefix(tmp_path, monkeypatch):
    """Under $HDF5_EXTFILE_PREFIX ("${ORIGIN}" at its start is the HDF5
    file's directory, or a directory as it is) relative names are taken
    from the prefix, not the working directory."""
    data = volume((6, 9, 7), "<i4")
    (tmp_path / "files").mkdir()
    external = write_external(tmp_path / "files" / "raw", data, ["x.raw", "y.raw"],
                              [500, None], [3, 0])
    path = tmp_path / "files" / "ext.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", shape=data.shape, dtype=data.dtype,
                         external=external)
    monkeypatch.chdir(tmp_path)
    with hdf5.File(path) as f, pytest.raises(OSError):
        f["data"][()]
    for prefix in ("${ORIGIN}/raw", str(tmp_path / "files" / "raw")):
        monkeypatch.setenv("HDF5_EXTFILE_PREFIX", prefix)
        ref = h5py_read_with_env(path, "data", {"HDF5_EXTFILE_PREFIX": prefix})
        np.testing.assert_array_equal(ref, data)
        with hdf5.File(path) as f:
            np.testing.assert_array_equal(f["data"][()], data)
            np.testing.assert_array_equal(f["data"][2:4, 5], data[2:4, 5])


# ----------------------------------------------------------------------
# Virtual datasets
# ----------------------------------------------------------------------


def write_sources(folder, parts, compression="lzf", libver="earliest"):
    """Each array of `parts` as /data of part_<i>.h5, chunked."""
    for i, part in enumerate(parts):
        with h5py.File(folder / f"part_{i}.h5", "w", libver=libver) as f:
            f.create_dataset("data", data=part, chunks=(3, 5, 4),
                             compression=compression)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_sources_in_the_same_file_a_sibling_file_and_a_missing_file(
        tmp_path, monkeypatch, libver):
    """Four (4, 12, 10) slabs: from a sibling file (relative name, found
    beside the virtual dataset's file from another working directory), the
    same file ("."), a missing file and a missing dataset (both the fill
    value), and a strided half of a sibling's source."""
    parts = [volume((4, 12, 10), seed=i) for i in range(3)]
    write_sources(tmp_path, parts[:1], libver=libver)
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("local", data=parts[1], chunks=(2, 6, 5),
                         compression="gzip")
        layout = h5py.VirtualLayout(shape=(16, 12, 10), dtype="<u2")
        layout[0:4] = h5py.VirtualSource("part_0.h5", "data", shape=(4, 12, 10))
        layout[4:8] = h5py.VirtualSource(f["local"])
        layout[8:12] = h5py.VirtualSource("missing.h5", "data", shape=(4, 12, 10))
        layout[12:16, :, 0:10:2] = h5py.VirtualSource(
            "part_0.h5", "no_such", shape=(4, 12, 5))
        layout[12:14, ::2, 1:10:2] = h5py.VirtualSource(
            "part_0.h5", "data", shape=(4, 12, 10))[:2, 6:12, 0:5]
        f.create_virtual_dataset("data", layout, fillvalue=77)
    monkeypatch.chdir(tmp_path.parent)
    got = assert_reads_equal(path, "data")
    np.testing.assert_array_equal(got[0:4], parts[0])
    np.testing.assert_array_equal(got[4:8], parts[1])
    np.testing.assert_array_equal(got[8:12], 77)
    np.testing.assert_array_equal(got[12:14, ::2, 1::2], parts[0][:2, 6:12, 0:5])
    with hdf5.File(path) as f:
        ds = f["data"]
        assert ds.chunks is None and ds._mappings[1].file_name == "."


def test_a_virtual_dataset_of_a_virtual_dataset(tmp_path):
    parts = [volume((4, 12, 10), seed=i) for i in range(2)]
    write_sources(tmp_path, parts)
    inner = h5py.VirtualLayout(shape=(8, 12, 10), dtype="<u2")
    for i in range(2):
        inner[4 * i:4 * i + 4] = h5py.VirtualSource(f"part_{i}.h5", "data",
                                                    shape=(4, 12, 10))
    with h5py.File(tmp_path / "inner.h5", "w") as f:
        f.create_virtual_dataset("data", inner, fillvalue=5)
    outer = h5py.VirtualLayout(shape=(10, 12, 10), dtype="<u4")
    outer[1:9] = h5py.VirtualSource("inner.h5", "data", shape=(8, 12, 10))
    with h5py.File(tmp_path / "outer.h5", "w") as f:
        f.create_virtual_dataset("data", outer, fillvalue=9)
    got = assert_reads_equal(tmp_path / "outer.h5", "data")
    np.testing.assert_array_equal(got[1:9], np.concatenate(parts))
    assert got.dtype == np.uint32


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_irregular_and_reshaped_selections(tmp_path, libver):
    """A virtual selection that is a union of blocks of other shapes,
    filled from one block of the source in row-major order; a (3, 4, 5)
    block filled from a (60,) source; a strided selection in every
    dimension."""
    src = volume((6, 7, 8), seed=3)
    line = volume((60,), seed=4)
    with h5py.File(tmp_path / "src.h5", "w", libver=libver) as f:
        f.create_dataset("data", data=src, chunks=(2, 3, 4), compression="lzf")
        f.create_dataset("line", data=line)
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w", libver=libver) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.VIRTUAL)
        dcpl.set_fill_value(np.array([3], "<u2"))
        vspace = h5py.h5s.create_simple((9, 10, 11))
        vspace.select_hyperslab((0, 0, 0), (1, 1, 1), block=(2, 2, 2))
        vspace.select_hyperslab((3, 3, 3), (1, 1, 1), block=(1, 2, 3),
                                op=h5py.h5s.SELECT_OR)
        vspace.select_hyperslab((1, 1, 5), (1, 1, 1), block=(3, 1, 2),
                                op=h5py.h5s.SELECT_OR)
        sspace = h5py.h5s.create_simple((6, 7, 8))
        sspace.select_hyperslab((1, 2, 0), (1, 1, 1), block=(1, 4, 5))
        dcpl.set_virtual(vspace, b"src.h5", b"data", sspace)
        vspace = h5py.h5s.create_simple((9, 10, 11))
        vspace.select_hyperslab((5, 4, 6), (1, 1, 1), block=(3, 4, 5))
        dcpl.set_virtual(vspace, b"src.h5", b"line", h5py.h5s.create_simple((60,)))
        vspace = h5py.h5s.create_simple((9, 10, 11))
        vspace.select_hyperslab((0, 6, 0), (2, 2, 3), stride=(4, 2, 3),
                                block=(1, 1, 2))
        sspace = h5py.h5s.create_simple((6, 7, 8))
        sspace.select_hyperslab((0, 0, 1), (2, 3, 4), stride=(3, 2, 2))
        dcpl.set_virtual(vspace, b"src.h5", b"data", sspace)
        h5py.h5d.create(f.id, b"data", h5py.h5t.STD_U16LE,
                        h5py.h5s.create_simple((9, 10, 11)), dcpl=dcpl)
    got = assert_reads_equal(path, "data")
    np.testing.assert_array_equal(got[5:8, 4:8, 6:11].ravel(), line)
    with hdf5.File(path) as f:
        mappings = f["data"]._mappings
        assert mappings[0].virtual.flat is not None  # not a product
        assert mappings[2].virtual.axes is not None


@pytest.mark.parametrize("length, libver, encoding", [
    (70_000, "latest", (3, 4)),
    (2**33, "latest", (3, 8)),
    (2**33, "earliest", (2, 8)),
])
def test_hyperslab_encodings_by_extent(tmp_path, length, libver, encoding):
    """Coordinates past 2^16 take 4-byte numbers in version 3; past 2^32
    8-byte ones, in version 2 where the file's lower bound is the earliest
    (a regular selection)."""
    data = volume((50,), seed=5)
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f.create_dataset("data", data=data)
    layout = h5py.VirtualLayout(shape=(length,), dtype="<u2")
    start = length - 70
    layout[start:start + 50] = h5py.VirtualSource("src.h5", "data", shape=(50,))
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_virtual_dataset("data", layout, fillvalue=1)
    raw = path.read_bytes()
    assert raw.count(b"src.h5\0data\0") == 1
    p = raw.index(b"src.h5\0data\0") + len(b"src.h5\0data\0")
    p += 16  # the source's "all" selection
    version = int.from_bytes(raw[p + 4:p + 8], "little")
    size = raw[p + 9] if version == 3 else 8
    assert (version, size) == encoding
    sel = np.s_[start - 5:start + 60]
    with h5py.File(path, "r") as f:
        ref = f["data"][sel]
    with hdf5.File(path) as f:
        ds = f["data"]
        assert ds.shape == (length,)
        np.testing.assert_array_equal(ds[sel], ref)
    np.testing.assert_array_equal(ref[5:55], data)


def test_partial_reads_open_and_inflate_only_what_they_meet(tmp_path, monkeypatch):
    """Eight mappings from four source files (two halves of each): a box
    in one mapping opens its file alone and inflates only its chunks; the
    whole read opens each file once and runs one thread pool."""
    parts = [volume((4, 12, 10), seed=i) for i in range(4)]
    write_sources(tmp_path, parts)
    layout = h5py.VirtualLayout(shape=(8, 12, 20), dtype="<u2")
    for i in range(4):
        source = h5py.VirtualSource(f"part_{i}.h5", "data", shape=(4, 12, 10))
        z, x = 4 * (i // 2), 10 * (i % 2)
        layout[z:z + 4, :, x:x + 5] = source[:, :, :5]
        layout[z:z + 4, :, x + 5:x + 10] = source[:, :, 5:]
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("data", layout)
        f.create_virtual_dataset("twice", layout)
    pools = []

    class CountedPool(ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            pools.append(self)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(hdf5, "ThreadPoolExecutor", CountedPool)
    with hdf5.File(path) as f:
        ds = f["data"]
        np.testing.assert_array_equal(ds[5:7, 3:9, 12:15], parts[3][1:3, 3:9, 2:5])
        assert ds.opened_sources == 1
        # Chunks (3, 5, 4) of part_3 meeting [1:3, 3:9, 2:5]: 1 x 2 x 2.
        assert ds.inflated_chunks == 4
        got = ds[()]
        assert ds.opened_sources == 4
        # Each half of a source meets 2 x 3 x 2 of its chunks.
        assert ds.inflated_chunks == 4 + 4 * 2 * (2 * 3 * 2)
        assert len(pools) == 2
    np.testing.assert_array_equal(got, np.concatenate([
        np.concatenate(parts[:2], axis=2), np.concatenate(parts[2:], axis=2)]))


def test_sources_found_under_the_vds_prefix(tmp_path, monkeypatch):
    parts = [volume((4, 12, 10), seed=7)]
    (tmp_path / "sources").mkdir()
    write_sources(tmp_path / "sources", parts)
    layout = h5py.VirtualLayout(shape=(4, 12, 10), dtype="<u2")
    layout[:] = h5py.VirtualSource("part_0.h5", "data", shape=(4, 12, 10))
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("data", layout, fillvalue=2)
    monkeypatch.chdir(tmp_path)
    np.testing.assert_array_equal(hdf5.read(path, "data")[0], 2)
    for prefix in ("${ORIGIN}/sources", str(tmp_path / "sources")):
        monkeypatch.setenv("HDF5_VDS_PREFIX", prefix)
        ref = h5py_read_with_env(path, "data", {"HDF5_VDS_PREFIX": prefix})
        np.testing.assert_array_equal(ref, parts[0])
        np.testing.assert_array_equal(hdf5.read(path, "data")[0], ref)


def test_refused_mappings_raise_not_implemented_by_name(tmp_path):
    """Point selections stay refused by name. Unlimited mappings and
    printf-style (%b) source names, refused before, now read as h5py
    reads them, their shape too (the sources of %b are missing: no
    block); a literal "%%" in a name is read as "%"."""
    data = volume((4,), seed=1)
    with h5py.File(tmp_path / "100%.h5", "w") as f:
        f.create_dataset("data", data=data)
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        def virtual(name, vspace, source_file, source_space):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.VIRTUAL)
            dcpl.set_virtual(vspace, source_file, b"data", source_space)
            h5py.h5d.create(f.id, name, h5py.h5t.STD_U16LE,
                            h5py.h5s.create_simple((8,), (h5py.h5s.UNLIMITED,)),
                            dcpl=dcpl)

        block = h5py.h5s.create_simple((8,))
        block.select_hyperslab((1,), (1,), block=(2,))
        two = h5py.h5s.create_simple((4,))
        two.select_hyperslab((0,), (1,), block=(2,))
        virtual(b"points", block, b"100%%.h5", two)
        unlimited = h5py.h5s.create_simple((8,), (h5py.h5s.UNLIMITED,))
        unlimited.select_hyperslab((0,), (h5py.h5s.UNLIMITED,), stride=(4,),
                                   block=(4,))
        source = h5py.h5s.create_simple((4,), (h5py.h5s.UNLIMITED,))
        source.select_hyperslab((0,), (1,), block=(4,))
        virtual(b"printf", unlimited, b"src_%b.h5", source)
        source = h5py.h5s.create_simple((8,), (h5py.h5s.UNLIMITED,))
        source.select_hyperslab((0,), (h5py.h5s.UNLIMITED,), stride=(4,),
                                block=(4,))
        virtual(b"unlimited", unlimited.copy(), b"100%%.h5", source)
        fixed = h5py.h5s.create_simple((8,))
        fixed.select_hyperslab((2,), (1,), block=(4,))
        virtual(b"percent", fixed, b"100%%.h5", h5py.h5s.create_simple((4,)))
    # HDF5 1.14.6 refuses point selections in mappings when it writes
    # them: the "points" mapping's virtual selection, a (version 1) block of
    # 2, is rewritten as a (version 1) selection of points 1 and 3, of the
    # same length, and the mapping list's checksum made again.
    raw = bytearray(path.read_bytes())
    block = struct.pack("<8I", 2, 1, 0, 16, 1, 1, 1, 2)
    at = raw.index(block)
    raw[at:at + 32] = struct.pack("<8I", 1, 1, 0, 16, 1, 2, 1, 3)
    with hdf5.File(path) as f:
        layout = f._messages(f._resolve("points", [16])[1])[hdf5.MSG_LAYOUT][0][1]
        collection, index = f._u("QI", layout + 2)
        p = collection + 16
        while f._u("H", p)[0] != index:
            p += 16 + f._u("Q", p + 8)[0] + (-f._u("Q", p + 8)[0] % 8)
        size = f._u("Q", p + 8)[0]
        blob_at = f._base + p + 16
    blob = bytes(raw[blob_at:blob_at + size - 4])
    struct.pack_into("<I", raw, blob_at + size - 4, hdf5.lookup3(blob))
    path.write_bytes(bytes(raw))
    with hdf5.File(path) as f, pytest.raises(NotImplementedError,
                                             match="point selections"):
        f["points"]
    for name in ("printf", "unlimited", "percent"):
        assert_reads_equal(path, name, [()] if name == "printf" else
                           [(), np.s_[1:3]])
    with h5py.File(path, "r") as f:
        ref = {name: f[name][()] for name in ("printf", "unlimited", "percent")}
    assert ref["printf"].shape == (0,)
    np.testing.assert_array_equal(ref["unlimited"], data)
    np.testing.assert_array_equal(ref["percent"][2:6], data)


# ----------------------------------------------------------------------
# Unlimited and printf-style (%b) mappings, and sources of other types
# ----------------------------------------------------------------------


SMALL_SELECTIONS = [(), np.s_[1], np.s_[1:3, 1:, 2:], np.s_[-1, 0]]


def assert_reads_everywhere(path, name="data", selections=SMALL_SELECTIONS):
    """`assert_reads_equal`, and the port's `get_numpy_from_path` and a
    `LazyHDF5Volume` slab equal to the JAX package's, h5py's shape too."""
    got = assert_reads_equal(path, name, selections)
    with h5py.File(path, "r") as f:
        assert hdf5.File(path)[name].shape == f[name].shape == got.shape
        slab = f[name][1:3]
    ours, chunks = utils.get_numpy_from_path(path, name)
    theirs, jax_chunks = jax_utils.get_numpy_from_path(path, name)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype.newbyteorder("=") and chunks == jax_chunks
    lazy = utils.LazyHDF5Volume(path, hdf5_path=name)
    try:
        assert lazy.shape == got.shape
        np.testing.assert_array_equal(lazy[1:3], slab)
    finally:
        lazy.close()
    return got


def create_virtual(path, name, shape, maxshape, dtype, mappings, fill=0):
    """A virtual dataset through h5py's low level: `mappings` are
    (virtual space, source file, source dataset, source space)."""
    with h5py.File(path, "a", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_fill_value(np.array([fill], dtype))
        for vspace, source_file, source_name, sspace in mappings:
            dcpl.set_virtual(vspace, source_file.encode(), source_name.encode(),
                             sspace)
        h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(np.dtype(dtype)),
                        h5py.h5s.create_simple(shape, maxshape), dcpl=dcpl).close()


def hyperslab(shape, maxshape, start, count, stride=None, block=None):
    space = h5py.h5s.create_simple(shape, maxshape)
    space.select_hyperslab(start, count, stride, block)
    return space


UNLIMITED = h5py.h5s.UNLIMITED


def test_an_unlimited_mapping_follows_its_source_as_it_grows(tmp_path):
    """`layout[0:UNLIMITED] = source[0:UNLIMITED]`: the virtual dataset's
    extent is its source's, as h5py decides it when it opens the dataset
    (the last available view), not the one stored when it was written."""
    grown = volume((7, 12, 10), seed=3)
    with h5py.File(tmp_path / "src.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=grown[:3], maxshape=(None, 12, 10),
                         chunks=(2, 6, 5))
    src = h5py.VirtualSource("src.h5", "data", shape=(3, 12, 10),
                             maxshape=(None, 12, 10))
    layout = h5py.VirtualLayout(shape=(3, 12, 10), maxshape=(None, 12, 10),
                                dtype="<u2")
    layout[0:UNLIMITED] = src[0:UNLIMITED]
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("data", layout, fillvalue=9)
    np.testing.assert_array_equal(assert_reads_everywhere(path), grown[:3])
    with h5py.File(tmp_path / "src.h5", "a") as f:
        f["data"].resize((7, 12, 10))
        f["data"][3:] = grown[3:]
    np.testing.assert_array_equal(assert_reads_everywhere(path), grown)
    with hdf5.File(path) as f:
        assert f["data"].maxshape == (None, 12, 10)


def test_unlimited_mappings_of_strided_blocks_and_other_axes(tmp_path):
    """Unlimited counts of strided blocks and unlimited blocks, a source
    unlimited in another axis than its virtual selection, a last block cut
    short, a missing source (no slices) and a limited mapping past the
    unlimited ones, which the extent keeps (the fill value between)."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1000, (5, 4, 3)).astype("<i4")  # 5 slices along 0
    b = rng.integers(0, 1000, (4, 3, 7)).astype("<i4")  # 7 slices along 2
    for name, arr in (("a.h5", a), ("b.h5", b)):
        with h5py.File(tmp_path / name, "w") as f:
            f.create_dataset("data", data=arr)
    vshape, vmax = (2, 4, 3), (UNLIMITED, 4, 3)
    path = tmp_path / "vds.h5"
    create_virtual(path, "strided", vshape, vmax, "<i4", [
        # blocks of 2 every 3: 5 slices end in a block cut to 1 (extent 7)
        (hyperslab(vshape, vmax, (0, 0, 0), (UNLIMITED, 1, 1), (3, 1, 1),
                   (2, 4, 3)), "a.h5", "data",
         hyperslab((5, 4, 3), None, (0, 0, 0), (1, 1, 1), None,
                   (UNLIMITED, 4, 3)))], fill=-1)
    create_virtual(path, "blocks", (12, 4, 3), vmax, "<i4", [
        # one unlimited block from 1 <- b's slices along axis 2, in blocks
        # of 3 every 4 (3 + 3 = 6 of its 7)
        (hyperslab(vshape, vmax, (1, 0, 0), (1, 1, 1), None, (UNLIMITED, 4, 3)),
         "b.h5", "data",
         hyperslab((4, 3, 7), None, (0, 0, 0), (1, 1, UNLIMITED), (1, 1, 4),
                   (4, 3, 3))),
        (hyperslab(vshape, vmax, (0, 0, 0), (UNLIMITED, 1, 1), (2, 1, 1),
                   (1, 4, 3)), "missing.h5", "data",
         hyperslab((5, 4, 3), None, (0, 0, 0), (1, 1, 1), None,
                   (UNLIMITED, 4, 3))),
        (hyperslab((12, 4, 3), vmax, (10, 0, 0), (1, 1, 1), None, (2, 4, 3)),
         "a.h5", "data", hyperslab((5, 4, 3), None, (0, 0, 0), (1, 1, 1), None,
                                   (2, 4, 3)))], fill=-2)
    strided = assert_reads_everywhere(path, "strided", [(), np.s_[2:6]])
    assert strided.shape == (7, 4, 3)
    np.testing.assert_array_equal(strided[[0, 1, 3, 4, 6]], a)
    np.testing.assert_array_equal(strided[[2, 5]], -1)
    blocks = assert_reads_everywhere(path, "blocks", [(), np.s_[3:11]])
    assert blocks.shape == (12, 4, 3)
    np.testing.assert_array_equal(blocks[10:12], a[:2])
    np.testing.assert_array_equal(blocks[7:10], -2)


def write_blocks(folder, blocks, pattern="src_%b.h5", dataset="data"):
    """Each array of `blocks` (None: no file) as block b's source."""
    for b, arr in enumerate(blocks):
        if arr is not None:
            with h5py.File(folder / pattern.replace("%b", str(b)), "a") as f:
                f.create_dataset(dataset.replace("%b", str(b)), data=arr)


def printf_mapping(vshape, block, source_file, source_name, stride=None):
    vmax = (UNLIMITED,) + tuple(vshape[1:])
    stride = stride or block[0]
    return (hyperslab(vshape, vmax, (0,) * len(vshape),
                      (UNLIMITED,) + (1,) * (len(vshape) - 1),
                      (stride,) + (1,) * (len(vshape) - 1), block),
            source_file, source_name, h5py.h5s.create_simple(block))


def test_printf_mappings_read_each_block_from_its_own_source(tmp_path):
    """A %b in the source file's name or in the dataset's: block b of the
    unlimited virtual selection comes from the source named with b, for
    as many blocks as are found."""
    blocks = [volume((2, 5, 6), seed=b) for b in range(3)]
    write_blocks(tmp_path, blocks)
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        for b, arr in enumerate(blocks):
            f.create_dataset(f"block_{b}", data=arr, chunks=(1, 5, 3))
    create_virtual(path, "files", (0, 5, 6), (UNLIMITED, 5, 6), "<u2",
                   [printf_mapping((0, 5, 6), (2, 5, 6), "src_%b.h5", "data")])
    create_virtual(path, "names", (0, 5, 6), (UNLIMITED, 5, 6), "<u2",
                   [printf_mapping((0, 5, 6), (2, 5, 6), ".", "block_%b",
                                   stride=3)], fill=5)
    files = assert_reads_everywhere(path, "files", [(), np.s_[1:4], np.s_[5, 2]])
    np.testing.assert_array_equal(files, np.concatenate(blocks))
    names = assert_reads_everywhere(path, "names", [(), np.s_[2:7]])
    assert names.shape == (8, 5, 6)
    np.testing.assert_array_equal(names[[0, 1, 3, 4, 6, 7]], np.concatenate(blocks))
    np.testing.assert_array_equal(names[[2, 5]], 5)


def test_a_printf_mapping_stops_at_its_first_missing_block(tmp_path):
    """Blocks 0, 1 and 3 exist, block 2 does not: with the library's
    default printf gap of 0 the search stops at block 2, so the extent
    ends after block 1. Where a limited mapping reaches further, the
    blocks from 2 on keep the fill value, block 3's file although it
    exists."""
    blocks = [np.full((2, 3), b + 1, "<i2") for b in range(4)]
    blocks[2] = None
    write_blocks(tmp_path, blocks)
    with h5py.File(tmp_path / "tail.h5", "w") as f:
        f["data"] = np.full((2, 3), 77, "<i2")
    path = tmp_path / "vds.h5"
    mapping = printf_mapping((10, 3), (2, 3), "src_%b.h5", "data")
    create_virtual(path, "alone", (0, 3), (UNLIMITED, 3), "<i2", [mapping],
                   fill=-5)
    tail = (hyperslab((10, 3), (UNLIMITED, 3), (8, 0), (1, 1), None, (2, 3)),
            "tail.h5", "data", h5py.h5s.create_simple((2, 3)))
    create_virtual(path, "beside", (10, 3), (UNLIMITED, 3), "<i2",
                   [printf_mapping((10, 3), (2, 3), "src_%b.h5", "data"), tail],
                   fill=-5)
    alone = assert_reads_equal(path, "alone", [(), np.s_[1:3]])
    np.testing.assert_array_equal(alone[:, 0], [1, 1, 2, 2])
    beside = assert_reads_equal(path, "beside", [(), np.s_[5:9], np.s_[6]])
    np.testing.assert_array_equal(beside[:, 0], [1, 1, 2, 2, -5, -5, -5, -5, 77, 77])


CONVERSIONS = [("<i2", "u1"), ("<u2", "i1"), ("<i8", "<u4"), ("<u8", "<i2"),
               ("<i8", "<f4"), ("<u8", "<f8"), ("<f8", "<f4")]


@pytest.mark.parametrize("source, target", CONVERSIONS,
                         ids=[f"{s}-{t}" for s, t in CONVERSIONS])
def test_sources_of_another_type_convert_as_h5py_converts_them(tmp_path, source,
                                                               target):
    """A source whose type does not widen to the virtual dataset's:
    integers saturate at the target's range; to floating point values round
    to nearest, and a float past the target's largest finite value, which
    numpy would round to it, is infinite, as the library converts."""
    rng = np.random.default_rng(0)
    info = (np.iinfo if np.dtype(source).kind in "iu" else np.finfo)(source)
    edges = [info.min, info.max, 0, 1, -1 if info.min < 0 else 2]
    if np.dtype(source).kind == "f":
        top = float(np.finfo(target).max)
        edges += [top, top * (1 + 1e-9), -top * (1 + 1e-9)]
    values = np.concatenate([edges, rng.uniform(-3e5, 3e5, 60 - len(edges))])
    with np.errstate(all="ignore"):
        data = values.astype(source).reshape(5, 3, 4)
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f.create_dataset("data", data=data)
    layout = h5py.VirtualLayout(shape=(5, 3, 4), dtype=target)
    layout[:] = h5py.VirtualSource("src.h5", "data", shape=(5, 3, 4))
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("data", layout)
    got = assert_reads_everywhere(path)
    if np.dtype(target).kind in "iu":
        t = np.iinfo(target)
        np.testing.assert_array_equal(
            got, np.clip(data.astype(object), t.min, t.max).astype(target))
    elif np.dtype(source).kind == "f":
        assert np.isposinf(got.ravel()[6]) and np.isneginf(got.ravel()[7])


def test_floating_point_sources_under_an_integer_dataset_are_refused(tmp_path):
    """The library's float to integer conversion of NaN and of values past
    the range follows the platform's C conversion (NaN reads as the most
    negative value in an int32 here), and its conversion to float16 is not
    IEEE rounding (65520.0 reads as 65504, an int32 of 70000 as NaN): both
    refused by name."""
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f["floats"] = np.array([1.5, np.nan, 65520.0], "<f4")
        f["ints"] = np.array([1, 70000, -3], "<i4")
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        for name, source, target in (("to_int", "floats", "<i4"),
                                     ("to_half", "floats", "<f2"),
                                     ("int_to_half", "ints", "<f2")):
            layout = h5py.VirtualLayout(shape=(3,), dtype=target)
            layout[:] = h5py.VirtualSource("src.h5", source, shape=(3,))
            f.create_virtual_dataset(name, layout)
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["to_int"][()], [1, np.iinfo("i4").min,
                                                        65520])
        np.testing.assert_array_equal(f["to_half"][()], [1.5, np.nan, 65504.0])
        assert np.isnan(f["int_to_half"][1])
    for name, types in (("to_int", "float32 under a dataset of type int32"),
                        ("to_half", "float32 under a dataset of type float16"),
                        ("int_to_half", "int32 under a dataset of type float16")):
        with hdf5.File(path) as f, pytest.raises(
                NotImplementedError, match=f"sources of type {types}"):
            f[name][()]


def test_a_corrupt_mapping_list_fails_its_checksum(tmp_path):
    write_sources(tmp_path, [volume((4, 12, 10))])
    layout = h5py.VirtualLayout(shape=(4, 12, 10), dtype="<u2")
    layout[:] = h5py.VirtualSource("part_0.h5", "data", shape=(4, 12, 10))
    path = tmp_path / "vds.h5"
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("data", layout)
    raw = bytearray(path.read_bytes())
    raw[raw.index(b"part_0.h5")] ^= 0x20  # "Part_0.h5"
    path.write_bytes(bytes(raw))
    with hdf5.File(path) as f, pytest.raises(ValueError, match="fail their checksum"):
        f["data"]


def test_virtual_lzf_nexus_through_both_packages(tmp_path):
    """A NeXus volume whose signal is a virtual dataset over two LZF
    sources: the port's eager and lazy readers against the JAX package's
    `numpy_from_hdf5` (h5py)."""
    vol = volume((12, 20, 16), "u1", seed=9)
    vol[:, :5] = 0  # a run LZF compresses
    write_sources(tmp_path, [vol[:6], vol[6:]])
    layout = h5py.VirtualLayout(shape=vol.shape, dtype="u1")
    for i in range(2):
        layout[6 * i:6 * i + 6] = h5py.VirtualSource(f"part_{i}.h5", "data",
                                                     shape=(6, 20, 16))
    path = tmp_path / "vds.nxs"
    with h5py.File(path, "w") as f:
        f.create_group("entry/final_result_tomo")
        f["entry/final_result_tomo"].create_virtual_dataset("data", layout)
    ref, ref_chunks = jax_utils.numpy_from_hdf5(path, nexus=True)
    ours, chunks = utils.numpy_from_hdf5(path, nexus=True)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, vol)
    assert chunks == ref_chunks is None
    lazy = utils.LazyHDF5Volume(path, nexus=True)
    try:
        assert lazy.shape == vol.shape and lazy.dtype == vol.dtype
        slabs = [lazy[i:i + 5] for i in range(0, vol.shape[0], 5)]
        np.testing.assert_array_equal(np.concatenate(slabs), ref)
        np.testing.assert_array_equal(lazy[:, 7], ref[:, 7])
        assert lazy.inflated_chunks > 0
    finally:
        lazy.close()
