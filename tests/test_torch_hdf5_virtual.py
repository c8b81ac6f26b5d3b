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
    """Point selections, unlimited mappings and printf-style (%b) source
    names; a literal "%%" in a name is read as "%"."""
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
    for name, feature in (("points", "point selections"),
                          ("printf", "printf-style \\(%b\\) source names"),
                          ("unlimited", "unlimited virtual dataset mappings")):
        with hdf5.File(path) as f, pytest.raises(NotImplementedError, match=feature):
            f[name]
    with h5py.File(path, "r") as f:
        ref = f["percent"][()]
    np.testing.assert_array_equal(hdf5.read(path, "percent")[0], ref)
    np.testing.assert_array_equal(ref[2:6], data)


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
