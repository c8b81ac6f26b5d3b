"""HDF5 files whose offsets and lengths are not 8 bytes (`H5Pset_sizes`:
(4, 4), (8, 4), (4, 8) and (2, 2)), at superblock 0 and at `libver=
"latest"` (superblock 3), read by the port as h5py reads them: every
layout (contiguous, compact, chunked under each chunk index the library
writes, with filters), symbol-table and dense groups, soft and external
links, attributes, external raw storage and virtual datasets, whole and a
slab at a time; and the superblock's sizes as the file states them.

Lengths below 8 bytes store an unlimited dimension as all ones of their
size, which the library decodes as that number (h5py's `maxshape` gives
2**32 - 1): its own extensible-array index, which needs an unlimited
dimension, then fails to open ("didn't find unlimited dimension"). The
port reads such a file as written (`test_extensible_arrays_h5py_cannot_
reopen`). Under lengths of 2 bytes the library cannot reopen a dense
group it wrote either ("invalid fractal heap object size"): there the
groups stay compact."""

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu_torch.utils import hdf5

SIZES = [(4, 4), (8, 4), (4, 8), (2, 2)]
LIBVERS = ["earliest", "latest"]
SHAPE = (9, 14, 11)
CHUNKS = (4, 5, 6)  # partial edge chunks on every axis


def array(dtype="<u2", shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 200).astype(dtype)


def open_sized(path, sizes, libver):
    """An h5py File, new at `path`, with offsets and lengths of `sizes`."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(*sizes)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    if libver == "latest":
        fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    fid = h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl,
                          fapl=fapl)
    return h5py.File(fid)


def low_level(f, name, data, chunks=None, layout=None, early=False):
    """A dataset made through the low level: compact, or chunked with early
    allocation (the implicit index)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout is not None:
        dcpl.set_layout(layout)
    if chunks is not None:
        dcpl.set_chunk(chunks)
    if early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype),
                         h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


# name -> (what h5py makes, the libvers that write it).
DATASETS = {
    "contiguous": (lambda f, a: f.create_dataset("contiguous", data=a), LIBVERS),
    "compact": (lambda f, a: low_level(f, "compact", a[:2, :4],
                                       layout=h5py.h5d.COMPACT), LIBVERS),
    "gzip": (lambda f, a: f.create_dataset("gzip", data=a, chunks=CHUNKS,
                                           compression="gzip", shuffle=True),
             LIBVERS),
    "fletcher32": (lambda f, a: f.create_dataset(
        "fletcher32", data=a, chunks=CHUNKS, fletcher32=True), LIBVERS),
    "extensible": (lambda f, a: f.create_dataset(
        "extensible", data=a, chunks=CHUNKS, maxshape=(None,) + SHAPE[1:],
        compression="gzip"), LIBVERS),
    "btree2": (lambda f, a: f.create_dataset(
        "btree2", data=a, chunks=CHUNKS, maxshape=(None, None, SHAPE[2]),
        compression="gzip"), LIBVERS),
    "single_filtered": (lambda f, a: f.create_dataset(
        "single_filtered", data=a, chunks=SHAPE, compression="gzip"), ["latest"]),
    "implicit": (lambda f, a: low_level(f, "implicit", a, chunks=CHUNKS,
                                        early=True), ["latest"]),
    "unwritten": (lambda f, a: f.create_dataset(
        "unwritten", shape=SHAPE, dtype=a.dtype, chunks=CHUNKS,
        fillvalue=np.array(17, a.dtype)), LIBVERS),
}

SELECTIONS = [np.s_[()], np.s_[2:7], np.s_[1:8, 3:12, 4], np.s_[-1]]


def assert_reads_equal(path, name):
    with h5py.File(path, "r") as f:
        ds = f[name]
        refs = [ds[sel] for sel in SELECTIONS[:1 + (ds.ndim == 3) * 3]]
        ref_meta = (ds.shape, ds.maxshape, ds.chunks)
    with hdf5.File(path) as f:
        ds = f[name]
        assert (ds.shape, ds.maxshape, ds.chunks) == ref_meta
        for sel, ref in zip(SELECTIONS, refs):
            got = ds[sel]
            assert np.asarray(got).dtype == ref.dtype.newbyteorder("=")
            np.testing.assert_array_equal(got, ref)


def written(sizes, libver):
    """The datasets h5py writes, and reads back, at these sizes."""
    return [name for name, (_, libvers) in DATASETS.items() if libver in libvers
            and not (name == "extensible" and libver == "latest" and sizes[1] < 8)]


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("sizes", SIZES, ids=[f"{o}x{n}" for o, n in SIZES])
def test_every_layout_reads_equal_h5py(tmp_path, sizes, libver):
    path = tmp_path / "s.h5"
    with open_sized(path, sizes, libver) as f:
        for name in written(sizes, libver):
            DATASETS[name][0](f, array())
    with hdf5.File(path) as f:
        assert (f.offset_size, f.length_size) == sizes
        assert f._buf[8] == (0 if libver == "earliest" else 3)
    for name in written(sizes, libver):
        assert_reads_equal(path, name)


@pytest.mark.parametrize("sizes", [(4, 4), (2, 2)], ids=["4x4", "2x2"])
def test_extensible_arrays_h5py_cannot_reopen(tmp_path, sizes):
    path = tmp_path / "s.h5"
    with open_sized(path, sizes, "latest") as f:
        DATASETS["extensible"][0](f, array())
    with h5py.File(path, "r") as f, pytest.raises(KeyError,
                                                  match="unlimited dimension"):
        f["extensible"]
    with hdf5.File(path) as f:
        ds = f["extensible"]
        assert ds._index_type == hdf5.INDEX_EXTENSIBLE_ARRAY
        assert ds.maxshape == ((1 << 8 * sizes[1]) - 1,) + SHAPE[1:]
        np.testing.assert_array_equal(ds[()], array())


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("sizes", SIZES, ids=[f"{o}x{n}" for o, n in SIZES])
def test_groups_links_and_attributes_read_equal_h5py(tmp_path, sizes, libver):
    """Nested groups (dense ones past 8 links under `latest`: a fractal
    heap and a version 2 B-tree of names), soft links, an external link
    into another sized file, and attributes of each type. Under 2-byte
    lengths the group keeps its links in its header (see the module's
    note)."""
    other = tmp_path / "other.h5"
    with open_sized(other, sizes, libver) as f:
        f.create_dataset("inner/data", data=array("u1", seed=1), chunks=CHUNKS,
                         compression="gzip")
    path = tmp_path / "s.h5"
    with open_sized(path, sizes, libver) as f:
        group = f.create_group("entry/many")
        for i in range(6 if sizes[1] == 2 and libver == "latest" else 12):
            group.create_dataset(f"d{i:02d}", data=array("<i4", (3, 4), seed=i))
        f["entry/soft"] = h5py.SoftLink("/entry/many/d03")
        f["entry/external"] = h5py.ExternalLink("other.h5", "/inner/data")
        ds = f.create_dataset("data", data=array(">f4"), chunks=CHUNKS)
        ds.attrs["scale"] = np.float64(0.5)
        ds.attrs["offsets"] = np.arange(5, dtype="<i8")
    names = ["entry/many/" + name for name in h5py.File(path, "r")["entry/many"]]
    for name in names + ["entry/soft", "entry/external", "data"]:
        assert_reads_equal(path, name)
    with h5py.File(path, "r") as f:
        ref = dict(f["data"].attrs)
    with hdf5.File(path) as f:
        got = f["data"].attrs
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("sizes", SIZES, ids=[f"{o}x{n}" for o, n in SIZES])
def test_external_raw_storage_and_virtual_datasets_read_equal_h5py(
        tmp_path, sizes, monkeypatch):
    """An external raw data file list (names in a local heap, slots of
    lengths) and a virtual dataset (mappings in the global heap, their
    count a length) over sources in a sized file and in this one."""
    monkeypatch.chdir(tmp_path)
    raw = array("<u2", (4, 6), seed=3)
    (tmp_path / "raw.bin").write_bytes(b"\0" * 10 + raw.tobytes())
    source = tmp_path / "source.h5"
    with open_sized(source, sizes, "earliest") as f:
        f.create_dataset("data", data=array("u1", seed=4), chunks=CHUNKS,
                         compression="gzip")
    path = tmp_path / "s.h5"
    with open_sized(path, sizes, "latest") as f:
        f.create_dataset("external", shape=raw.shape, dtype=raw.dtype,
                         external=[("raw.bin", 10, raw.nbytes)])
        f["local"] = array("u1", (3,) + SHAPE[1:], seed=5)
        layout = h5py.VirtualLayout(shape=(SHAPE[0] + 3,) + SHAPE[1:], dtype="u1")
        layout[:SHAPE[0]] = h5py.VirtualSource("source.h5", "data", shape=SHAPE)
        layout[SHAPE[0]:] = h5py.VirtualSource(".", "local", shape=(3,) + SHAPE[1:])
        f.create_virtual_dataset("virtual", layout, fillvalue=3)
    for name in ("external", "virtual"):
        assert_reads_equal(path, name)


@pytest.mark.parametrize("sizes", [(16, 8), (8, 16)])
def test_sizes_past_eight_bytes_are_refused_by_name(tmp_path, sizes):
    """A superblock stating offsets or lengths of 16 bytes (patched into a
    file: the library writes none) is refused by name."""
    path = tmp_path / "s.h5"
    with h5py.File(path, "w") as f:
        f["data"] = np.zeros(3, "u1")
    raw = bytearray(path.read_bytes())
    raw[13:15] = bytes(sizes)
    path.write_bytes(bytes(raw))
    what = "offsets" if sizes[0] == 16 else "lengths"
    with pytest.raises(NotImplementedError, match=f"{what} of 16 bytes"):
        hdf5.read(path)
