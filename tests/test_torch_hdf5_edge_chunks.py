"""Unfiltered partial edge chunks: files the library writes with chunk
option flag 1 (`H5Pset_chunk_opts(dcpl, H5D_CHUNK_DONT_FILTER_PARTIAL_
CHUNKS)`, called through `ctypes` on the libhdf5 that h5py loads), in which
a chunk that reaches past the dataset's extent on any axis is stored raw,
its filters (Fletcher-32 too) skipped whatever its filter mask says, and a
full chunk is filtered as before. The port reads each such file equal to
h5py, under every chunk index the library writes it with (a fixed array,
an extensible array, a version 2 B-tree; the flag raises the layout
message to version 4 at any `libver`, so no version 1 B-tree carries it,
and a single chunk is never partial), with gzip, shuffle + gzip and
Fletcher-32, and partial edges on each axis and on none."""

import h5py
import numpy as np
import pytest

from torch_hdf5_fixtures import set_dont_filter_partial_chunks
from volume_segmantics_tpu_torch.utils import hdf5

SHAPE = (9, 16, 14)

FILTERS = {
    "gzip": lambda dcpl: dcpl.set_deflate(4),
    "shuffle_gzip": lambda dcpl: (dcpl.set_shuffle(), dcpl.set_deflate(6)),
    "fletcher32": lambda dcpl: dcpl.set_fletcher32(),
    "gzip_fletcher32": lambda dcpl: (dcpl.set_deflate(1), dcpl.set_fletcher32()),
}
# name -> (maxshape, libver, the index the library picks).
INDEXES = {
    "fixed": (SHAPE, "latest", hdf5.INDEX_FIXED_ARRAY),
    "fixed_earliest": (SHAPE, "earliest", hdf5.INDEX_FIXED_ARRAY),
    "extensible": ((None,) + SHAPE[1:], "latest", hdf5.INDEX_EXTENSIBLE_ARRAY),
    "btree2": ((None, None, SHAPE[2]), "latest", hdf5.INDEX_BTREE2),
}
# Chunk shapes: partial on every axis, on one axis each, and on none.
CHUNKS = {"all_axes": (4, 6, 5), "axis0": (4, 8, 7), "axis1": (3, 6, 7),
          "axis2": (3, 8, 5), "none": (3, 8, 7)}


def array(dtype="<u2", shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 700).astype(dtype)


def write_edges(path, data, chunks, filters, index, name="data"):
    maxshape, libver, _ = INDEXES[index]
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    FILTERS[filters](dcpl)
    set_dont_filter_partial_chunks(dcpl)
    unlimited = tuple(h5py.h5s.UNLIMITED if m is None else m for m in maxshape)
    with h5py.File(path, "a", libver=libver) as f:
        ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype),
                             h5py.h5s.create_simple(data.shape, unlimited),
                             dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
    return path


def stored_sizes(path, name="data"):
    """{chunk offset: stored bytes} as the library reports them."""
    with h5py.File(path, "r") as f:
        dsid = f[name].id
        return {info.chunk_offset: info.size for info in
                (dsid.get_chunk_info(i) for i in range(dsid.get_num_chunks()))}


def assert_reads_equal(path, name="data"):
    with h5py.File(path, "r") as f:
        ref, part = f[name][()], f[name][2:8, 5:15, 1]
    with hdf5.File(path) as f:
        ds = f[name]
        np.testing.assert_array_equal(ds[()], ref)
        np.testing.assert_array_equal(ds[2:8, 5:15, 1], part)
        return ds


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("filters", list(FILTERS))
def test_every_index_and_filter_reads_equal_h5py(tmp_path, filters, index):
    chunks = CHUNKS["all_axes"]
    path = write_edges(tmp_path / "e.h5", array(), chunks, filters, index)
    raw = int(np.prod(chunks)) * 2
    sizes = stored_sizes(path)
    partial = [o for o in sizes if any(a + c > n for a, c, n in zip(o, chunks, SHAPE))]
    assert partial and all(sizes[o] == raw for o in partial)  # stored raw
    full = [o for o in sizes if o not in partial]
    assert all(sizes[o] != raw for o in full)  # filtered
    ds = assert_reads_equal(path)
    assert ds._raw_edges and ds._index_type == INDEXES[index][2]


@pytest.mark.parametrize("axes", list(CHUNKS))
@pytest.mark.parametrize("index", ["fixed", "extensible", "btree2"])
def test_partial_edges_on_each_axis_read_equal_h5py(tmp_path, index, axes):
    path = write_edges(tmp_path / "e.h5", array(">i2", seed=1), CHUNKS[axes],
                       "shuffle_gzip", index)
    assert_reads_equal(path)


def test_a_chunk_filled_by_extending_the_dataset_is_filtered_again(tmp_path):
    """The library filters an edge chunk that an extension makes whole; the
    reader tells partial chunks by the dataset's extent when it reads."""
    path = write_edges(tmp_path / "e.h5", array(), (4, 6, 5), "gzip", "extensible")
    more = array(seed=2)
    with h5py.File(path, "a") as f:
        f["data"].resize((12,) + SHAPE[1:])
        f["data"][9:] = more[:3]
    sizes = stored_sizes(path)
    assert sizes[(8, 0, 0)] != 4 * 6 * 5 * 2  # whole now, and filtered
    assert sizes[(8, 12, 10)] == 4 * 6 * 5 * 2  # still partial in y and x
    assert_reads_equal(path)


def test_a_single_chunk_with_the_flag_reads_equal_h5py(tmp_path):
    """A single chunk (chunks equal to a fixed shape) is never partial:
    the flag leaves it filtered."""
    path = write_edges(tmp_path / "e.h5", array(), SHAPE, "gzip_fletcher32", "fixed")
    ds = assert_reads_equal(path)
    assert ds._raw_edges and ds._index_type == hdf5.INDEX_SINGLE


def test_a_corrupt_raw_edge_chunk_reads_as_its_bytes(tmp_path):
    """A raw edge chunk has no checksum to fail: a flipped byte reads back
    flipped, as h5py reads it, where a filtered chunk would raise."""
    path = write_edges(tmp_path / "e.h5", array("u1"), (4, 6, 5), "fletcher32",
                       "fixed")
    with h5py.File(path, "r") as f:
        info = f["data"].id.get_chunk_info_by_coord((8, 12, 10))
    raw = bytearray(path.read_bytes())
    raw[info.byte_offset] ^= 0xFF
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as f:
        ref = f["data"][()]
    np.testing.assert_array_equal(hdf5.read(path)[0], ref)
    assert ref[8, 12, 10] == array("u1")[8, 12, 10] ^ 0xFF
