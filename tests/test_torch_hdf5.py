"""The PyTorch port's HDF5 reader and writer (`utils/hdf5.py`) against
h5py: files h5py writes read equal, with the same `chunks`; files the port
writes read back equal through h5py and the JAX package's
`numpy_from_hdf5`, gzip level 4 with h5py's chunks; features outside the
subset raise."""

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu.utils.base_data_utils import (
    numpy_from_hdf5 as jax_numpy_from_hdf5,
)
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils import hdf5

SHAPE = (20, 27, 33)


def volume(dtype, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 100).astype(dtype)


def assert_read_equals_h5py(path, internal="/data"):
    with h5py.File(path, "r") as f:
        ref, ref_chunks = f[internal][()], f[internal].chunks
    got, chunks = hdf5.read(path, internal)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype.newbyteorder("=")
    assert got.flags.writeable and got.flags.c_contiguous
    assert chunks == ref_chunks
    return got


H5PY_CASES = {
    "contiguous": dict(),
    "chunked_gzip_default": dict(chunks=True, compression="gzip"),
    "partial_edge_chunks": dict(chunks=(7, 10, 16), compression="gzip"),
    "gzip_level_1": dict(chunks=(8, 8, 8), compression="gzip", compression_opts=1),
    "gzip_level_4": dict(chunks=(8, 8, 8), compression="gzip", compression_opts=4),
    "gzip_level_9": dict(chunks=(8, 8, 8), compression="gzip", compression_opts=9),
    "shuffle_gzip": dict(chunks=(5, 9, 11), compression="gzip", shuffle=True),
    "chunked_uncompressed": dict(chunks=(6, 6, 6)),
}


@pytest.mark.parametrize("case", list(H5PY_CASES))
@pytest.mark.parametrize("dtype", ["<u2", ">f4"])
def test_h5py_layouts_and_filters_read_equal(tmp_path, case, dtype):
    path = tmp_path / "v.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("/data", data=volume(dtype), **H5PY_CASES[case])
    assert_read_equals_h5py(path)


@pytest.mark.parametrize("dtype", ["u1", "<u2", ">u2", "<i2", ">i2", "<f2",
                                   ">f2", "<f4", ">f4", "<f8", ">f8", "<i4",
                                   ">u4", "<i8", ">u8", "i1"])
def test_dtypes_in_both_byte_orders_read_equal(tmp_path, dtype):
    path = tmp_path / "v.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("/data", data=volume(dtype, (4, 5, 6)), chunks=True,
                         compression="gzip", shuffle=True)
        f.create_dataset("/plain", data=volume(dtype, (4, 5, 6), seed=1))
    assert_read_equals_h5py(path)
    assert_read_equals_h5py(path, "/plain")


def test_compact_layout_reads_equal(tmp_path):
    path = tmp_path / "v.h5"
    fid = h5py.h5f.create(bytes(path), h5py.h5f.ACC_TRUNC)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple((4, 5, 6))
    ds = h5py.h5d.create(fid, b"data", h5py.h5t.STD_I16BE, space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, volume("<i2", (4, 5, 6)))
    ds.close()
    fid.close()
    assert_read_equals_h5py(path)


def test_unwritten_chunks_and_storage_take_the_fill_value(tmp_path):
    path = tmp_path / "v.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("/data", shape=SHAPE, dtype="<f4", chunks=(8, 8, 8),
                             compression="gzip", fillvalue=3.5)
        d[:9, 2:19, 5:7] = 1.25
        f.create_dataset("/empty", shape=(3, 4, 5), dtype="<u2", fillvalue=7)
        f.create_dataset("/zero", shape=(3, 4, 5), dtype="u1", chunks=(2, 2, 2))
    got = assert_read_equals_h5py(path)
    assert (got == 3.5).any() and (got == 1.25).any()
    assert (assert_read_equals_h5py(path, "/empty") == 7).all()
    assert (assert_read_equals_h5py(path, "/zero") == 0).all()


def test_nested_nxs_paths_big_groups_and_continuation_blocks(tmp_path):
    """Diamond's NXS layout, groups with attributes, a group of 45 entries
    (several symbol-table nodes) and a dataset header grown past its first
    block by attributes."""
    path = tmp_path / "scan.nxs"
    vol = volume("<u2")
    with h5py.File(path, "w") as f:
        entry = f.create_group("entry")
        entry.attrs["NX_class"] = "NXentry"
        tomo = entry.create_group("final_result_tomo")
        tomo.attrs["NX_class"] = "NXdata"
        ds = tomo.create_dataset("data", data=vol, chunks=True, compression="gzip")
        for i in range(30):
            ds.attrs[f"attribute_{i}"] = "x" * 60
        for i in range(45):
            f[f"entry/extra/item_{i}"] = np.full(3, i)
    assert_read_equals_h5py(path, "/entry/final_result_tomo/data")
    assert_read_equals_h5py(path, "entry/extra/item_37")
    got, chunks = utils.numpy_from_hdf5(path, nexus=True)
    ref, ref_chunks = jax_numpy_from_hdf5(path, nexus=True)
    np.testing.assert_array_equal(got, ref)
    assert chunks == ref_chunks


def test_missing_paths_raise_key_error_and_nxs_fallback_exits(tmp_path):
    path = tmp_path / "scan.nxs"
    with h5py.File(path, "w") as f:
        f["processed/other"] = np.zeros(3)
    with pytest.raises(KeyError):
        hdf5.read(path, "/data")
    with pytest.raises(KeyError):
        hdf5.read(path, "/processed/missing")
    with pytest.raises(KeyError):
        hdf5.read(path, "/processed/other/deeper")
    with pytest.raises(SystemExit) as ours:
        utils.numpy_from_hdf5(path, nexus=True)
    with pytest.raises(SystemExit) as ref:
        jax_numpy_from_hdf5(path, nexus=True)
    assert ours.value.code == ref.value.code == 1


def test_unsupported_features_raise_not_implemented(tmp_path):
    """A filter the reader does not know and strings stay refused by
    name. Superblock version 3, Fletcher-32, soft links, LZF, szip and
    booleans, refused before, now read as h5py reads them
    (tests/test_torch_hdf5_layouts.py, _links.py, _filters.py and
    _enum.py test them in full)."""
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f["data"] = np.zeros((2, 3, 4), np.uint8)
    assert_read_equals_h5py(latest)
    other = tmp_path / "other.h5"
    with h5py.File(other, "w") as f:
        f.create_dataset("lzf", data=np.zeros((4, 4), np.uint8), compression="lzf")
        f.create_dataset("szip", data=np.zeros((4, 4), "<i4"), compression="szip")
        f.create_dataset("fletcher", data=np.arange(16, dtype=np.uint8).reshape(4, 4),
                         chunks=(2, 2), fletcher32=True)
        f["strings"] = np.array([b"ab", b"cd"])
        f["flags"] = np.zeros((4,), bool)
        f["link"] = h5py.SoftLink("/fletcher")
        # bzip2 (307), optional and not in the library: every chunk skips it
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((2, 2))
        dcpl.set_filter(307, h5py.h5z.FLAG_OPTIONAL, (9,))
        h5py.h5d.create(f.id, b"bzip2", h5py.h5t.STD_U8LE,
                        h5py.h5s.create_simple((4, 4)), dcpl=dcpl)
    for name, feature in (("bzip2", "filter 307 \\(unknown"),
                          ("strings", "datatype class 3")):
        with pytest.raises(NotImplementedError, match=feature):
            hdf5.read(other, name)
    for name in ("fletcher", "link", "lzf", "szip", "flags"):
        assert_read_equals_h5py(other, name)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        (tmp_path / "x.h5").write_bytes(b"not hdf5" * 20)
        hdf5.read(tmp_path / "x.h5")


WRITE_CASES = {
    "labels_given_chunks": (lambda: volume("u1") % 3, (10, 25, 30), (10, 25, 30)),
    "labels_chunks_true": (lambda: volume("u1") % 3, True, None),
    "labels_contiguous_input": (lambda: volume("u1") % 3, None, None),
    "one_hot_4d_falls_back_to_true": (
        lambda: (volume("u1", (3, *SHAPE)) % 2), (5, 5, 5), None),
    "max_probs_float16": (lambda: np.abs(volume("<f2")) / 400, (7, 9, 33), (7, 9, 33)),
    "large_multilevel_btree": (
        lambda: np.random.default_rng(1).integers(0, 4, (96, 128, 160), np.uint8),
        (8, 8, 16), (8, 8, 16)),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_port_written_files_read_back_through_h5py_and_jax(tmp_path, case):
    make, chunking, expected_chunks = WRITE_CASES[case]
    data = make()
    path = tmp_path / "out.h5"
    utils.save_data_to_hdf5(data, path, chunking=chunking)
    with h5py.File(path, "r") as f:
        ds = f["/data"]
        assert ds.compression == "gzip" and ds.compression_opts == 4
        assert not ds.shuffle
        np.testing.assert_array_equal(ds[()], data)
        assert ds.dtype == data.dtype
        got_chunks = ds.chunks
    with h5py.File(tmp_path / "ref.h5", "w") as f:
        h5_chunks = chunking if chunking not in (None, True) and \
            len(chunking) == data.ndim else True
        ref_chunks = f.create_dataset("/data", data=data, chunks=h5_chunks,
                                      compression="gzip").chunks
    assert got_chunks == ref_chunks
    if expected_chunks is not None:
        assert got_chunks == expected_chunks
    ref, chunks = jax_numpy_from_hdf5(path)
    np.testing.assert_array_equal(ref, data)
    assert chunks == got_chunks
    ours, chunks = hdf5.read(path)
    np.testing.assert_array_equal(ours, data)
    assert chunks == got_chunks


@pytest.mark.parametrize("shape,itemsize", [
    ((40, 50, 60), 1), ((256, 256, 256), 1), ((512, 512, 512), 1),
    ((3, 40, 50, 60), 1), ((80, 288, 320), 2), ((7,), 8), ((1, 1, 1), 1),
    ((5000, 3), 4), ((0, 4), 1)])
def test_guess_chunk_is_h5pys(shape, itemsize):
    from h5py._hl.filters import guess_chunk

    assert hdf5.guess_chunk(shape, itemsize) == guess_chunk(shape, None, itemsize)


def test_writer_nested_path_and_bad_input(tmp_path):
    data = volume("u1", (4, 6, 8))
    path = tmp_path / "n.h5"
    hdf5.write(path, data, "/entry/final_result_tomo/data", chunks=(2, 3, 4))
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["entry/final_result_tomo/data"][()], data)
    with pytest.raises(ValueError, match="Chunk shape must not be greater"):
        hdf5.write(path, data, chunks=(8, 6, 8))
    with pytest.raises(ValueError, match="cannot write dtype"):
        hdf5.write(path, data.astype(bool))


# ----------------------------------------------------------------------
# Partial reads (h5py's basic selections)
# ----------------------------------------------------------------------

SELECTIONS = [
    (), Ellipsis, 3, -1, np.int64(5), (slice(2, 9),), (slice(-5, None),),
    (slice(0, 100),), (slice(9, 2),), (slice(None), 4), (slice(None), -3),
    (slice(None), slice(None), slice(30, 33)), (1, 2, slice(3, 17)), (0, 0, 0),
    (-1, -1, -1), (slice(4, 19), slice(8, 26), slice(5, 31)),
    (slice(None), slice(26, 27), slice(None, None, 1)), (slice(7, 7), 3),
]
SMALL_SELECTIONS = [(), Ellipsis, 3, -1, (slice(1, 3),), (slice(3, 1),),
                    (slice(None), 4), (1, 2, slice(3, 17)), (0, 0, 0),
                    (-1, -1, -1), (slice(1, 3), slice(2, 4), slice(5, 6))]


def partial_read_file(path, dtype=">f4"):
    """Datasets of every layout, (20, 27, 33) unless noted: chunked with
    edge chunks, shuffle+deflate, some chunks never written, contiguous,
    never-written contiguous, and compact (4, 5, 6)."""
    vol = volume(dtype)
    with h5py.File(path, "w") as f:
        f.create_dataset("edge", data=vol, chunks=(7, 10, 16), compression="gzip")
        f.create_dataset("shuffle", data=vol, chunks=(5, 9, 11),
                         compression="gzip", shuffle=True)
        sparse = f.create_dataset("sparse", shape=SHAPE, dtype=dtype,
                                  chunks=(8, 8, 8), fillvalue=3)
        sparse[:9, 2:19, 5:7] = vol[:9, 2:19, 5:7]
        f.create_dataset("contiguous", data=vol)
        f.create_dataset("unwritten", shape=SHAPE, dtype=dtype, fillvalue=7)
    fid = h5py.h5f.open(bytes(path), h5py.h5f.ACC_RDWR)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(fid, b"compact", h5py.h5t.STD_I16BE,
                         h5py.h5s.create_simple((4, 5, 6)), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, volume("<i2", (4, 5, 6)))
    ds.close()
    fid.close()
    return path


@pytest.mark.parametrize("name", ["edge", "shuffle", "sparse", "contiguous",
                                  "unwritten", "compact"])
@pytest.mark.parametrize("dtype", [">f4", "<u2"])
def test_partial_reads_equal_h5py(tmp_path, name, dtype):
    path = partial_read_file(tmp_path / "p.h5", dtype)
    with h5py.File(path, "r") as f, hdf5.File(path) as ours:
        ref_ds, ds = f[name], ours[name]
        assert (ds.shape, ds.size, ds.ndim) == (ref_ds.shape, ref_ds.size,
                                                ref_ds.ndim)
        for sel in SMALL_SELECTIONS if name == "compact" else SELECTIONS:
            ref, got = ref_ds[sel], ds[sel]
            assert type(got) is type(ref), sel
            assert np.shape(got) == np.shape(ref), sel
            np.testing.assert_array_equal(got, ref)
            if isinstance(got, np.ndarray):
                assert got.dtype == ref.dtype.newbyteorder("=")
                assert got.flags.writeable and got.flags.c_contiguous


def test_partial_reads_inflate_only_the_chunks_they_meet(tmp_path):
    path = partial_read_file(tmp_path / "p.h5")
    with hdf5.File(path) as f:
        ds = f["edge"]  # chunks (7, 10, 16) over (20, 27, 33): 3 x 3 x 3
        ds[0:7, 0:10, 0:16]
        assert ds.inflated_chunks == 1
        ds[6:8]  # two chunk rows along Z
        assert ds.inflated_chunks == 1 + 2 * 9
        ds[:, 26]  # one chunk row along Y
        assert ds.inflated_chunks == 19 + 9
        ds[5:5]  # empty: nothing
        assert ds.inflated_chunks == 28
        sparse = f["sparse"]  # chunks never written are not inflated
        np.testing.assert_array_equal(sparse[16:20], 3)
        assert sparse.inflated_chunks == 0


def test_partial_read_refusals_and_errors_name_the_feature(tmp_path):
    path = partial_read_file(tmp_path / "p.h5")
    with hdf5.File(path) as f:
        ds = f["edge"]
        for sel, feature in (((slice(0, 8, 2),), "step"),
                             ((slice(None, None, -1),), "step"),
                             (([0, 1],), "fancy"), ((np.array([1, 2]),), "fancy"),
                             ((True,), "boolean"), ((Ellipsis, 1), "Ellipsis")):
            with pytest.raises(NotImplementedError, match=feature):
                ds[sel]
        with pytest.raises(IndexError):
            ds[20]
        with pytest.raises(IndexError):
            ds[:, -28]
        with pytest.raises(ValueError, match="4 indexing arguments"):
            ds[0, 0, 0, 0]
