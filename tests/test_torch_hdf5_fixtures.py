"""The committed HDF5 fixtures (`tests/data/torch_hdf5/`, written by
`tests/torch_hdf5_fixtures.py` with h5py) that `chip_smoke.py` reads on the
machine without h5py: each reads through the port equal to h5py's reading,
whole and by basic selections, and to the array
`chip_smoke.fixture_arrays()` rebuilds; they cover every chunk index, the
NeXus file's dense group and external link, LZF, scale-offset, n-bit,
szip (every chunk of its files coded, none left unfiltered), external raw
storage and virtual datasets (the 512^3 one over the LZF tile too),
committed datatypes, reduced-precision integers (unfiltered and under
n-bit) and a virtual dataset of a narrower type, and they stay small. The
%b and unlimited virtual datasets, committed without their sources, read
sources the port's writer makes beside a copy.  A byte flipped in a copy of one breaks
the checksum of a version 2 B-tree node, a fractal heap direct block, a
fixed array data block or an extensible array index block: ValueError."""

import shutil

import h5py
import numpy as np
import pytest

import chip_smoke
from volume_segmantics_tpu.utils import base_data_utils as jax_utils
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils import hdf5

FIXTURES = chip_smoke.FIXTURE_DIR
INDEXES = {
    "vessels_latest.h5": hdf5.INDEX_EXTENSIBLE_ARRAY,
    "vessels_labels.h5": hdf5.INDEX_FIXED_ARRAY,
    "single_chunk.h5": hdf5.INDEX_SINGLE,
    "implicit.h5": hdf5.INDEX_IMPLICIT,
    "fixed_array_paged.h5": hdf5.INDEX_FIXED_ARRAY,
    "btree2.h5": hdf5.INDEX_BTREE2,
    "superblock_2.h5": hdf5.INDEX_BTREE1,
    "user_block.h5": hdf5.INDEX_BTREE1,
    "soft_link.nxs": hdf5.INDEX_BTREE1,
}


@pytest.fixture(scope="module")
def arrays():
    return chip_smoke.fixture_arrays()


SELECTIONS = [np.s_[3], np.s_[2:9, 5:17, 1:12], np.s_[-1, :, 4], np.s_[4, 7, 9]]


def test_the_fixture_set_is_listed_and_small():
    files = sorted(p.name for p in FIXTURES.iterdir())
    assert files == sorted([*chip_smoke.FIXTURE_READS, *chip_smoke.FIXTURE_OTHERS])
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 2_500_000


SZIP_FIXTURES = sorted(n for n in chip_smoke.FIXTURE_READS if "szip" in n)


@pytest.mark.parametrize("name", SZIP_FIXTURES)
def test_the_szip_fixtures_hold_szip_coded_chunks(name):
    """szip is optional in the library: a chunk it cannot shrink is stored
    as it is, which would leave the decoder unread. Every chunk of these
    files went through it."""
    with h5py.File(FIXTURES / name, "r") as f:
        dsid = f["data"].id
        plist = dsid.get_create_plist()
        filters = [plist.get_filter(i)[0] for i in range(plist.get_nfilters())]
        szip_bit = 1 << filters.index(h5py.h5z.FILTER_SZIP)
        masks = [dsid.get_chunk_info(i).filter_mask
                 for i in range(dsid.get_num_chunks())]
    assert masks and not any(m & szip_bit for m in masks)


@pytest.mark.parametrize("name", sorted(chip_smoke.FIXTURE_READS))
def test_fixtures_read_equal_to_h5py_and_to_the_rebuilt_arrays(arrays, name,
                                                               monkeypatch):
    monkeypatch.chdir(FIXTURES)  # where h5py finds an external raw data file
    internal, array = chip_smoke.FIXTURE_READS[name]
    path = FIXTURES / name
    with h5py.File(path, "r") as f:
        ref, ref_chunks = f[internal][()], f[internal].chunks
        refs = [f[internal][sel] for sel in SELECTIONS]
    with hdf5.File(path) as f:
        ds = f[internal]
        got, chunks = ds[()], ds.chunks
        if name in INDEXES:
            assert ds._index_type == INDEXES[name]
        for sel, part in zip(SELECTIONS, refs):
            np.testing.assert_array_equal(ds[sel], part)
    np.testing.assert_array_equal(got, ref)
    assert chunks == ref_chunks
    assert got.dtype == arrays[array].dtype
    np.testing.assert_array_equal(got, arrays[array])


def test_the_512_virtual_dataset_tiles_the_lzf_tile(arrays):
    """512 mappings of one LZF source; its slabs read equal to h5py's and
    to the tile tiled (the card reads it whole)."""
    side = chip_smoke.TILE_SIDE * chip_smoke.TILE_COPIES[1]
    tiled = np.tile(arrays["tile"], (chip_smoke.TILE_COPIES[1],) * 3)
    path = FIXTURES / "tile_512.h5"
    selections = [np.s_[100:140], np.s_[:, 300], np.s_[5:70, 60:200, 400:]]
    with h5py.File(path, "r") as f:
        refs = [f["data"][sel] for sel in selections]
    with hdf5.File(path) as f:
        ds = f["data"]
        assert ds.shape == (side,) * 3 and len(ds._mappings) == 512
        for sel, ref in zip(selections, refs):
            got = ds[sel]
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, tiled[sel])
        assert ds.opened_sources == 1


def assert_reads_everywhere(path, expected, slab=np.s_[40:90]):
    """h5py, the port's reader (whole, shape and a slab), its
    `get_numpy_from_path` against the JAX package's and a
    `LazyHDF5Volume` slab all read `expected`."""
    with h5py.File(path, "r") as f:
        ref = f["data"][()]
    np.testing.assert_array_equal(ref, expected)
    with hdf5.File(path) as f:
        ds = f["data"]
        assert ds.shape == expected.shape
        np.testing.assert_array_equal(ds[slab], expected[slab])
    ours, chunks = utils.get_numpy_from_path(path)
    theirs, jax_chunks = jax_utils.get_numpy_from_path(path)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype == expected.dtype
    assert chunks == jax_chunks is None
    lazy = utils.LazyHDF5Volume(path)
    try:
        np.testing.assert_array_equal(lazy[slab], expected[slab])
    finally:
        lazy.close()


def test_the_block_fixture_reads_its_sources_written_by_the_port(tmp_path):
    """The %b virtual dataset reads one block a source file, as many as
    are found: three written by the port's writer, then a fourth."""
    shutil.copy(FIXTURES / chip_smoke.BLOCKS_VDS, tmp_path)
    path = tmp_path / chip_smoke.BLOCKS_VDS
    rng = np.random.default_rng(2)
    vol = rng.integers(0, 4, (4 * chip_smoke.BLOCK_DEPTH, 256, 256), np.uint8)
    chip_smoke.write_block_sources(tmp_path, vol[:3 * chip_smoke.BLOCK_DEPTH])
    assert_reads_everywhere(path, vol[:3 * chip_smoke.BLOCK_DEPTH])
    chip_smoke.write_block_sources(tmp_path, vol)
    assert_reads_everywhere(path, vol, np.s_[150:230, 3])


def test_the_growing_fixture_follows_its_source(tmp_path, arrays):
    """The unlimited mapping's extent is its source's when the file is
    opened: 12 slices, then 20 once the port rewrites the source larger."""
    shutil.copy(FIXTURES / chip_smoke.GROWING_VDS, tmp_path)
    path = tmp_path / chip_smoke.GROWING_VDS
    crop = arrays["crop_u2"]
    hdf5.write(tmp_path / chip_smoke.GROWING_SOURCE, crop)
    assert_reads_everywhere(path, crop, np.s_[3:9, 5])
    grown = np.concatenate([crop, crop[:8] + 1])
    hdf5.write(tmp_path / chip_smoke.GROWING_SOURCE, grown)
    assert_reads_everywhere(path, grown, np.s_[10:17])


FLIPS = {  # structure -> (fixture, signature, offset of the flipped byte)
    "version 2 B-tree leaf node": ("btree2.h5", b"BTLF", 8),
    "fractal heap direct block": ("vessels.nxs", b"FHDB", 6),
    "fixed array data block": ("vessels_labels.h5", b"FADB", 7),
    "extensible array index block": ("vessels_latest.h5", b"EAIB", 7),
}


@pytest.mark.parametrize("structure", list(FLIPS))
def test_a_flipped_byte_fails_its_metadata_checksum(tmp_path, structure):
    name, signature, offset = FLIPS[structure]
    raw = bytearray((FIXTURES / name).read_bytes())
    at = raw.index(signature)
    assert raw.count(signature) == 1
    raw[at + offset] ^= 0x01
    path = tmp_path / name
    path.write_bytes(bytes(raw))
    internal = chip_smoke.FIXTURE_READS[name][0]
    with pytest.raises(ValueError, match=f"{structure} at {at} fails its checksum"):
        hdf5.read(path, internal)


def test_the_nexus_fixture_through_both_packages(arrays):
    path = FIXTURES / "vessels.nxs"
    with hdf5.File(path) as f:
        group = f._resolve("/entry/final_result_tomo", [16])[1]
        assert hdf5.MSG_LINK not in f._messages(group)  # a dense group
        links = f._links(group)
    assert len(links) == 13
    assert links["data"] == ("external", "vessels_latest.h5", "/data")
    ours, chunks = utils.numpy_from_hdf5(path, nexus=True)
    ref, ref_chunks = jax_utils.numpy_from_hdf5(path, nexus=True)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, arrays["vessels"])
    assert chunks == ref_chunks == (8, 48, 48)
