"""The committed HDF5 fixtures (`tests/data/torch_hdf5/`, written by
`tests/torch_hdf5_fixtures.py` with h5py) that `chip_smoke.py` reads on the
machine without h5py: each reads through the port equal to h5py's reading
and to the array `chip_smoke.fixture_arrays()` rebuilds, they cover every
chunk index and the NeXus file's dense group and external link, and they
stay small."""

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


def test_the_fixture_set_is_listed_and_small():
    files = sorted(p.name for p in FIXTURES.iterdir())
    assert files == sorted(chip_smoke.FIXTURE_READS)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1_000_000


@pytest.mark.parametrize("name", sorted(chip_smoke.FIXTURE_READS))
def test_fixtures_read_equal_to_h5py_and_to_the_rebuilt_arrays(arrays, name):
    internal, array = chip_smoke.FIXTURE_READS[name]
    path = FIXTURES / name
    with h5py.File(path, "r") as f:
        ref, ref_chunks = f[internal][()], f[internal].chunks
    with hdf5.File(path) as f:
        ds = f[internal]
        got, chunks = ds[()], ds.chunks
        if name in INDEXES:
            assert ds._index_type == INDEXES[name]
    np.testing.assert_array_equal(got, ref)
    assert chunks == ref_chunks
    assert got.dtype == arrays[array].dtype
    np.testing.assert_array_equal(got, arrays[array])


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
