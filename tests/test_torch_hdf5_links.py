"""Groups and links in the port's HDF5 reader (`utils/hdf5.py`) against
h5py and the JAX package: link-message groups, compact and dense (a
fractal heap behind a version 2 B-tree of names, with and without a
creation-order index, direct and indirect heap blocks), soft links in both
kinds of group, external links and where their files are looked for,
cycles and the library's cap of 16 links on one lookup; the NeXus paths
through links in `numpy_from_hdf5` and `LazyHDF5Volume`."""

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu.utils import base_data_utils as jax_utils
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils import hdf5

SHAPE = (24, 40, 48)
NEXUS_PATH = "entry/final_result_tomo/data"


def volume(seed=0, dtype="<u2"):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4000, SHAPE).astype(dtype)


def read_both(path, name):
    with h5py.File(path, "r") as f:
        ref, ref_chunks = f[name][()], f[name].chunks
    with hdf5.File(path) as f:
        ds = f[name]
        got, chunks = ds[()], ds.chunks
    np.testing.assert_array_equal(got, ref)
    assert chunks == ref_chunks
    return got


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_soft_links_absolute_relative_and_chained(tmp_path, libver):
    path = tmp_path / "soft.nxs"
    vol = volume()
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("real/data", data=vol, chunks=True, compression="gzip")
        f[NEXUS_PATH] = h5py.SoftLink("/real/data")
        f["entry/relative"] = h5py.SoftLink("final_result_tomo/data")
        f["entry/to_group"] = h5py.SoftLink("/real")
        f["hop1"] = h5py.SoftLink("/hop2")
        f["hop2"] = h5py.SoftLink("/entry/to_group/data")
    for name in (NEXUS_PATH, "entry/relative", "entry/to_group/data", "hop1"):
        np.testing.assert_array_equal(read_both(path, name), vol)
    ours, chunks = utils.numpy_from_hdf5(path, nexus=True)
    ref, ref_chunks = jax_utils.numpy_from_hdf5(path, nexus=True)
    np.testing.assert_array_equal(ours, ref)
    assert chunks == ref_chunks


def test_a_track_order_group_of_13_members_is_dense(tmp_path):
    """track_order=True: link and attribute creation order tracked and
    indexed, version 2 object headers; past 8 members the links move to a
    fractal heap indexed by name and by creation order."""
    path = tmp_path / "track.h5"
    vol = volume()
    with h5py.File(path, "w", track_order=True) as f:
        group = f.create_group("entry", track_order=True)
        group.attrs["NX_class"] = "NXentry"
        for i in range(12):
            group[f"member_{i}"] = np.full((3,), i, np.int16)
        group["data"] = vol
    with hdf5.File(path) as f:
        msgs = f._messages(f._resolve("/entry", [16])[1])
        assert hdf5.MSG_LINK not in msgs  # no link message in the header
    np.testing.assert_array_equal(read_both(path, "entry/data"), vol)
    for i in (0, 11):
        np.testing.assert_array_equal(read_both(path, f"entry/member_{i}"), i)


@pytest.mark.parametrize("libver,track_order", [("earliest", False),
                                                 ("latest", True)])
def test_large_dense_groups_through_indirect_heap_blocks(tmp_path, libver,
                                                        track_order):
    """Thousands of links: the name index is a B-tree of several levels
    and the heap's root is an indirect block."""
    path = tmp_path / "big.h5"
    vol = volume()
    with h5py.File(path, "w", libver=libver) as f:
        f["data"] = vol
        group = f.create_group("g", track_order=track_order)
        for i in range(3000):
            group[f"member_with_a_longer_name_{i:05d}"] = h5py.SoftLink("/data")
        group["nested/data"] = vol[:2]
    with hdf5.File(path) as f:
        links = f._links(f._resolve("/g", [16])[1])
    assert len(links) == 3001
    for name in ("g/member_with_a_longer_name_00000",
                 "g/member_with_a_longer_name_02999", "g/nested/data"):
        read_both(path, name)


def write_external_pair(folder, target_name="target.h5"):
    vol = volume(1)
    with h5py.File(folder / target_name, "w", libver="latest") as f:
        f.create_dataset("vol/data", data=vol, chunks=(8, 16, 16),
                         maxshape=(None, 40, 48), compression="gzip",
                         shuffle=True, fletcher32=True)
    with h5py.File(folder / "scan.nxs", "w") as f:
        f[NEXUS_PATH] = h5py.ExternalLink(target_name, "/vol/data")
    return folder / "scan.nxs", vol


def test_external_links_read_and_stream_as_in_jax(tmp_path):
    path, vol = write_external_pair(tmp_path)
    np.testing.assert_array_equal(read_both(path, NEXUS_PATH), vol)
    ours, chunks = utils.numpy_from_hdf5(path, nexus=True)
    ref, ref_chunks = jax_utils.numpy_from_hdf5(path, nexus=True)
    np.testing.assert_array_equal(ours, ref)
    assert chunks == ref_chunks == (8, 16, 16)
    # A lazy volume reached through the link streams from the target file,
    # which its dataset keeps open.
    lazy = utils.LazyHDF5Volume(path, nexus=True)
    jax_lazy = jax_utils.LazyHDF5Volume(path, nexus=True)
    try:
        assert lazy.chunks == jax_lazy.chunks
        for sel in (np.s_[0:8], np.s_[5:19, 3], np.s_[:, :, 40:48]):
            np.testing.assert_array_equal(lazy[sel], jax_lazy[sel])
        assert lazy.inflated_chunks > 0
    finally:
        lazy.close()
        jax_lazy.close()
    with hdf5.File(path) as f:
        ds = f[NEXUS_PATH]
    assert ds._f.path.name == "target.h5"
    np.testing.assert_array_equal(ds[2:4], vol[2:4])  # its own file is open


def test_external_link_search_order_follows_the_library(tmp_path, monkeypatch):
    """A relative target is looked for in the linking file's directory,
    then in the working directory; $HDF5_EXT_PREFIX comes first, and an
    absolute name that does not open is looked for by its base name."""
    linking, cwd = tmp_path / "linking", tmp_path / "cwd"
    (cwd / "prefix").mkdir(parents=True)
    linking.mkdir()
    with h5py.File(linking / "link.h5", "w") as f:
        f["relative"] = h5py.ExternalLink("t.h5", "/data")
        f["absolute"] = h5py.ExternalLink(str(tmp_path / "gone" / "t.h5"), "/data")
        f["sub"] = h5py.ExternalLink("prefix/t.h5", "/data")
    for where, value in ((linking, 1), (cwd, 2), (cwd / "prefix", 3)):
        with h5py.File(where / "t.h5", "w") as f:
            f["data"] = np.full(3, value)
    monkeypatch.chdir(cwd)
    monkeypatch.delenv("HDF5_EXT_PREFIX", raising=False)

    def both(name):
        with h5py.File("../linking/link.h5", "r") as f:
            ref = f[name][()]
        with hdf5.File("../linking/link.h5") as f:
            got = f[name][()]
        np.testing.assert_array_equal(got, ref)
        return int(got[0])

    assert both("relative") == both("absolute") == 1  # the linking directory
    assert both("sub") == 3  # only the working directory has prefix/t.h5
    (linking / "t.h5").unlink()
    assert both("relative") == 2  # then the working directory
    monkeypatch.setenv("HDF5_EXT_PREFIX", str(cwd / "prefix"))
    assert both("relative") == 3  # the prefix first


def test_cycles_dangling_and_missing_links_raise(tmp_path):
    path = tmp_path / "links.h5"
    with h5py.File(path, "w") as f:
        f["data"] = np.arange(3)
        f["a"] = h5py.SoftLink("/b")
        f["b"] = h5py.SoftLink("/a")
        f["dangling"] = h5py.SoftLink("/nothing")
        f["external"] = h5py.ExternalLink("missing.h5", "/data")
        f["self"] = h5py.ExternalLink("links.h5", "/self")
    with h5py.File(path, "r") as f:
        with pytest.raises(RuntimeError, match="too many links"):
            f["a"]
        with pytest.raises(KeyError, match="too many links"):
            f["self"]
        for name in ("dangling", "external"):
            with pytest.raises(KeyError):
                f[name]
    with hdf5.File(path) as f:
        for name in ("a", "self"):
            with pytest.raises(KeyError, match="too many links"):
                f[name]
        with pytest.raises(KeyError, match="'nothing' not found"):
            f["dangling"]
        with pytest.raises(KeyError, match="can't open file 'missing.h5'"):
            f["external"]


@pytest.mark.parametrize("hops", [15, 16, 17])
def test_at_most_16_links_on_one_lookup(tmp_path, hops):
    path = tmp_path / "chain.h5"
    with h5py.File(path, "w") as f:
        f["data"] = np.arange(4)
        for i in range(hops - 1):
            f[f"hop{i}"] = h5py.SoftLink(f"/hop{i + 1}")
        f[f"hop{hops - 1}"] = h5py.SoftLink("/data")
    if hops <= hdf5.MAX_LINK_TRAVERSALS:
        read_both(path, "hop0")
        return
    with h5py.File(path, "r") as f, pytest.raises(RuntimeError):
        f["hop0"]
    with hdf5.File(path) as f, pytest.raises(KeyError, match="too many links"):
        f["hop0"]


def test_groups_are_not_datasets_and_missing_members_raise(tmp_path):
    path, _ = write_external_pair(tmp_path)
    with hdf5.File(path) as f:
        with pytest.raises(TypeError, match="is a group"):
            f["entry"]
        with pytest.raises(KeyError, match="component 'x' not found"):
            f["entry/x"]
        with pytest.raises(KeyError, match="is not a group"):
            f[f"{NEXUS_PATH}/deeper"]
