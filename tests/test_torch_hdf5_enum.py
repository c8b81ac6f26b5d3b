"""HDF5 enumerations (datatype class 8) in the port's reader: h5py writes
every numpy bool array as an enumeration of FALSE = 0 and TRUE = 1, and
reads any enumeration of exactly those members as numpy bool, whatever its
integer base; any other enumeration reads as its base. Bool and enum
datasets in every layout (contiguous, compact, chunked under each chunk
index, n-bit), of either byte order, read equal in dtype and value to
h5py and, through `numpy_from_hdf5` and `LazyHDF5Volume`, to the JAX
package; so do their attributes, enum sources of virtual datasets, the
lazy preprocess of `BaseDataManager`, and `model-train-2d`'s slicing of a
bool label volume (its classes, `multilabel`, codes and label slices)."""

from types import SimpleNamespace

import h5py
import numpy as np
import pytest

import volume_segmantics_tpu.scripts.train_2d_model as jax_train
import volume_segmantics_tpu.utils.base_data_utils as jax_utils
import volume_segmantics_tpu_torch.scripts.train_2d_model as train
import volume_segmantics_tpu_torch.utils.base_data_utils as utils
from test_torch_cli import Handed, train_edits, write_settings
from test_torch_trainer import tiny_volume
from volume_segmantics_tpu.data.base_data_manager import (
    BaseDataManager as JaxBaseDataManager,
)
from volume_segmantics_tpu.data.slicers import (
    TrainingDataSlicer as JaxTrainingDataSlicer,
)
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
from volume_segmantics_tpu_torch.data.slicers import TrainingDataSlicer
from volume_segmantics_tpu_torch.utils import config as cfg
from volume_segmantics_tpu_torch.utils import hdf5

SHAPE = (10, 12, 14)
CHUNKS = (4, 5, 6)  # partial edge chunks on every axis

# name -> (h5py dtype, the values written; None: random bools).
GAPS = {"LOW": -300, "ZERO": 0, "MID": 7, "HIGH": 1000}  # gaps between values
TYPES = {
    "bool": (np.dtype(bool), None),
    "bool_members_u1": (h5py.enum_dtype({"FALSE": 0, "TRUE": 1}, basetype="u1"),
                        [0, 1, 1, 2, 200]),
    "bool_members_be_u2": (h5py.enum_dtype({"FALSE": 0, "TRUE": 1},
                                           basetype=">u2"), [0, 1, 5, 300]),
    "bool_members_i1_raw": (h5py.enum_dtype({"FALSE": 0, "TRUE": 1},
                                            basetype="i1"), [0, 1, 2, -1]),
    "enum_u1": (h5py.enum_dtype({"A": 0, "B": 1, "C": 2}, basetype="u1"),
                [0, 1, 2]),
    "enum_be_i2_gaps": (h5py.enum_dtype(GAPS, basetype=">i2"),
                        [-300, 0, 7, 1000, 5]),
    "enum_le_u4": (h5py.enum_dtype({"X": 3, "Y": 70000}, basetype="<u4"),
                   [3, 70000]),
}

# name -> (File keywords, dataset creation: "compact", "nbit" or keywords).
LAYOUTS = {
    "contiguous": ({}, {}),
    "compact": ({}, "compact"),
    "btree1_gzip": ({}, dict(chunks=CHUNKS, compression="gzip")),
    "fixed_array_shuffle": ({"libver": "latest"},
                            dict(chunks=CHUNKS, shuffle=True, compression="gzip")),
    "extensible_array": ({"libver": "latest"},
                         dict(chunks=CHUNKS, maxshape=(None, 12, 14),
                              compression="gzip", fletcher32=True)),
    "btree2": ({"libver": "latest"}, dict(chunks=CHUNKS, maxshape=(None, None, 14))),
    "nbit": ({}, "nbit"),
}


def values(name, shape=SHAPE, seed=0):
    dtype, choices = TYPES[name]
    rng = np.random.default_rng(seed)
    if choices is None:
        return rng.random(shape) < 0.4
    return rng.choice(np.array(choices), shape).astype(dtype)


def write(path, name, layout, data=None, dataset="data"):
    """`data` (default `values(name)`) as `dataset` of type `name` in
    `layout`."""
    file_kw, ds_kw = LAYOUTS[layout]
    dtype = TYPES[name][0]
    data = values(name) if data is None else data
    with h5py.File(path, "a", **file_kw) as f:
        if isinstance(ds_kw, dict):
            f.create_dataset(dataset, data=data, dtype=dtype, **ds_kw)
        else:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            if ds_kw == "compact":
                dcpl.set_layout(h5py.h5d.COMPACT)
            else:
                dcpl.set_chunk(CHUNKS)
                dcpl.set_filter(h5py.h5z.FILTER_NBIT)
            ds = h5py.h5d.create(f.id, dataset.encode(),
                                 h5py.h5t.py_create(dtype, logical=True),
                                 h5py.h5s.create_simple(data.shape), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(
                data, np.dtype(dtype).newbyteorder("=") if dtype != bool else bool))
    return path


def assert_reads_equal(path, name="data"):
    """The port reads `name` as h5py does, in dtype and value (bools as
    their bytes); `numpy_from_hdf5` and `LazyHDF5Volume` as the JAX
    package's."""
    with h5py.File(path, "r") as f:
        ref = f[name][()]
    sel = np.s_[2:7, 3] if ref.ndim == 3 else np.s_[1:]
    with hdf5.File(path) as f:
        got = f[name][()]
        part = f[name][sel]
    assert got.dtype == ref.dtype.newbyteorder("=")
    np.testing.assert_array_equal(got.view(np.uint8) if got.dtype == bool else got,
                                  ref.view(np.uint8) if ref.dtype == bool else ref)
    np.testing.assert_array_equal(part, got[sel])
    ours, chunks = utils.numpy_from_hdf5(path, hdf5_path=name)
    theirs, jax_chunks = jax_utils.numpy_from_hdf5(path, hdf5_path=name)
    assert ours.dtype == theirs.dtype.newbyteorder("=") and chunks == jax_chunks
    np.testing.assert_array_equal(ours, theirs)
    lazy = utils.LazyHDF5Volume(path, hdf5_path=name)
    jax_lazy = jax_utils.LazyHDF5Volume(path, hdf5_path=name)
    try:
        assert lazy.dtype == jax_lazy.dtype.newbyteorder("=")
        np.testing.assert_array_equal(lazy[1:6], jax_lazy[1:6])
    finally:
        lazy.close()
        jax_lazy.close()
    return got


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(TYPES))
def test_enumerations_read_as_h5py_reads_them(tmp_path, name, layout):
    got = assert_reads_equal(write(tmp_path / "e.h5", name, layout))
    assert (got.dtype == bool) == name.startswith("bool")


def test_h5py_bool_rule_by_experiment(tmp_path):
    """h5py's rule, as its reads show: FALSE = 0 and TRUE = 1 on any base
    read as bool; other names (lower case), another value or a third
    member keep the base."""
    cases = {"upper_u2": ({"FALSE": 0, "TRUE": 1}, "<u2", True),
             "lower": ({"false": 0, "true": 1}, "i1", False),
             "swapped": ({"FALSE": 1, "TRUE": 0}, "i1", False),
             "third": ({"FALSE": 0, "TRUE": 1, "MAYBE": 2}, "u1", False)}
    path = tmp_path / "rule.h5"
    with h5py.File(path, "w") as f:
        for key, (members, base, _) in cases.items():
            f.create_dataset(key, data=np.array([0, 1, 1], base),
                             dtype=h5py.enum_dtype(members, basetype=base))
    for key, (_, base, is_bool) in cases.items():
        with h5py.File(path, "r") as f:
            assert (f[key].dtype == bool) == is_bool
        got = assert_reads_equal(path, key)
        assert got.dtype == (np.dtype(bool) if is_bool else np.dtype(base))


def test_enum_attributes_read_as_h5py_reads_them(tmp_path):
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("data", data=np.zeros(3, "u1"))
        ds.attrs["flag"] = np.bool_(True)
        ds.attrs["flags"] = np.array([True, False, True])
        ds.attrs.create("levels", np.array([7, -300, 1000], ">i2"),
                        dtype=h5py.enum_dtype(GAPS, basetype=">i2"))
    with h5py.File(path, "r") as f:
        ref = dict(f["data"].attrs)
    with hdf5.File(path) as f:
        got = f["data"].attrs
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype.newbyteorder("=")
        np.testing.assert_array_equal(got[key], value)
    assert isinstance(got["flag"], np.bool_)


def virtual_over(path, source, source_type, vds_type):
    layout = h5py.VirtualLayout(shape=SHAPE, dtype=TYPES[vds_type][0])
    layout[:] = h5py.VirtualSource(str(source), "data", shape=SHAPE,
                                   dtype=TYPES[source_type][0])
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("data", layout, fillvalue=None)
    return path


@pytest.mark.parametrize("name", ["bool", "enum_be_i2_gaps"])
def test_an_enum_source_under_the_same_enum_reads(tmp_path, name):
    source = write(tmp_path / "s.h5", name, "btree1_gzip")
    path = virtual_over(tmp_path / "v.h5", source, name, name)
    np.testing.assert_array_equal(assert_reads_equal(path), hdf5.read(source)[0])


@pytest.mark.parametrize("source_type,vds_type", [
    ("enum_u1", "bool_members_u1"), ("bool", "enum_u1"), ("enum_u1", "bool")])
def test_other_enum_conversions_are_refused_by_name(tmp_path, source_type,
                                                    vds_type):
    source = write(tmp_path / "s.h5", source_type, "contiguous",
                   data=values(source_type).astype(np.uint8).view(
                       TYPES[source_type][0]) if source_type == "bool" else None)
    path = virtual_over(tmp_path / "v.h5", source, source_type, vds_type)
    with pytest.raises(NotImplementedError, match="virtual dataset sources of type"):
        hdf5.read(path)
    # A plain integer source under an enumeration, and back.
    plain = tmp_path / "p.h5"
    with h5py.File(plain, "w") as f:
        f["data"] = np.zeros(SHAPE, "u1")
    layout = h5py.VirtualLayout(shape=SHAPE, dtype=TYPES[vds_type][0])
    layout[:] = h5py.VirtualSource(str(plain), "data", shape=SHAPE, dtype="u1")
    with h5py.File(tmp_path / "w.h5", "w") as f:
        f.create_virtual_dataset("data", layout)
    with pytest.raises(NotImplementedError, match="virtual dataset sources of type"):
        hdf5.read(tmp_path / "w.h5")


@pytest.mark.parametrize("name", ["bool", "enum_be_i2_gaps", "bool_members_be_u2"])
def test_lazy_preprocess_matches_jax(tmp_path, name):
    """`BaseDataManager` keeps a large bool or enum source lazy and gives it
    the JAX package's transforms: the same data_mean and uint8 slabs."""
    path = write(tmp_path / "v.h5", name, "btree1_gzip")
    settings = SimpleNamespace(clip_data=False, downsample=False,
                               st_dev_factor=2.575, data_hdf5_path="/data",
                               lazy_ingest_threshold=100, streaming_slab_size=3)
    ours, ref = BaseDataManager(path, settings), JaxBaseDataManager(path, settings)
    assert isinstance(ours.data_vol, utils.LazyHDF5Volume)
    assert ours.data_mean == ref.data_mean
    assert ours.data_vol.dtype == ref.data_vol.dtype == np.uint8
    for sel in (np.s_[:], np.s_[3:8, 2:9]):
        np.testing.assert_array_equal(ours.data_vol[sel], ref.data_vol[sel])


def slicer_settings():
    return SimpleNamespace(clip_data=False, downsample=False, st_dev_factor=2.575,
                           data_hdf5_path="/data", seg_hdf5_path="/data",
                           training_axes="All", data_im_dirname="data",
                           seg_im_out_dirname="seg")


@pytest.mark.parametrize("layout", ["btree1_gzip", "contiguous"])
def test_the_slicer_on_a_bool_label_volume_matches_jax(tmp_path, layout):
    """F8: the JAX slicer takes an h5py bool label file: 2 classes, not
    multilabel, codes label_val_False / label_val_True, 0/1 uint8 label
    slices. The port's slicer gives the same."""
    data, labels = tiny_volume(4, (6, 20, 24))
    data_path = tmp_path / "d.h5"
    with h5py.File(data_path, "w") as f:
        f["data"] = data
    label_path = write(tmp_path / "l.h5", "bool", layout, data=labels.astype(bool))
    ours = TrainingDataSlicer(data_path, label_path, slicer_settings())
    ref = JaxTrainingDataSlicer(data_path, label_path, slicer_settings())
    assert (ours.num_seg_classes, ours.multilabel, ours.codes) == (
        ref.num_seg_classes, ref.multilabel, ref.codes) == (
        2, False, ["label_val_False", "label_val_True"])
    for side, jax_side in zip(ours.get_slice_arrays(), ref.get_slice_arrays()):
        assert len(side) == len(jax_side) == 6 + 20 + 24
        for got, want in zip(side, jax_side):
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    label_slices = ours.get_slice_arrays()[1]
    np.testing.assert_array_equal(label_slices[0], labels[0])
    assert set(np.unique(np.concatenate([s.ravel() for s in label_slices]))) == {0, 1}


def test_model_train_2d_on_bool_labels_hands_the_jax_cli_codes(tmp_path,
                                                              monkeypatch):
    """Both CLIs on an h5py bool label file hand their trainers the same
    stacks and the codes label_val_False / label_val_True, which the
    trainer writes into its checkpoint's label codes."""
    data, labels = tiny_volume(5, (8, 36, 40))
    data_path, label_path = tmp_path / "d.h5", tmp_path / "l.h5"
    with h5py.File(data_path, "w") as f:
        f.create_dataset("data", data=data, chunks=True, compression="gzip")
    with h5py.File(label_path, "w") as f:
        f.create_dataset("data", data=labels.astype(bool), chunks=(3, 16, 16),
                         compression="gzip")
    handed = {}
    for name, module in (("ours", train), ("jax", jax_train)):
        data_dir = tmp_path / name
        write_settings(data_dir, cfg.TRAIN_SETTINGS_FN,
                       **train_edits(slice_to_disk=False))

        def record(data, labels, codes, settings, device=None, name=name):
            raise Handed(data, labels, codes)

        monkeypatch.setattr(module, "VolSeg2dTrainer", record)
        argv = ["--data", str(data_path), "--labels", str(label_path),
                "--data_dir", str(data_dir)]
        with pytest.raises(Handed) as caught:
            if name == "ours":
                module.main(argv, device="cpu")
            else:
                monkeypatch.setattr("sys.argv", ["model-train-2d"] + argv)
                module.main()
        handed[name] = caught.value.args
    (d, l, codes), (jd, jl, jcodes) = handed["ours"], handed["jax"]
    assert codes == jcodes == {"0": "label_val_False", "1": "label_val_True"}
    for ours, theirs in ((d, jd), (l, jl)):
        assert len(ours) == len(theirs)
        for got, want in zip(ours, theirs):
            np.testing.assert_array_equal(got, want)
    assert {int(v) for s in l for v in np.unique(s)} == {0, 1}
