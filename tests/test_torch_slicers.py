"""The PyTorch port's `TrainingDataSlicer` against the JAX package's, from
ndarrays and from HDF5 files: the same class count, codes, relabelled
volume and slices, the downsampled-label path and the shape check."""

from types import SimpleNamespace

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu.data.slicers import TrainingDataSlicer as JaxSlicer
from volume_segmantics_tpu_torch.data import TrainingDataSlicer
from volume_segmantics_tpu_torch.utils import hdf5

SHAPE = (9, 14, 11)


def settings(**overrides):
    base = dict(st_dev_factor=2.575, downsample=False, clip_data=False,
                data_hdf5_path="/data", seg_hdf5_path="/seg",
                training_axes="All")
    base.update(overrides)
    return SimpleNamespace(**base)


def labels(kind, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "binary": rng.integers(0, 2, shape).astype(np.uint8),
        "binary_255": (rng.integers(0, 2, shape) * 255).astype(np.uint8),
        "no_zero": rng.integers(1, 3, shape).astype(np.uint8),
        "gaps": rng.choice(np.array([0, 3, 7], np.int64), shape),
        "multilabel": rng.integers(0, 5, shape).astype(np.uint16),
    }[kind]


def data(dtype, shape=SHAPE, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.normal(100, 30, shape).astype(dtype)


def assert_same_slicer(ours, ref):
    assert ours.num_seg_classes == ref.num_seg_classes
    assert ours.multilabel == ref.multilabel
    assert ours.codes == ref.codes
    np.testing.assert_array_equal(ours.seg_vol, ref.seg_vol)
    assert ours.seg_vol.dtype == ref.seg_vol.dtype
    np.testing.assert_array_equal(ours.data_vol, ref.data_vol)
    assert ours.data_vol_shape == ref.data_vol_shape
    assert ours.input_data_chunking == ref.input_data_chunking
    for got, want in zip(ours.get_slice_arrays(), ref.get_slice_arrays()):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.uint8


@pytest.mark.parametrize("label_kind", ["binary", "binary_255", "no_zero",
                                        "gaps", "multilabel"])
@pytest.mark.parametrize("axes", ["All", "Z", "x"])
def test_slicer_from_ndarrays_equals_jax(label_kind, axes):
    s = settings(training_axes=axes)
    vol, lab = data("uint8"), labels(label_kind)
    assert_same_slicer(TrainingDataSlicer(vol, lab.copy(), s),
                       JaxSlicer(vol, lab.copy(), s))


@pytest.mark.parametrize("writer", ["h5py", "port"])
@pytest.mark.parametrize("clip_data", [True, False], ids=["clip", "noclip"])
def test_slicer_from_hdf5_files_equals_jax(tmp_path, writer, clip_data):
    vol, lab = data("float32" if clip_data else "uint8"), labels("gaps")
    d, l = tmp_path / "d.h5", tmp_path / "l.hdf5"
    if writer == "h5py":
        with h5py.File(d, "w") as f:
            f.create_dataset("/data", data=vol, chunks=(3, 7, 11), compression="gzip")
        with h5py.File(l, "w") as f:
            f["/seg"] = lab
    else:
        hdf5.write(d, vol, "/data", chunks=(3, 7, 11))
        hdf5.write(l, lab, "/seg")
    s = settings(clip_data=clip_data)
    for args in ((str(d), str(l)), (d, l)):
        ours = TrainingDataSlicer(*args, s)
        assert_same_slicer(ours, JaxSlicer(*args, s))
    assert ours.input_data_chunking == (3, 7, 11)


def test_downsampled_labels_and_shape_check_equal_jax():
    vol, lab = data("float32", (10, 15, 13)), labels("multilabel", (10, 15, 13))
    s = settings(downsample=True, clip_data=True)
    ours = TrainingDataSlicer(vol, lab, s)
    assert ours.data_vol_shape == (5, 8, 7)
    assert_same_slicer(ours, JaxSlicer(vol, lab, s))
    with pytest.raises(ValueError, match="does not match") as a:
        TrainingDataSlicer(vol, lab[:, :4], settings())
    with pytest.raises(ValueError, match="does not match") as b:
        JaxSlicer(vol, lab[:, :4], settings())
    assert str(a.value) == str(b.value)


def test_png_export_is_not_ported_and_clean_up_does_nothing(tmp_path):
    """A slicer that wrote no slices deletes nothing; one that did deletes
    its own PNGs and directories and nothing else. (The PNG export is
    ported now; `tests/test_torch_datasets.py` holds its files against
    the JAX package's.)"""
    slicer = TrainingDataSlicer(data("uint8"), labels("binary"), settings())
    (tmp_path / "out").mkdir()
    (tmp_path / "out" / "other.png").write_bytes(b"kept")
    slicer.clean_up_slices()
    assert (tmp_path / "out" / "other.png").read_bytes() == b"kept"
    slicer.output_data_slices(tmp_path / "out", "data0")
    slicer.output_label_slices(tmp_path / "seg", "seg0")
    assert len(list((tmp_path / "out").glob("data0_*.png"))) == sum(SHAPE)
    slicer.clean_up_slices()
    assert [p.name for p in (tmp_path / "out").iterdir()] == ["other.png"]
    assert not (tmp_path / "seg").exists()
