"""Lazy HDF5 ingest in the PyTorch port against the JAX package's, on the
CPU: the slab-streamed statistics, the read-time clip transform and the
streamed downsample bit for bit; `LazyHDF5Volume` on the port's reader;
`BaseDataManager` keeping a large source lazy (clip on and off, float and
integer sources, both downsample branches) and the training slicer staying
eager; the prediction manager's dispatch of lazy sources under and over the
in-memory limit, its probability sidecars, and `model-predict-2d` with the
three settings keys (`lazy_ingest_threshold`, `streaming_threshold`,
`streaming_slab_size`)."""

import gc
import os
import weakref
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

import volume_segmantics_tpu.utils.base_data_utils as jax_utils
import volume_segmantics_tpu_torch.scripts.predict_2d_model as predict
import volume_segmantics_tpu_torch.utils.base_data_utils as utils
from test_torch_cli import write_settings
from test_torch_predictor import predict_settings, write_checkpoint
from volume_segmantics_tpu.data.base_data_manager import (
    BaseDataManager as JaxBaseDataManager,
)
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
from volume_segmantics_tpu_torch.data.slicers import TrainingDataSlicer
from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
from volume_segmantics_tpu_torch.utils import config as cfg
from volume_segmantics_tpu_torch.utils.base_data_utils import Quality

torch.set_num_threads(1)

SHAPE = (12, 34, 21)
CHUNKS = (4, 17, 8)


def volume(kind, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "float32_nan":
        vol = rng.normal(100.0, 25.0, shape).astype(np.float32)
        vol[rng.random(shape) < 0.03] = np.nan
        return vol
    if kind == "uint16":
        return rng.integers(0, 4000, shape).astype(np.uint16)
    if kind == "int16":
        return rng.integers(-2000, 30000, shape).astype(np.int16)
    if kind == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    raise ValueError(kind)


KINDS = ["float32_nan", "uint16", "int16"]


def h5py_file(path, vol, chunks=CHUNKS):
    with h5py.File(path, "w") as f:
        f.create_dataset("/data", data=vol, chunks=chunks, compression="gzip")
    return path


def assert_same(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


# ----------------------------------------------------------------------
# Streaming statistics, transform and downsample
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("slab", [5, 64])
def test_streaming_statistics_are_bit_equal(kind, slab):
    vol = volume(kind, (70, 9, 7), seed=1)
    mean = jax_utils.streaming_nanmean(vol, slab)
    assert utils.streaming_nanmean(vol, slab) == mean
    assert utils.streaming_nanstd(vol, mean, slab) == \
        jax_utils.streaming_nanstd(vol, mean, slab)


@pytest.mark.parametrize("kind", KINDS)
def test_clip_transform_is_bit_equal_and_splits_by_parts(kind, monkeypatch):
    vol = volume(kind, (30, 9, 7), seed=2)
    mean = float(np.nanmean(vol.astype(np.float64)))
    std = float(np.nanstd(vol.astype(np.float64)))
    ours = utils.make_clip_to_uint8_transform(mean, std, 2.575)
    ref = jax_utils.make_clip_to_uint8_transform(mean, std, 2.575)
    assert_same(ours(vol), ref(vol))
    # The lazy volume's threaded application in parts of 2 slices.
    monkeypatch.setattr(utils, "TRANSFORM_PART_VOXELS", 2 * 9 * 7)
    assert_same(utils._transform_in_parts(ours, vol, np.uint8), ref(vol))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(11, 9, 7), (12, 8, 6)])
def test_streaming_downsample_is_bit_equal(kind, shape, tmp_path):
    vol = volume(kind, shape, seed=3)
    ours = utils.streaming_downsample_to_memmap(vol, tmp_path / "a.npy", 3)
    ref = jax_utils.streaming_downsample_to_memmap(vol, tmp_path / "b.npy", 3)
    assert_same(ours, ref)
    assert_same(ours, jax_utils.downsample_data(vol))


@pytest.mark.parametrize("kind", KINDS + ["uint8"])
def test_streamed_clip_to_uint8_shares_the_transform(kind):
    """The eager slab-streamed clip and the lazy transform are one
    per-voxel function: both equal the JAX streamed clip."""
    vol = volume(kind, (150, 6, 5), seed=4)
    mean = np.nanmean(vol)
    assert_same(utils._clip_to_uint8_streaming(vol.copy(), mean, 2.575),
                jax_utils._clip_to_uint8_streaming(vol.copy(), mean, 2.575))


# ----------------------------------------------------------------------
# LazyHDF5Volume
# ----------------------------------------------------------------------

SELECTIONS = [np.s_[0:4], np.s_[5:12], np.s_[:, 3:20], np.s_[:, :, 7:15],
              np.s_[11:12], np.s_[:, 33:34], np.s_[2:9, 10:30, 1:20]]


@pytest.mark.parametrize("kind", KINDS + ["uint8"])
def test_lazy_volume_reads_like_jax(kind, tmp_path):
    vol = volume(kind, seed=5)
    path = h5py_file(tmp_path / "v.h5", vol)
    ours = utils.LazyHDF5Volume(path)
    ref = jax_utils.LazyHDF5Volume(path)
    for attr in ("shape", "ndim", "size", "dtype", "chunks"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    for sel in SELECTIONS:
        assert_same(ours[sel], ref[sel])
    assert ours.max_read_voxels == ref.max_read_voxels == 7 * 34 * 21
    transform = jax_utils.make_clip_to_uint8_transform(100.0, 20.0, 2.575)
    ours.set_transform(transform, np.uint8)
    ref.set_transform(transform, np.uint8)
    assert ours.dtype == ref.dtype == np.uint8
    for sel in SELECTIONS:
        assert_same(ours[sel], ref[sel])
    ours.close()
    ref.close()


def test_lazy_volume_inflates_only_the_chunks_a_slab_meets(tmp_path):
    path = h5py_file(tmp_path / "v.h5", volume("uint8", seed=6))
    lazy = utils.LazyHDF5Volume(path)
    lazy[0:4]  # one chunk row along Z: 2 x 3 chunks
    assert lazy.inflated_chunks == 2 * 3
    lazy[3:5]  # meets two chunk rows
    assert lazy.inflated_chunks == 6 + 12
    lazy[:, :, 16:21]  # the last X chunk column: 3 x 2
    assert lazy.inflated_chunks == 18 + 6
    lazy.close()


# ----------------------------------------------------------------------
# BaseDataManager and the slicer
# ----------------------------------------------------------------------


def manager_settings(clip_data, downsample=False, **more):
    return SimpleNamespace(clip_data=clip_data, downsample=downsample,
                           st_dev_factor=2.575, data_hdf5_path="/data", **more)


@pytest.mark.parametrize("kind", KINDS + ["uint8"])
@pytest.mark.parametrize("clip_data", [True, False], ids=["clip", "noclip"])
def test_lazy_ingest_matches_jax(kind, clip_data, tmp_path):
    """Above the threshold both keep the source lazy with the same chunks,
    the same data_mean bit for bit, and read the same uint8 slabs."""
    path = h5py_file(tmp_path / "v.h5", volume(kind, seed=7))
    settings = manager_settings(clip_data, lazy_ingest_threshold=1000,
                                streaming_slab_size=5)
    ours, ref = BaseDataManager(path, settings), JaxBaseDataManager(path, settings)
    assert isinstance(ours.data_vol, utils.LazyHDF5Volume)
    assert isinstance(ref.data_vol, jax_utils.LazyHDF5Volume)
    assert ours.input_data_chunking == ref.input_data_chunking == CHUNKS
    assert ours.data_vol_shape == ref.data_vol_shape == SHAPE
    assert ours.data_mean == ref.data_mean
    assert ours.data_vol.dtype == ref.data_vol.dtype == np.uint8
    for sel in SELECTIONS:
        assert_same(ours.data_vol[sel], ref.data_vol[sel])


@pytest.mark.parametrize("threshold,lazy", [(1000, True), (1200, False)],
                         ids=["stays_lazy", "materialises"])
@pytest.mark.parametrize("clip_data", [True, False], ids=["clip", "noclip"])
def test_lazy_downsample_branches_match_jax(threshold, lazy, clip_data, tmp_path):
    """The downsampled volume (6 x 17 x 11 = 1122 voxels) stays lazy over a
    float64 memmap above the threshold and is materialised below it; the
    scratch directory goes when the volume does."""
    path = h5py_file(tmp_path / "v.h5", volume("float32_nan", (12, 34, 22), seed=8),
                     chunks=(4, 17, 11))
    settings = manager_settings(clip_data, True, lazy_ingest_threshold=threshold,
                                streaming_slab_size=4)
    ours, ref = BaseDataManager(path, settings), JaxBaseDataManager(path, settings)
    assert ours.data_vol_shape == ref.data_vol_shape == (6, 17, 11)
    assert ours.data_mean == ref.data_mean
    assert isinstance(ours.data_vol, np.ndarray) != lazy
    full = np.s_[:, :, :]
    assert_same(ours.data_vol[full], ref.data_vol[full])
    scratch = ours._downsample_dir
    if not lazy:
        assert not os.path.exists(scratch)
        return
    gone = weakref.ref(ours.data_vol)
    del ours
    gc.collect()
    assert gone() is None and not os.path.exists(scratch)


def test_eager_and_lazy_ingest_agree(tmp_path):
    """The JAX test's rule for the two routes of one file: data_mean within
    1e-9 relative, and the clipped volumes almost everywhere equal (the
    streamed sigma sums in another order)."""
    vol = volume("float32_nan", seed=9)
    path = h5py_file(tmp_path / "v.h5", vol)
    eager = BaseDataManager(path, manager_settings(True))
    lazy = BaseDataManager(path, manager_settings(True, lazy_ingest_threshold=1000))
    assert isinstance(eager.data_vol, np.ndarray)
    assert np.isclose(lazy.data_mean, eager.data_mean, rtol=1e-9, atol=0)
    assert (lazy.data_vol[:] == eager.data_vol).mean() > 0.995


def test_the_training_slicer_stays_eager(tmp_path):
    vol = volume("uint8", seed=10)
    path = h5py_file(tmp_path / "v.h5", vol)
    labels = (vol > 128).astype(np.uint8)
    settings = manager_settings(False, lazy_ingest_threshold=10,
                                seg_hdf5_path="/data", training_axes="All",
                                data_im_dirname="data", seg_im_out_dirname="seg")
    slicer = TrainingDataSlicer(path, labels, settings)
    assert isinstance(slicer.data_vol, np.ndarray)
    np.testing.assert_array_equal(slicer.data_vol, vol)


# ----------------------------------------------------------------------
# The prediction manager and model-predict-2d
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "m.pytorch", 2)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    vol = volume("float32_nan", seed=11)
    return vol, h5py_file(tmp_path_factory.mktemp("src") / "v.h5", vol)


def lazy_settings(**more):
    return predict_settings(lazy_ingest_threshold=1000, streaming_slab_size=4,
                            **more)


@pytest.mark.parametrize("quality", [Quality.LOW, Quality.MEDIUM, Quality.HIGH],
                         ids=lambda q: q.name)
def test_lazy_sources_under_and_over_the_limit(ckpt, source, quality,
                                               monkeypatch):
    """Under the limit a lazy source is assembled on the device and takes
    the in-memory path; over it, it streams. Both give the labels of the
    in-memory path on the same lazily preprocessed volume."""
    _, path = source
    under = VolSeg2DPredictionManager(ckpt, path, lazy_settings(), device="cpu")
    assert isinstance(under.data_vol, utils.LazyHDF5Volume)
    uploaded = []
    real = under._upload_lazy_to_device
    monkeypatch.setattr(under, "_upload_lazy_to_device",
                        lambda v: uploaded.append(v) or real(v))
    labels = under.predict_volume_to_path(None, quality)
    assert len(uploaded) == 1 and isinstance(labels, np.ndarray)
    assert under.data_vol.max_read_voxels <= 4 * 34 * 21  # one batch of slices
    over = VolSeg2DPredictionManager(
        ckpt, path, lazy_settings(streaming_threshold=1000), device="cpu")
    streamed = over.predict_volume_to_path(None, quality)
    assert isinstance(streamed, np.memmap) or isinstance(streamed.base, np.memmap)
    np.testing.assert_array_equal(streamed, labels)
    assert over.data_vol.max_read_voxels <= 4 * 34 * 21  # a slab's largest face
    reference = under.predictor
    vol_u8 = under.data_vol[:]
    method = {Quality.LOW: "_predict_single_axis",
              Quality.MEDIUM: "_predict_3_ways_max_probs",
              Quality.HIGH: "_predict_12_ways_max_probs"}[quality]
    np.testing.assert_array_equal(labels, getattr(reference, method)(vol_u8)[0])


@pytest.mark.parametrize("quality,one_hot", [("low", False), ("medium", False),
                                             ("medium", True)])
def test_streamed_outputs_and_probability_sidecars(ckpt, source, tmp_path,
                                                   quality, one_hot):
    """Streaming writes what it returns and, with `output_probs`, the
    float16 max-probabilities beside it, equal to the in-memory path's and
    readable by h5py; its memmap directory (made beside the output) is gone
    once the call returns, while the result stays readable."""
    _, path = source
    outs = {}
    for name, threshold in (("streamed", 1000), ("in_memory", None)):
        settings = lazy_settings(quality=quality, one_hot=one_hot,
                                 output_probs=True, streaming_threshold=threshold)
        out = tmp_path / name / "pred.h5"
        out.parent.mkdir()
        result = VolSeg2DPredictionManager(
            ckpt, path, settings, device="cpu").predict_volume_to_path(out)
        with h5py.File(out, "r") as f:
            np.testing.assert_array_equal(f["/data"][()], result)
            assert f["/data"].chunks == ((CHUNKS if not one_hot else
                                          f["/data"].chunks))
        probs = out.with_name("pred_probs.h5")
        assert probs.exists() == (not one_hot)
        if probs.exists():
            with h5py.File(probs, "r") as f:
                outs[name, "probs"] = f["/data"][()]
                assert outs[name, "probs"].dtype == np.float16
        outs[name] = np.array(result)
        assert sorted(p.name for p in out.parent.iterdir()) == sorted(
            ["pred.h5"] + (["pred_probs.h5"] if not one_hot else []))
    np.testing.assert_array_equal(outs["streamed"], outs["in_memory"])
    if not one_hot:
        np.testing.assert_array_equal(outs["streamed", "probs"],
                                      outs["in_memory", "probs"])


def test_model_predict_2d_with_the_streaming_keys(ckpt, source, tmp_path):
    """`model-predict-2d` with the three settings keys in the settings file
    writes the labels of the eager run at every voxel."""
    vol, path = source
    runs = {}
    for name, edits in (
            ("eager", {}),
            ("streamed", dict(lazy_ingest_threshold=1000, streaming_threshold=1000,
                              streaming_slab_size=4))):
        data_dir = tmp_path / name
        write_settings(data_dir, cfg.PREDICTION_SETTINGS_FN, clip_data=False,
                       compute_dtype="float32", prediction_batch_size=4, **edits)
        predict.main([str(ckpt), str(path), "--data_dir", str(data_dir)],
                     device="cpu")
        out = predict.create_output_path(data_dir, path)
        with h5py.File(out, "r") as f:
            runs[name] = f["/data"][()]
        assert sorted(p.name for p in data_dir.iterdir()) == sorted(
            [cfg.SETTINGS_DIR, out.name])
    assert runs["eager"].shape == vol.shape
    np.testing.assert_array_equal(runs["streamed"], runs["eager"])
