"""Prediction over several devices on the CPU (`parallel/predict.py`,
`parallel/multihost_predict.py`, the predictor, the streaming predictor and
the prediction manager), from the seeded, head-scaled checkpoint of
`test_torch_predictor.py`:

- the predictor with `devices=["cpu", "cpu"]`: each sweep's slices split
  into two blocks (the slice count padded as the JAX sweep pads it), at
  LOW on each axis, MEDIUM and HIGH, max-probability and one-hot: labels
  and votes equal to one device's, float16 max-probabilities within 1e-3;
  `data_parallel: false` gives one device; the streaming predictor splits
  each slab the same way;
- the manager on a lazy HDF5 source: read straight onto the two devices,
  a block each, the labels one device's; its in-memory limit doubles on
  two devices where they divide the slices, as the JAX manager's lazy
  limit scales, and not where they do not;
- multi-host prediction over 2 gloo ranks: `local_slice_range` and its
  ValueError, partial files (labels and float16 max-probabilities, the
  `global_start` / `global_slices` attributes) that h5py reads and that
  stitch, by the port and by the JAX package, to the one-process Z sweep;
  and the port's stitch of partials that h5py wrote.
"""

import h5py
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from test_torch_lazy_ingest import h5py_file, volume
from test_torch_predictor import predict_settings, write_checkpoint
from volume_segmantics_tpu.parallel.multihost_predict import (
    stitch_partial_predictions as jax_stitch_partial_predictions,
)
from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.model.operations.vol_seg_large_predictor import (
    VolSegLargeVolPredictor,
)
from volume_segmantics_tpu_torch.parallel import multihost_predict as mh
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks
from volume_segmantics_tpu_torch.parallel.predict import ShardedVolume
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils.base_data_utils import Axis, Quality

torch.set_num_threads(cases.THREADS)

SHAPE = (9, 40, 24)  # no side a multiple of 32, 9 slices: padded blocks
TWO = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "m.pytorch", 2)


@pytest.fixture(scope="module")
def predictors(ckpt):
    one = VolSeg2dPredictor(ckpt, predict_settings(), device="cpu")
    two = VolSeg2dPredictor(ckpt, predict_settings(data_parallel=True),
                            devices=TWO)
    assert (one.n_dev, two.n_dev) == (1, 2)
    return one, two


VOL = np.random.default_rng(3).integers(0, 256, SHAPE, dtype=np.uint8)
CALLS = {
    "low_z": ("_predict_single_axis", {"axis": Axis.Z}),
    "low_y": ("_predict_single_axis", {"axis": Axis.Y}),
    "low_x": ("_predict_single_axis", {"axis": Axis.X}),
    "medium": ("_predict_3_ways_max_probs", {}),
    "high": ("_predict_12_ways_max_probs", {}),
    "one_hot_low": ("_predict_single_axis_to_one_hot", {"axis": Axis.Y}),
    "one_hot_medium": ("_predict_3_ways_one_hot", {}),
    "one_hot_high": ("_predict_12_ways_one_hot", {}),
}


def assert_same_prediction(got, ref):
    if isinstance(ref, tuple):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1].astype(np.float32),
                                   ref[1].astype(np.float32), atol=1e-3, rtol=0)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("call", CALLS)
def test_two_devices_give_one_devices_labels(predictors, call):
    one, two = predictors
    method, kwargs = CALLS[call]
    ref = getattr(one, method)(VOL, **kwargs)
    got = getattr(two, method)(VOL, **kwargs)
    assert_same_prediction(got, ref)
    if call == "medium":  # from a volume already split over the devices
        sharded = ShardedVolume([torch.from_numpy(VOL[:4]),
                                 torch.from_numpy(VOL[4:])])
        assert_same_prediction(two._predict_3_ways_max_probs(sharded), ref)


def test_each_device_sweeps_a_padded_block(predictors, monkeypatch):
    """9 Z slices at batch 4 over 2 devices: a local batch of 2, blocks of
    6 slices (9 padded to 12 by repeating the last), swept 2 at a time."""
    _, two = predictors
    seen = []
    real = two._sweep

    def sweep(v):
        seen.append(v.shape[0])
        return real(v)

    monkeypatch.setattr(two, "_sweep", sweep)
    two._predict_single_axis(VOL, axis=Axis.Z)
    assert seen == [6, 6]


def test_data_parallel_false_uses_the_first_device(ckpt):
    predictor = VolSeg2dPredictor(ckpt, predict_settings(data_parallel=False),
                                  devices=TWO)
    assert predictor.n_dev == 1 and predictor.devices == [torch.device("cpu")]


@pytest.mark.parametrize("quality", ["medium", "high"])
def test_streaming_predictor_splits_each_slab(predictors, quality, tmp_path):
    one, two = predictors
    runs = []
    for predictor in (one, two):
        large = VolSegLargeVolPredictor(predictor, slab_size=4,
                                        temp_parent=tmp_path)
        fn = large.predict_3_ways if quality == "medium" else large.predict_12_ways
        labels, probs = fn(VOL)
        runs.append((np.array(labels), np.array(probs)))
    assert_same_prediction(runs[1], runs[0])


def lazy_settings(**more):
    return predict_settings(lazy_ingest_threshold=1000, streaming_slab_size=4,
                            data_parallel=True, **more)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    folder = tmp_path_factory.mktemp("sources")
    return {n: h5py_file(folder / f"v{n}.h5",
                         volume("float32_nan", shape=(n, 34, 21), seed=11))
            for n in (10, 9)}


@pytest.mark.parametrize("quality", [Quality.LOW, Quality.MEDIUM],
                         ids=lambda q: q.name)
def test_lazy_source_is_read_onto_both_devices(ckpt, sources, quality,
                                               monkeypatch):
    one = VolSeg2DPredictionManager(ckpt, sources[10], lazy_settings(),
                                    device="cpu")
    two = VolSeg2DPredictionManager(ckpt, sources[10], lazy_settings(),
                                    devices=TWO)
    assert isinstance(two.data_vol, utils.LazyHDF5Volume)
    uploaded = []
    real = two._upload_lazy_to_device
    monkeypatch.setattr(two, "_upload_lazy_to_device",
                        lambda v: uploaded.append(real(v)) or uploaded[-1])
    labels = two.predict_volume_to_path(None, quality)
    (sharded,) = uploaded
    assert isinstance(sharded, ShardedVolume)
    assert [s.shape[0] for s in sharded.shards] == [5, 5]
    np.testing.assert_array_equal(labels, one.predict_volume_to_path(None, quality))


@pytest.mark.parametrize("n_slices,devices,streams", [
    (10, ["cpu"], True), (10, TWO, False), (9, TWO, True)])
def test_lazy_limit_scales_with_the_devices_that_divide_the_slices(
        ckpt, sources, n_slices, devices, streams, monkeypatch):
    """`streaming_threshold` just below the volume: one device streams it;
    two that divide its slices hold it in memory, as the JAX manager's
    lazy limit (threshold x devices) lets it; two that do not, stream."""
    size = n_slices * 34 * 21
    manager = VolSeg2DPredictionManager(
        ckpt, sources[n_slices], lazy_settings(streaming_threshold=size - 1),
        devices=devices)
    streamed = []
    real = manager._predict_streaming
    monkeypatch.setattr(manager, "_predict_streaming",
                        lambda *a: streamed.append(1) or real(*a))
    manager.predict_volume_to_path(None, Quality.LOW)
    assert bool(streamed) == streams


# ----------------------------------------------------------------------
# Multi-host prediction
# ----------------------------------------------------------------------


def test_local_slice_range_of_one_process():
    assert mh.local_slice_range(7) == (0, 7)


@pytest.fixture(scope="module")
def partials(ckpt, tmp_path_factory):
    folder = tmp_path_factory.mktemp("multihost")
    vol = np.random.default_rng(4).integers(0, 256, (10, 40, 24), dtype=np.uint8)
    np.save(folder / "vol.npy", vol)
    settings = vars(predict_settings())
    spawn_ranks(cases.multihost_rank, 2,
                args=(str(ckpt), settings, str(folder / "vol.npy"),
                      str(folder / "pred"), str(folder)),
                timeout=cases.TIMEOUT_S)
    ranks = [torch.load(folder / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    one = VolSeg2dPredictor(ckpt, predict_settings(), device="cpu")
    return vol, ranks, one._predict_single_axis(vol, axis=Axis.Z), folder


def test_partials_stitch_to_the_one_process_sweep(partials):
    vol, ranks, (labels, probs), folder = partials
    assert [r["range"] for r in ranks] == [(0, 5), (5, 10)]
    assert all(r["refused"] for r in ranks)  # 11 slices over 2 ranks
    paths = [r["path"] for r in ranks]
    assert paths == [str(folder / "pred_part0000.h5"),
                     str(folder / "pred_part0001.h5")]
    np.testing.assert_array_equal(mh.stitch_partial_predictions(paths[::-1]),
                                  labels)
    np.testing.assert_array_equal(jax_stitch_partial_predictions(paths), labels)
    for r, path in enumerate(paths):
        with h5py.File(path, "r") as f:
            assert f["/data"].attrs["global_start"] == 5 * r
            assert f["/data"].attrs["global_slices"] == 10
            assert f["/probs"].attrs["global_start"] == 5 * r
            assert f["/probs"].dtype == np.float16
            np.testing.assert_allclose(
                f["/probs"][()].astype(np.float32),
                probs[5 * r:5 * r + 5].astype(np.float32), atol=1e-3, rtol=0)


def test_port_stitches_partials_h5py_wrote(tmp_path):
    full = np.random.default_rng(5).integers(0, 4, (7, 6, 5), dtype=np.uint8)
    paths = []
    for start, stop in ((4, 7), (0, 4)):
        path = tmp_path / f"p_part{len(paths):04d}.h5"
        with h5py.File(path, "w") as f:
            d = f.create_dataset("/data", data=full[start:stop],
                                 compression="gzip")
            d.attrs["global_start"] = start
            d.attrs["global_slices"] = 7
        paths.append(path)
    np.testing.assert_array_equal(mh.stitch_partial_predictions(paths), full)
