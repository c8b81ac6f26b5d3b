"""The PyTorch `VolSeg2DPredictionManager` on the CPU: dispatch by quality
and one-hot, the settings check, HDF5 input and output files, streaming
above the in-memory limit (more in test_torch_large_predictor.py), the CUDA
default and the prediction batch. Parity of its results with the JAX
package is in test_torch_predictor.py."""

import numpy as np
import pytest
import torch

from test_torch_predictor import SHAPE, predict_settings, write_checkpoint
from volume_segmantics_tpu.model.operations.vol_seg_prediction_manager import (
    VolSeg2DPredictionManager as JaxPredictionManager,
)
from volume_segmantics_tpu_torch.data.settings_data import SettingsError
from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.utils import config as cfg
from volume_segmantics_tpu_torch.utils import hdf5
from volume_segmantics_tpu_torch.utils.base_data_utils import (
    Axis,
    ModelType,
    Quality,
    get_batch_size,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt2(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "m.pytorch", 2)


@pytest.fixture()
def vol():
    return np.random.default_rng(1).integers(0, 256, SHAPE, dtype=np.uint8)


def test_a_path_input_is_not_ported(ckpt2, vol, tmp_path):
    """A path input is read with the port's HDF5 reader: the manager holds
    the same volume as from the ndarray, and the file's chunking."""
    path = tmp_path / "vol.h5"
    hdf5.write(path, vol, chunks=(4, 8, 8))
    from_array = VolSeg2DPredictionManager(ckpt2, vol, predict_settings(),
                                           device="cpu")
    for arg in (str(path), path):
        manager = VolSeg2DPredictionManager(ckpt2, arg, predict_settings(),
                                            device="cpu")
        np.testing.assert_array_equal(manager.data_vol, from_array.data_vol)
        assert manager.input_data_chunking == (4, 8, 8)
    with pytest.raises(FileNotFoundError):
        VolSeg2DPredictionManager(ckpt2, tmp_path / "absent.h5",
                                  predict_settings(), device="cpu")


@pytest.mark.parametrize("one_hot,output_probs",
                         [(False, False), (False, True), (True, True)])
def test_an_output_path_is_not_ported(ckpt2, vol, tmp_path, one_hot,
                                      output_probs, monkeypatch):
    """An output path writes what is returned, gzip at /data with the
    input's chunking (one-hot votes fall back to h5py's guess), and the
    float16 max-probabilities beside it only when `output_probs` is set;
    only then are the probabilities asked for."""
    settings = predict_settings(quality="low", one_hot=one_hot,
                                output_probs=output_probs)
    path = tmp_path / "vol.h5"
    hdf5.write(path, vol, chunks=(4, 8, 8))
    manager = VolSeg2DPredictionManager(ckpt2, path, settings, device="cpu")
    asked = []
    real = manager.predictor._predict_single_axis
    monkeypatch.setattr(manager.predictor, "_predict_single_axis",
                        lambda data, output_probs=False, **kw: asked.append(
                            output_probs) or real(data, output_probs, **kw))
    out = tmp_path / "pred.h5"
    labels = manager.predict_volume_to_path(out)
    written, chunks = hdf5.read(out)
    np.testing.assert_array_equal(written, labels)
    assert chunks == (hdf5.guess_chunk(labels.shape, 1) if one_hot else (4, 8, 8))
    probs_path = tmp_path / "pred_probs.h5"
    assert probs_path.exists() == (output_probs and not one_hot)
    if not one_hot:
        assert asked == [output_probs]
    if probs_path.exists():
        probs, chunks = hdf5.read(probs_path)
        assert probs.dtype == np.float16 and probs.shape == SHAPE
        assert chunks == (4, 8, 8)
        assert ((probs >= 0.5) & (probs <= 1)).all()
    manager.predict_volume_to_path(None)
    assert asked[-1:] == ([False] if not one_hot else [])


def test_volumes_above_the_in_memory_limit_are_not_ported(ckpt2, vol,
                                                          monkeypatch):
    """Above the in-memory limit the manager streams through the slab
    predictor (prediction-batch slabs), with the in-memory path's labels;
    at the limit it predicts in memory."""
    from volume_segmantics_tpu_torch.model.operations import (
        vol_seg_prediction_manager as vpm,
    )

    made = []

    class Recorded(vpm.VolSegLargeVolPredictor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(vpm, "VolSegLargeVolPredictor", Recorded)
    manager = VolSeg2DPredictionManager(
        ckpt2, vol, predict_settings(quality="low",
                                     streaming_threshold=vol.size - 1),
        device="cpu")
    streamed = manager.predict_volume_to_path(None)
    assert len(made) == 1 and made[0].slab_size == manager.predictor.batch_size
    assert isinstance(streamed, np.memmap)
    manager.settings.streaming_threshold = vol.size
    in_memory = manager.predict_volume_to_path(None)
    assert len(made) == 1 and in_memory.shape == SHAPE
    np.testing.assert_array_equal(streamed, in_memory)


def test_in_memory_limit_from_device_memory(ckpt2, vol):
    manager = VolSeg2DPredictionManager(ckpt2, vol, predict_settings(),
                                        device="cpu")
    plain = manager.in_memory_limit_voxels(one_hot=False)
    votes = manager.in_memory_limit_voxels(one_hot=True)
    assert plain > votes > 0
    assert plain * cfg.PREDICT_BYTES_PER_VOXEL == pytest.approx(
        votes * (cfg.PREDICT_BYTES_PER_VOXEL + 2), rel=1e-6)


DISPATCH = {
    ("low", False): ("_predict_single_axis", dict(output_probs=False,
                                                  axis=Axis.Y)),
    ("medium", False): ("_predict_3_ways_max_probs", dict(output_probs=False)),
    ("high", False): ("_predict_12_ways_max_probs", dict(output_probs=False)),
    ("low", True): ("_predict_single_axis_to_one_hot", dict(axis=Axis.Y)),
    ("medium", True): ("_predict_3_ways_one_hot", {}),
    ("high", True): ("_predict_12_ways_one_hot", {}),
}


@pytest.mark.parametrize("quality,one_hot", list(DISPATCH),
                         ids=lambda v: str(v))
def test_dispatch_by_quality_and_one_hot(ckpt2, vol, quality, one_hot,
                                         monkeypatch):
    settings = predict_settings(quality=quality, one_hot=one_hot,
                                prediction_axis="Y", clip_data=False)
    manager = VolSeg2DPredictionManager(ckpt2, vol, settings, device="cpu")
    calls = []
    labels = np.ones(SHAPE, np.uint8)
    for method in {m for m, _ in DISPATCH.values()}:
        def record(data, method=method, **kwargs):
            calls.append((method, data, kwargs))
            if method.endswith("one_hot"):
                return np.stack([labels, labels])
            return labels, None
        monkeypatch.setattr(manager.predictor, method, record)
    out = manager.predict_volume_to_path(None)
    method, kwargs = DISPATCH[(quality, one_hot)]
    assert [(m, k) for m, _, k in calls] == [(method, kwargs)]
    assert calls[0][1] is manager.data_vol
    assert out.shape == ((2, *SHAPE) if one_hot else SHAPE)


def test_an_explicit_quality_overrides_the_setting(ckpt2, vol):
    manager = VolSeg2DPredictionManager(
        ckpt2, vol, predict_settings(quality="high"), device="cpu")
    labels = manager.predict_volume_to_path(None, quality=Quality.LOW)
    np.testing.assert_array_equal(
        labels, manager.predictor._predict_single_axis(manager.data_vol)[0])


def test_prediction_axis_all_and_missing_settings_raise(ckpt2, vol):
    manager = VolSeg2DPredictionManager(
        ckpt2, vol, predict_settings(prediction_axis="All"), device="cpu")
    with pytest.raises(ValueError, match="prediction_axis"):
        manager.predict_volume_to_path(None)
    settings = predict_settings()
    del settings.one_hot, settings.clip_data
    with pytest.raises(SettingsError, match="'clip_data', 'one_hot'"):
        VolSeg2DPredictionManager(ckpt2, vol, settings, device="cpu")


def test_cuda_is_the_default_and_raises_without_a_gpu(ckpt2, vol, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        VolSeg2dPredictor(ckpt2, predict_settings())
    with pytest.raises(RuntimeError, match="No CUDA device"):
        VolSeg2DPredictionManager(ckpt2, vol, predict_settings())


@pytest.mark.parametrize("model_type", [
    "U_NET_PLUS_PLUS", "FPN", "DEEPLABV3", "DEEPLABV3_PLUS", "MA_NET",
    "LINKNET", "PAN"])
def test_medium_matches_the_jax_manager_for_each_decoder(model_type,
                                                         tmp_path):
    """MEDIUM on a 32^3 volume, unclipped, from one checkpoint of each
    decoder (seeded, head scaled x20 and centred on the volume's Z slices,
    see test_torch_predictor.py), against the JAX manager on the same file,
    by test_torch_predictor.py's near-tie rule for merged labels: equal on
    >= 99.9% of voxels."""
    vol = np.random.default_rng(2).integers(0, 256, (32, 32, 32),
                                            dtype=np.uint8)
    ckpt = write_checkpoint(tmp_path / "m.pytorch", 2, ModelType[model_type],
                            slices=vol)
    settings = predict_settings(clip_data=False)
    labels = VolSeg2DPredictionManager(
        ckpt, vol, settings, device="cpu").predict_volume_to_path(None)
    ref = JaxPredictionManager(ckpt, vol, settings).predict_volume_to_path(None)
    assert labels.shape == ref.shape == vol.shape
    assert (labels != ref).mean() <= 1e-3
    shares = np.bincount(ref.ravel(), minlength=2) / ref.size
    assert shares.min() >= 0.05, shares  # both classes take a real share


@pytest.mark.parametrize("encoder_name", ["resnext50_32x4d", "timm-resnest50d"])
def test_medium_matches_the_jax_manager_for_each_encoder(encoder_name,
                                                         tmp_path):
    """MEDIUM on a 32^3 volume, as the decoders' test above, from a U-Net
    on a grouped-conv and a split-attention encoder: equal to the JAX
    manager's labels on >= 99.9% of voxels."""
    vol = np.random.default_rng(3).integers(0, 256, (32, 32, 32),
                                            dtype=np.uint8)
    ckpt = write_checkpoint(tmp_path / "m.pytorch", 2, slices=vol,
                            encoder_name=encoder_name)
    settings = predict_settings(clip_data=False)
    labels = VolSeg2DPredictionManager(
        ckpt, vol, settings, device="cpu").predict_volume_to_path(None)
    ref = JaxPredictionManager(ckpt, vol, settings).predict_volume_to_path(None)
    assert labels.shape == ref.shape == vol.shape
    assert (labels != ref).mean() <= 1e-3
    shares = np.bincount(ref.ravel(), minlength=2) / ref.size
    assert shares.min() >= 0.05, shares


def test_prediction_batch_size_setting_and_default():
    assert get_batch_size(predict_settings(prediction_batch_size=6), "cpu",
                          prediction=True) == 6
    settings = predict_settings(prediction_batch_size=None, batch_size=5)
    assert get_batch_size(settings, "cpu", prediction=True) == cfg.BIG_PRED_BATCH
    assert get_batch_size(settings, "cpu") == 5
