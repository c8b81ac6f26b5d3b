"""The port's host preprocessing for prediction against the JAX package's,
bit for bit: clip_to_uint8 (eager and slab-streamed, with NaNs, integer
and float input), downsample_data, BaseDataManager, and the small helpers
and enums the predictor reads."""

from types import SimpleNamespace

import numpy as np
import pytest

import volume_segmantics_tpu.utils.base_data_utils as jax_utils
import volume_segmantics_tpu_torch.utils.base_data_utils as utils
from volume_segmantics_tpu.data.augmentations import (
    get_padded_dimension as jax_get_padded_dimension,
)
from volume_segmantics_tpu.data.base_data_manager import (
    BaseDataManager as JaxBaseDataManager,
)
from volume_segmantics_tpu.data.settings_data import (
    SettingsError as JaxSettingsError,
)
from volume_segmantics_tpu.data.settings_data import (
    require_settings as jax_require_settings,
)
from volume_segmantics_tpu_torch.data.augmentations import get_padded_dimension
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
from volume_segmantics_tpu_torch.data.settings_data import (
    SettingsError,
    require_settings,
)


def volume(kind, shape=(9, 14, 11), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "float_nan":
        vol = rng.normal(0.0, 1.0, shape)
        vol[rng.random(shape) < 0.05] = np.nan
        return vol
    if kind == "float32":
        return rng.uniform(-3.0, 7.0, shape).astype(np.float32)
    if kind == "int16":
        return rng.integers(-2000, 30000, shape).astype(np.int16)
    if kind == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    raise ValueError(kind)


KINDS = ["float_nan", "float32", "int16", "uint8"]


def assert_same(ours, ref):
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("st_dev_factor", [2.575, 0.5])
def test_clip_to_uint8_eager_is_bit_equal(kind, st_dev_factor):
    vol = volume(kind)
    mean = np.nanmean(vol)
    assert_same(utils.clip_to_uint8(vol.copy(), mean, st_dev_factor),
                jax_utils.clip_to_uint8(vol.copy(), mean, st_dev_factor))


@pytest.mark.parametrize("kind", KINDS)
def test_clip_to_uint8_streamed_is_bit_equal(kind):
    """The slab-streamed variant directly (several 64-slice slabs) and
    through clip_to_uint8 with both packages' switch lowered."""
    vol = volume(kind, shape=(150, 6, 5), seed=1)
    mean = np.nanmean(vol)
    assert_same(utils._clip_to_uint8_streaming(vol.copy(), mean, 2.575),
                jax_utils._clip_to_uint8_streaming(vol.copy(), mean, 2.575))


@pytest.mark.parametrize("kind", KINDS)
def test_clip_to_uint8_switches_to_streaming_above_threshold(kind, monkeypatch):
    vol = volume(kind, shape=(70, 5, 4), seed=2)
    mean = np.nanmean(vol)
    monkeypatch.setattr(utils, "CLIP_STREAM_THRESHOLD_VOXELS", 100)
    monkeypatch.setattr(jax_utils, "CLIP_STREAM_THRESHOLD_VOXELS", 100)
    calls = []
    real = utils._clip_to_uint8_streaming
    monkeypatch.setattr(utils, "_clip_to_uint8_streaming",
                        lambda *a: calls.append(1) or real(*a))
    ours = utils.clip_to_uint8(vol.copy(), mean, 2.575)
    assert calls == [1]
    assert_same(ours, jax_utils.clip_to_uint8(vol.copy(), mean, 2.575))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(8, 10, 12), (7, 9, 13), (1, 3, 2)])
def test_downsample_data_is_bit_equal(kind, shape):
    vol = volume(kind, shape=shape, seed=3)
    assert_same(utils.downsample_data(vol.copy()),
                jax_utils.downsample_data(vol.copy()))


def manager_settings(clip_data, downsample):
    return SimpleNamespace(clip_data=clip_data, downsample=downsample,
                           st_dev_factor=2.575, data_hdf5_path="/data")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("clip_data", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("downsample", [True, False], ids=["down", "full"])
def test_base_data_manager_is_bit_equal(kind, clip_data, downsample):
    vol = volume(kind, shape=(9, 16, 11), seed=4)
    settings = manager_settings(clip_data, downsample)
    ours = BaseDataManager(vol.copy(), settings)
    ref = JaxBaseDataManager(vol.copy(), settings)
    assert_same(ours.data_vol, ref.data_vol)
    assert ours.data_vol_shape == ref.data_vol_shape
    assert ours.input_data_chunking is ref.input_data_chunking is True
    np.testing.assert_array_equal(ours.data_mean, ref.data_mean)
    assert not np.isnan(ours.data_vol).any()


def test_base_data_manager_path_input_is_not_ported(tmp_path):
    """Path input is read eagerly, as the JAX package reads a volume below
    its lazy-ingest threshold: the same volume and chunking, and the same
    error for an unsupported suffix or a non-array."""
    from volume_segmantics_tpu_torch.utils import hdf5

    settings = manager_settings(True, False)
    vol = volume("float32", shape=(9, 16, 11), seed=5)
    path = tmp_path / "vol.h5"
    hdf5.write(path, vol, chunks=(3, 8, 11))
    for arg in (path, str(path)):
        ours, ref = BaseDataManager(arg, settings), JaxBaseDataManager(arg, settings)
        assert_same(ours.data_vol, ref.data_vol)
        assert ours.input_data_chunking == ref.input_data_chunking == (3, 8, 11)
    (tmp_path / "vol.raw").write_bytes(b"")
    for bad, err in ((tmp_path / "vol.raw", "Unsupported volume file type"),
                     ([[1, 2]], "numpy array")):
        with pytest.raises(ValueError, match=err) as a:
            BaseDataManager(bad, settings)
        with pytest.raises(ValueError, match=err) as b:
            JaxBaseDataManager(bad, settings)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("axis", ["Z", "Y", "X"])
def test_rotate_array_to_axis(axis):
    vol = volume("uint8")
    ours = utils.rotate_array_to_axis(vol, utils.Axis[axis])
    assert_same(ours, jax_utils.rotate_array_to_axis(vol, jax_utils.Axis[axis]))
    assert_same(utils.rotate_array_to_axis(ours, utils.Axis[axis]), vol)


@pytest.mark.parametrize("classes", [2, 3, 5])
def test_one_hot_encode_array(classes):
    labels = np.random.default_rng(classes).integers(0, classes, (4, 6, 5))
    assert_same(utils.one_hot_encode_array(labels, classes),
                jax_utils.one_hot_encode_array(labels, classes))


def test_padded_dimension_enums_and_settings_helpers():
    for d in (1, 24, 31, 32, 33, 40, 64, 97, 512):
        assert get_padded_dimension(d) == jax_get_padded_dimension(d)
    for ours, ref in ((utils.Quality, jax_utils.Quality),
                      (utils.Axis, jax_utils.Axis)):
        assert [(m.name, m.value) for m in ours] == \
            [(m.name, m.value) for m in ref]
    settings = SimpleNamespace(quality="high", prediction_axis="x")
    assert utils.get_prediction_quality(settings).name == \
        jax_utils.get_prediction_quality(settings).name == "HIGH"
    assert utils.get_prediction_axis(settings).name == \
        jax_utils.get_prediction_axis(settings).name == "X"
    assert utils.get_prediction_axis(SimpleNamespace()) == utils.Axis.Z


def test_require_settings_lists_every_missing_key():
    settings = SimpleNamespace(clip_data=True)
    keys = ("clip_data", "one_hot", "downsample")
    with pytest.raises(SettingsError) as ours:
        require_settings(settings, keys, "prediction")
    with pytest.raises(JaxSettingsError) as ref:
        jax_require_settings(settings, keys, "prediction")
    for err in (ours, ref):
        assert "'one_hot', 'downsample'" in str(err.value)
    assert issubclass(SettingsError, ValueError)
    require_settings(settings, ("clip_data",), "prediction")
