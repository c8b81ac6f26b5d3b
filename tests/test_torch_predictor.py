"""The PyTorch predictor and prediction manager on the CPU against the JAX
package's, from one checkpoint file that the port writes and both load,
and the predictor's own rules (padding, merging, rotation, out-of-memory
backoff).

The model is U-Net/ResNet-34 with seeded random weights and its
segmentation head scaled x20, so that probabilities are confident and
near-ties rare, and each class's logit centred on noise, so that every
class wins a real share of the voxels. Both sides run in float32 on the same uint8 volume. The
near-tie rule: single-axis labels (2 classes) are equal wherever the JAX
max probability exceeds 0.5 + 1e-4; merged labels are equal on >= 99.9%
of voxels and every other voxel is a near-tie (max probabilities within
1e-3 of each other); float16 max probabilities are within 1e-3
everywhere; one-hot votes are equal except at those near-tie voxels.

The parity tests run at 2 and at 3 classes. Each class count builds its
JAX predictor once (a module-scoped fixture), with `data_parallel: False`,
so that sweeps are not sharded over the test session's 8 host devices.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from volume_segmantics_tpu.data.base_data_manager import (
    BaseDataManager as JaxBaseDataManager,
)
from volume_segmantics_tpu.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor as JaxPredictor,
)
from volume_segmantics_tpu.model.operations.vol_seg_2d_predictor import (
    _reflect101_indices as jax_reflect101_indices,
)
from volume_segmantics_tpu.utils.base_data_utils import Axis as JaxAxis
from volume_segmantics_tpu_torch.model import VolSeg2DPredictionManager
from volume_segmantics_tpu_torch.model.model_2d import create_model_on_device
from volume_segmantics_tpu_torch.model.operations import vol_seg_2d_predictor as vp
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.models.checkpoint import save_checkpoint
from volume_segmantics_tpu_torch.parallel.train import normalise
from volume_segmantics_tpu_torch.utils.base_data_utils import (
    Axis,
    ModelType,
    Quality,
)

torch.set_num_threads(1)

SHAPE = (6, 40, 24)  # no side a multiple of 32: every sweep pads and crops
HEAD_SCALE = 20.0


def predict_settings(**overrides):
    """The shipped prediction settings, small and in float32."""
    settings = dict(
        quality="medium", output_probs=False, clip_data=True,
        st_dev_factor=2.575, data_hdf5_path="/data", cuda_device=0,
        downsample=False, one_hot=False, prediction_axis="Z",
        compute_dtype="float32", prediction_batch_size=4,
        data_parallel=False,
    )
    settings.update(overrides)
    return SimpleNamespace(**settings)


def write_checkpoint(path, classes, model_type=ModelType.U_NET, slices=None,
                     encoder_name="resnet34"):
    """A seeded model whose head is scaled x20 and centred on `slices`
    (uint8, (n, h, w); default 8 noise images of 64 x 64)."""
    struc = {"type": model_type, "encoder_name": encoder_name,
             "encoder_weights": None, "in_channels": 1, "classes": classes}
    model = create_model_on_device(
        "cpu", struc, generator=torch.Generator().manual_seed(classes))
    head = model.segmentation_head[0]
    if slices is None:
        slices = np.random.default_rng(classes).integers(
            0, 256, (8, 64, 64), dtype=np.uint8)
    model.eval()
    with torch.no_grad():
        head.weight.mul_(HEAD_SCALE)
        head.bias.mul_(HEAD_SCALE)
        # Centre each class's logit on the slices, so that every class wins
        # a real share of the voxels.
        logits = model(normalise(torch.from_numpy(slices).float() / 255.0))
        head.bias.sub_(logits.transpose(0, 1).flatten(1).median(dim=1).values)
    save_checkpoint(path, model, struc)
    return path


class Pair:
    """The port's and the JAX package's predictors on one checkpoint, with
    each result computed once."""

    def __init__(self, ckpt, classes):
        self.ckpt, self.classes = ckpt, classes
        self.ours = VolSeg2dPredictor(ckpt, predict_settings(), device="cpu")
        self.ref = JaxPredictor(ckpt, predict_settings())
        self.vol = np.random.default_rng(classes).integers(
            0, 256, SHAPE, dtype=np.uint8)
        self._cache = {}

    def run(self, method, **kwargs):
        key = (method, tuple(sorted(kwargs.items())))
        if key not in self._cache:
            jax_kwargs = {k: JaxAxis[v.name] if isinstance(v, Axis) else v
                          for k, v in kwargs.items()}
            self._cache[key] = (getattr(self.ours, method)(self.vol, **kwargs),
                                getattr(self.ref, method)(self.vol, **jax_kwargs))
        return self._cache[key]


@pytest.fixture(scope="module", params=[2, 3], ids=lambda c: f"{c}class")
def pair(request, tmp_path_factory):
    classes = request.param
    ckpt = write_checkpoint(
        tmp_path_factory.mktemp("predictor") / "model.pytorch", classes)
    return Pair(ckpt, classes)


def assert_near_ties(ours, ref, single_axis_two_class=False):
    """The near-tie rule of the module doc; returns the voxels whose labels
    differ."""
    (labels, probs), (ref_labels, ref_probs) = ours, ref
    assert labels.dtype == np.uint8 and probs.dtype == np.float16
    assert labels.shape == ref_labels.shape and probs.shape == ref_probs.shape
    probs, ref_probs = probs.astype(np.float32), ref_probs.astype(np.float32)
    prob_err = np.abs(probs - ref_probs)
    assert prob_err.max() <= 1e-3
    differ = labels != ref_labels
    if single_axis_two_class:
        assert not (differ & (ref_probs > 0.5 + 1e-4)).any()
    else:
        assert differ.mean() <= 1e-3
        assert (prob_err[differ] <= 1e-3).all()
    return differ


def test_reference_labels_are_not_degenerate(pair):
    """The parity tests mean something only if the random model's labels
    vary: every class covers a real share of the JAX labels, and the three
    single-axis sweeps disagree somewhere (so a fault in turning a sweep's
    axis or rotation would show)."""
    sweeps = [pair.run("_predict_single_axis", axis=a)[1][0]
              for a in (Axis.Z, Axis.Y, Axis.X)]
    for labels in sweeps + [pair.run("_predict_12_ways_max_probs")[1][0]]:
        shares = np.bincount(labels.ravel(), minlength=pair.classes) / labels.size
        assert shares.size == pair.classes and shares.min() >= 0.05, shares
    assert not np.array_equal(sweeps[0], sweeps[1])
    assert not np.array_equal(sweeps[1], sweeps[2])


@pytest.mark.parametrize("axis", [Axis.Z, Axis.Y, Axis.X], ids=lambda a: a.name)
def test_single_axis_matches_jax(pair, axis):
    ours, ref = pair.run("_predict_single_axis", axis=axis)
    assert_near_ties(ours, ref, single_axis_two_class=pair.classes == 2)
    labels, probs = pair.ours._predict_single_axis(pair.vol, False, axis)
    assert probs is None
    np.testing.assert_array_equal(labels, ours[0])


def test_three_ways_matches_jax(pair):
    ours, ref = pair.run("_predict_3_ways_max_probs")
    assert_near_ties(ours, ref)


def test_twelve_ways_matches_jax(pair):
    ours, ref = pair.run("_predict_12_ways_max_probs")
    assert_near_ties(ours, ref)


@pytest.mark.parametrize("quality", [Quality.LOW, Quality.MEDIUM, Quality.HIGH],
                         ids=lambda q: q.name)
def test_one_hot_matches_jax(pair, quality):
    one_hot, max_prob, weight = {
        Quality.LOW: ("_predict_single_axis_to_one_hot",
                      "_predict_single_axis", 1),
        Quality.MEDIUM: ("_predict_3_ways_one_hot",
                         "_predict_3_ways_max_probs", 3),
        Quality.HIGH: ("_predict_12_ways_one_hot",
                       "_predict_12_ways_max_probs", 12),
    }[quality]
    votes, ref_votes = pair.run(one_hot)
    assert votes.dtype == np.uint8
    assert votes.shape == ref_votes.shape == (pair.classes, *SHAPE)
    assert (votes.sum(0) == weight).all()
    near_ties = assert_near_ties(*pair.run(max_prob),
                                 single_axis_two_class=pair.classes == 2)
    np.testing.assert_array_equal(votes[:, ~near_ties],
                                  ref_votes[:, ~near_ties])


@pytest.mark.parametrize("quality", [Quality.LOW, Quality.MEDIUM],
                         ids=lambda q: q.name)
def test_manager_matches_jax_preprocessing_and_predictor(pair, quality):
    """The manager (clip_data on, a float volume with a NaN) against the JAX
    data manager's volume through the JAX predictor."""
    data = np.random.default_rng(5).normal(100.0, 30.0, SHAPE)
    data[1, 2, 3] = np.nan
    settings = predict_settings()
    manager = VolSeg2DPredictionManager(pair.ckpt, data.copy(), settings,
                                        device="cpu")
    labels = manager.predict_volume_to_path(None, quality)
    jax_vol = JaxBaseDataManager(data.copy(), settings).data_vol
    np.testing.assert_array_equal(manager.data_vol, jax_vol)
    if quality == Quality.LOW:
        ref = pair.ref._predict_single_axis(jax_vol)
    else:
        ref = pair.ref._predict_3_ways_max_probs(jax_vol)
    assert labels.dtype == np.uint8 and labels.shape == SHAPE
    differ = labels != ref[0]
    assert differ.mean() <= 1e-3
    assert manager.get_label_codes() == {}


# ----------------------------------------------------------------------
# The port alone
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt2(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "m.pytorch", 2)


@pytest.fixture()
def small_predictor(ckpt2):
    return VolSeg2dPredictor(ckpt2, predict_settings(), device="cpu")


@pytest.mark.parametrize("size", [1, 2, 3, 5, 24])
@pytest.mark.parametrize("before,after", [(0, 8), (4, 4), (40, 41), (61, 3)])
def test_reflect101_indices_for_wide_pads(size, before, after):
    idx = vp._reflect101_indices(-before, size + after, size)
    np.testing.assert_array_equal(
        idx, jax_reflect101_indices(-before, size + after, size))
    row = np.arange(size)
    if size > 1:  # np.pad's reflect is OpenCV's BORDER_REFLECT_101
        np.testing.assert_array_equal(
            row[idx], np.pad(row, (before, after), mode="reflect"))
    assert ((idx >= 0) & (idx < size)).all()


def test_merge_tie_keeps_the_earlier_sweep():
    l0 = torch.zeros((2, 2, 2), dtype=torch.uint8)
    l1 = torch.ones((2, 2, 2), dtype=torch.uint8)
    p0 = torch.full((2, 2, 2), 0.5, dtype=torch.float16)
    p1 = torch.full((2, 2, 2), 0.5, dtype=torch.float16)
    p1[0] = 0.9
    labels, probs = VolSeg2dPredictor._merge_pair(l0, p0, l1, p1)
    assert (labels[0] == 1).all()  # higher prob wins
    assert (labels[1] == 0).all()  # tie keeps the first sweep
    assert (probs[0] == torch.tensor(0.9, dtype=torch.float16)).all()
    assert (l0 == 0).all() and (p0 == 0.5).all()  # inputs left as they were
    VolSeg2dPredictor._merge_into(l0, p0, l1, p1)  # in place, same rule
    assert torch.equal(l0, labels) and torch.equal(p0, probs)


def test_merge_vols_in_mem_host_containers(small_predictor):
    labels = [np.zeros((2, 3), np.uint8), np.ones((2, 3), np.uint8)]
    probs = [np.full((2, 3), 0.6, np.float16), np.full((2, 3), 0.6, np.float16)]
    probs[1][0, 0] = 0.7
    small_predictor._merge_vols_in_mem(probs, labels)
    assert labels[0].tolist() == [[1, 0, 0], [0, 0, 0]]
    assert probs[0][0, 0] == np.float16(0.7)


def test_twelve_way_weights_sum_to_twelve(small_predictor):
    vol = torch.zeros(SHAPE, dtype=torch.uint8)
    three = small_predictor._three_way_sweeps(vol)
    twelve = small_predictor._twelve_way_sweeps(vol)
    assert [w for _, w in three] == [1, 1, 1]
    # merge order z0, y0, x0, y1, x1, y2, x2, x3; z0, y0, y1, y2 count twice
    assert [w for _, w in twelve] == [2, 2, 1, 2, 1, 2, 1, 1]
    assert sum(w for _, w in twelve) == 12


@pytest.mark.parametrize("k", [-3, -2, -1, 0, 1, 2, 3, 5])
def test_rot90_matches_numpy_on_a_non_cubic_volume(k):
    vol = np.arange(3 * 5 * 7).reshape(3, 5, 7)
    ours = vp._rot90(torch.from_numpy(vol), k).numpy()
    assert ours.shape == np.rot90(vol, k).shape
    np.testing.assert_array_equal(ours, np.rot90(vol, k))
    back = vp._rot90(vp._rot90(torch.from_numpy(vol), k), -k).numpy()
    np.testing.assert_array_equal(back, vol)


def test_out_of_memory_halves_the_batch_and_recovers(small_predictor,
                                                     monkeypatch):
    vol = np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)
    small_predictor.batch_size = 8
    reference = small_predictor._predict_single_axis(vol)
    real_sweep = small_predictor._sweep
    attempts = []

    def sweep_once_out_of_memory(v):
        attempts.append(small_predictor.batch_size)
        if len(attempts) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real_sweep(v)

    monkeypatch.setattr(small_predictor, "_sweep", sweep_once_out_of_memory)
    labels, probs = small_predictor._predict_single_axis(vol)
    assert attempts == [8, 4]
    assert small_predictor.batch_size == 4
    np.testing.assert_array_equal(labels, reference[0])
    np.testing.assert_array_equal(probs, reference[1])


def test_out_of_memory_at_batch_one_and_other_errors_propagate(
        small_predictor, monkeypatch):
    vol = np.zeros(SHAPE, np.uint8)
    attempts = []

    def always_out_of_memory(v):
        attempts.append(small_predictor.batch_size)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    small_predictor.batch_size = 4
    monkeypatch.setattr(small_predictor, "_sweep", always_out_of_memory)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        small_predictor._predict_single_axis(vol)
    assert attempts == [4, 2, 1]

    def broken(v):
        raise RuntimeError("shape oops")

    small_predictor.batch_size = 4
    monkeypatch.setattr(small_predictor, "_sweep", broken)
    with pytest.raises(RuntimeError, match="shape oops"):
        small_predictor._predict_single_axis(vol)
    assert small_predictor.batch_size == 4
