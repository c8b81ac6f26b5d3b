"""The port's slab-streaming predictor (`VolSegLargeVolPredictor`) on the
CPU: equal at every voxel to the port's in-memory path (whose parity with
the JAX package is in test_torch_predictor.py) for LOW along each axis,
MEDIUM, HIGH and the three one-hot paths, when the slab is the prediction
batch (4 and 5, neither dividing the (12, 34, 21) volume); against the JAX
package's large predictor under the near-tie rule; the view-spec algebra;
the merge rule; memmap lifetime and HDF5 output.

A slab that is not a multiple of the batch gives other batches, and the
CPU's convolutions then differ in the last bits of a probability, so the
equality tests run at slab == batch, as the port's default does."""

import gc
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import volume_segmantics_tpu.utils.base_data_utils as jax_utils
from test_torch_predictor import assert_near_ties, predict_settings, write_checkpoint
from volume_segmantics_tpu.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor as JaxPredictor,
)
from volume_segmantics_tpu.model.operations.vol_seg_large_predictor import (
    VolSegLargeVolPredictor as JaxLargePredictor,
)
from volume_segmantics_tpu.model.operations.vol_seg_large_predictor import (
    _view_spec as jax_view_spec,
)
from volume_segmantics_tpu_torch.model.operations import vol_seg_large_predictor as vlp
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_predictor import (
    VolSeg2dPredictor,
)
from volume_segmantics_tpu_torch.model.operations.vol_seg_large_predictor import (
    VolSegLargeVolPredictor,
)
from volume_segmantics_tpu_torch.utils import base_data_utils as utils
from volume_segmantics_tpu_torch.utils.base_data_utils import Axis, Quality

torch.set_num_threads(1)

SHAPE = (12, 34, 21)


class Case:
    """One checkpoint and slab (= prediction batch): the in-memory and the
    streamed result of each method, each computed once."""

    STREAMED = {
        "_predict_single_axis": "predict_single_axis",
        "_predict_3_ways_max_probs": "predict_3_ways",
        "_predict_12_ways_max_probs": "predict_12_ways",
        "_predict_single_axis_to_one_hot": "predict_single_axis_one_hot",
        "_predict_3_ways_one_hot": "predict_3_ways_one_hot",
        "_predict_12_ways_one_hot": "predict_12_ways_one_hot",
    }

    def __init__(self, ckpt, classes, slab, tmp, shape=SHAPE):
        self.ckpt, self.classes, self.slab = ckpt, classes, slab
        self.predictor = VolSeg2dPredictor(
            ckpt, predict_settings(prediction_batch_size=slab), device="cpu")
        self.large = VolSegLargeVolPredictor(self.predictor, workdir=tmp,
                                             slab_size=slab)
        self.vol = np.random.default_rng(classes).integers(
            0, 256, shape, dtype=np.uint8)
        self._cache = {}

    def run(self, method, **kwargs):
        key = (method, tuple(sorted(kwargs.items())))
        if key not in self._cache:
            self._cache[key] = (
                getattr(self.large, self.STREAMED[method])(self.vol, **kwargs),
                getattr(self.predictor, method)(self.vol, **kwargs))
        return self._cache[key]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Case(classes, slab), made once each."""
    made = {}

    def get(classes, slab):
        if (classes, slab) not in made:
            tmp = tmp_path_factory.mktemp(f"large{classes}")
            made[classes, slab] = Case(
                write_checkpoint(tmp / "model.pytorch", classes), classes, slab,
                tmp / "work")
        return made[classes, slab]

    return get


@pytest.fixture(scope="module")
def case(cases):
    return cases(2, 4)


def assert_equal_pair(streamed, in_memory):
    (labels, probs), (ref_labels, ref_probs) = streamed, in_memory
    assert labels.dtype == np.uint8 and labels.shape == SHAPE
    np.testing.assert_array_equal(labels, ref_labels)
    if ref_probs is None:
        assert probs is None
    else:
        assert probs.dtype == np.float16
        np.testing.assert_array_equal(probs, ref_probs)


# (classes, slab, method, axis): 2 classes at slab 4 on every path, 3
# classes at slab 5 on one LOW axis and every merged path.
EQUALITY = [
    (2, 4, "_predict_single_axis", Axis.Z), (2, 4, "_predict_single_axis", Axis.Y),
    (2, 4, "_predict_single_axis", Axis.X), (3, 5, "_predict_single_axis", Axis.Y),
] + [(c, s, m, None) for c, s in ((2, 4), (3, 5))
     for m in ("_predict_3_ways_max_probs", "_predict_12_ways_max_probs")]
VOTES = [(2, 4, "_predict_single_axis_to_one_hot", 1),
         (2, 4, "_predict_3_ways_one_hot", 3), (2, 4, "_predict_12_ways_one_hot", 12),
         (3, 5, "_predict_3_ways_one_hot", 3), (3, 5, "_predict_12_ways_one_hot", 12)]


def case_id(v):
    return v.name if isinstance(v, Axis) else str(v)


@pytest.mark.parametrize("classes,slab,method,axis", EQUALITY, ids=case_id)
def test_streamed_equals_in_memory(cases, classes, slab, method, axis):
    c = cases(classes, slab)
    kwargs = {} if axis is None else {"axis": axis}
    assert_equal_pair(*c.run(method, **kwargs))
    if axis is not None:
        labels, probs = c.large.predict_single_axis(c.vol, axis,
                                                    output_probs=False)
        assert probs is None
        np.testing.assert_array_equal(labels, c.run(method, **kwargs)[1][0])


@pytest.mark.parametrize("classes,slab,method,weight", VOTES, ids=case_id)
def test_one_hot_streamed_equals_in_memory(cases, classes, slab, method, weight):
    c = cases(classes, slab)
    kwargs = {"axis": Axis.X} if method == "_predict_single_axis_to_one_hot" else {}
    votes, ref = c.run(method, **kwargs)
    assert votes.dtype == np.uint8 and votes.shape == (classes, *SHAPE)
    np.testing.assert_array_equal(votes, ref)
    assert (votes.sum(0) == weight).all()


def test_sweep_temporaries_are_unlinked(case):
    """Only the accumulators stay in the workdir; the per-sweep memmaps
    are gone once merged, and the peak counts one sweep's temporaries
    beside the accumulator (3 + 3 bytes a voxel)."""
    work = VolSegLargeVolPredictor(case.predictor, slab_size=case.slab)
    work.predict_3_ways(case.vol)
    names = sorted(p.name for p in work.workdir.iterdir())
    assert names == ["001_labels.npy", "002_probs.npy"]
    voxels = case.vol.size
    assert 6 * voxels <= work.peak_workdir_bytes < 7 * voxels


# ----------------------------------------------------------------------
# Against the JAX package's large predictor
# ----------------------------------------------------------------------

# Every side a multiple of the slab: one slab shape a sweep, so the JAX
# side compiles each of its 8 sweep programs once.
JAX_SHAPE = (8, 36, 24)


@pytest.fixture(scope="module")
def jax_pair(case, tmp_path_factory):
    """(the port's streamed Case, the JAX large predictor) at slab 4."""
    tmp = tmp_path_factory.mktemp("jax_large")
    ours = Case(case.ckpt, 2, 4, tmp / "ours", shape=JAX_SHAPE)
    settings = predict_settings(prediction_batch_size=4)
    ref = JaxLargePredictor(JaxPredictor(case.ckpt, settings),
                            workdir=tmp / "jax", slab_size=4)
    return ours, ref


def test_medium_max_prob_matches_jax(jax_pair):
    ours, ref = jax_pair
    assert_near_ties(ours.large.predict_3_ways(ours.vol),
                     tuple(np.asarray(a) for a in ref.predict_3_ways(ours.vol)))


def test_high_one_hot_matches_jax(jax_pair):
    """Votes equal wherever the HIGH max-prob labels are not near-ties."""
    ours, ref = jax_pair
    votes = ours.large.predict_12_ways_one_hot(ours.vol)
    ref_votes = np.asarray(ref.predict_12_ways_one_hot(ours.vol))
    near_ties = assert_near_ties(
        ours.large.predict_12_ways(ours.vol),
        tuple(np.asarray(a) for a in ref.predict_12_ways(ours.vol)))
    assert (votes.sum(0) == 12).all()
    np.testing.assert_array_equal(votes[:, ~near_ties], ref_votes[:, ~near_ties])


# ----------------------------------------------------------------------
# Pieces
# ----------------------------------------------------------------------


def test_view_spec_algebra_matches_numpy():
    """The view specs reproduce rotate_array_to_axis(np.rot90(V, k), a) for
    all 12 TTA frames, and _read_spec_slab + transpose/flip reconstructs
    each frame's leading-axis slabs exactly (port of the JAX test)."""
    vol = np.arange(5 * 6 * 7, dtype=np.uint8).reshape(5, 6, 7)
    for k in range(4):
        for axis in (Axis.Z, Axis.Y, Axis.X):
            expected = utils.rotate_array_to_axis(np.rot90(vol, k), axis)
            spec = vlp._view_spec(axis, k)
            assert spec == jax_view_spec(jax_utils.Axis[axis.name], k)
            assert vlp._spec_shape(vol.shape, spec) == expected.shape
            perm = tuple(a for a, _ in spec)
            flips = tuple(f for _, f in spec)
            n = vol.shape[perm[0]]
            for start, stop in ((0, 2), (2, n), (0, n)):
                raw = vlp._read_spec_slab(vol, spec, start, stop)
                got = np.transpose(raw, perm)
                for ax, f in enumerate(flips):
                    if f:
                        got = np.flip(got, axis=ax)
                assert np.array_equal(got, expected[start:stop]), (k, axis)


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("axis", [Axis.Z, Axis.Y, Axis.X], ids=lambda a: a.name)
def test_sweep_slab_turns_on_the_device_side(case, axis, k):
    """`_sweep_slab` of a source-order slab equals the in-memory sweep of
    the frame's view: the transpose and flips happen inside."""
    spec = vlp._view_spec(axis, k)
    perm = tuple(a for a, _ in spec)
    flips = tuple(f for _, f in spec)
    frame = np.ascontiguousarray(utils.rotate_array_to_axis(np.rot90(case.vol, k), axis))
    raw = torch.from_numpy(vlp._read_spec_slab(case.vol, spec, 0, frame.shape[0]))
    labels, probs = case.predictor._sweep_slab(raw, perm, flips)
    ref_labels, ref_probs = case.predictor._axis_sweep(torch.from_numpy(frame), Axis.Z)
    assert torch.equal(labels, ref_labels) and torch.equal(probs, ref_probs)


def test_merge_is_strictly_greater_and_keeps_ties(case):
    """The slab-wise merge equals numpy's float16 compare on
    max-probabilities: strictly greater wins, a tie keeps the accumulator,
    across binades and subnormals, with slabs that do not divide the
    volume."""
    rng = np.random.default_rng(0)
    values = np.concatenate([
        rng.uniform(1e-7, 1.0, 4000), [6e-8, 1e-5, 0.25, 0.5, 0.5, 1.0, 1.0]]
    ).astype(np.float16)
    acc_p = rng.permutation(values)[:3 * 1335].reshape(3, 1335)
    new_p = rng.permutation(values)[:3 * 1335].reshape(1335, 3).T  # strided
    new_p[:, :50] = acc_p[:, :50]  # ties
    acc_l = np.zeros(acc_p.shape, np.uint8)
    new_l = np.ones(acc_p.shape, np.uint8)
    take = new_p > acc_p
    want_l, want_p = np.where(take, new_l, acc_l), np.where(take, new_p, acc_p)
    large = VolSegLargeVolPredictor(case.predictor, slab_size=2)
    large._merge_into(acc_l, acc_p, new_l, new_p)
    np.testing.assert_array_equal(acc_l, want_l)
    np.testing.assert_array_equal(acc_p, want_p)
    assert (acc_l[:, :50] == 0).all()


def test_memmap_results_survive_later_predictions(case, tmp_path):
    large = VolSegLargeVolPredictor(case.predictor, workdir=tmp_path,
                                    slab_size=case.slab)
    labels, _ = large.predict_single_axis(case.vol, output_probs=False)
    snapshot = np.array(labels)
    large.predict_3_ways(case.vol)
    np.testing.assert_array_equal(labels, snapshot)
    assert tmp_path.exists()  # a given workdir is kept


def test_own_tempdir_is_removed_and_results_stay_readable(case):
    large = VolSegLargeVolPredictor(case.predictor, slab_size=case.slab)
    workdir = large.workdir
    labels, _ = large.predict_single_axis(case.vol, Axis.Y, output_probs=False)
    snapshot = np.array(labels)
    del large
    gc.collect()
    assert not workdir.exists()
    np.testing.assert_array_equal(labels, snapshot)


@pytest.mark.parametrize("quality,method", [
    (Quality.LOW, "_predict_single_axis"),
    (Quality.MEDIUM, "_predict_3_ways_max_probs"),
    (Quality.HIGH, "_predict_12_ways_max_probs")], ids=lambda v: str(v))
def test_predict_to_hdf5_writes_the_quality_asked_for(case, tmp_path, quality,
                                                      method):
    out = tmp_path / f"{quality.name}.h5"
    case.large.predict_to_hdf5(case.vol, out, quality=quality)
    with h5py.File(out, "r") as f:
        ds = f["/data"]
        assert ds.compression == "gzip" and ds.dtype == np.uint8
        np.testing.assert_array_equal(ds[()], case.run(method)[1][0])


def test_a_float_ndarray_is_cast_as_the_in_memory_path_casts(case):
    vol = np.random.default_rng(9).uniform(-20.0, 300.0, SHAPE).astype(np.float32)
    streamed, _ = case.large.predict_single_axis(vol, Axis.Z, output_probs=False)
    np.testing.assert_array_equal(
        streamed, case.predictor._predict_single_axis(vol, False, Axis.Z)[0])


def test_tuple_results_are_views_over_memmaps(case):
    labels, probs = case.run("_predict_single_axis", axis=Axis.Y)[0]
    for arr in (labels, probs):
        base = arr
        while not isinstance(base, np.memmap):
            base = base.base
        assert Path(base.filename).parent == case.large.workdir
