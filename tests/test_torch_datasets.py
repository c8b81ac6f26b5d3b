"""The library's PNG-directory workflow in the port against the JAX
package: the slicer's PNG export (file names and pixels) and clean-up,
`VolSeg2dDataset` (`stacked_arrays`, `__getitem__`, the mismatched-count
error), `VolSeg2dPredictionDataset`, the prediction transforms and
batcher, `get_2d_training_dataloaders` from directories against the same
slices as lists, and `VolSeg2dTrainer(image_dir, label_dir, ...)` against
the list-built trainer over two seeded steps."""

from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import volume_segmantics_tpu.data.augmentations as jax_augs
import volume_segmantics_tpu_torch.data.augmentations as augs
from volume_segmantics_tpu.data.dataloaders import (
    PredictionBatcher as JaxPredictionBatcher,
)
from volume_segmantics_tpu.data.datasets import (
    VolSeg2dDataset as JaxDataset,
)
from volume_segmantics_tpu.data.datasets import (
    get_2d_prediction_dataset as jax_prediction_dataset,
)
from volume_segmantics_tpu.data.datasets import (
    get_2d_training_dataset as jax_training_dataset,
)
from volume_segmantics_tpu.data.slicers import TrainingDataSlicer as JaxSlicer
from volume_segmantics_tpu_torch.data import TrainingDataSlicer, get_settings_data
from volume_segmantics_tpu_torch.data.dataloaders import (
    PredictionBatcher,
    get_2d_prediction_dataloader,
    get_2d_training_dataloaders,
)
from volume_segmantics_tpu_torch.data.datasets import (
    VolSeg2dDataset,
    get_2d_prediction_dataset,
    get_2d_training_dataset,
    natsort,
)
from volume_segmantics_tpu_torch.model import VolSeg2dTrainer
from volume_segmantics_tpu_torch.utils import config as cfg
from volume_segmantics_tpu_torch.utils.png import read_grey

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (6, 20, 26)  # no side a multiple of 32: every slice is resized
SLICER_SETTINGS = SimpleNamespace(st_dev_factor=2.575, downsample=False,
                                  clip_data=False, data_hdf5_path="/data",
                                  seg_hdf5_path="/seg", training_axes="All")


def pair(label_kind="binary_255", seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    labels = {"binary_255": (data > 150).astype(np.uint8) * 255,
              "multilabel": rng.integers(0, 4, SHAPE).astype(np.uint8)}[label_kind]
    return data, labels


def train_settings(**overrides):
    settings = get_settings_data(
        ROOT / "volseg-settings" / cfg.TRAIN_SETTINGS_FN, kind="training")
    values = dict(image_size=32, batch_size=4, compute_dtype="float32", seed=5,
                  model=dict(settings.model, encoder_weights=None))
    values.update(overrides)
    for key, value in values.items():
        setattr(settings, key, value)
    return settings


def export(slicer, root: Path):
    slicer.output_data_slices(root / "data", "data0")
    slicer.output_label_slices(root / "seg", "seg0")
    return root / "data", root / "seg"


@pytest.fixture(scope="module")
def slice_dirs(tmp_path_factory):
    """The same pair sliced to PNG directories by the JAX package (imageio)
    and by the port: {"jax": (data dir, seg dir), "ours": (...)}."""
    root = tmp_path_factory.mktemp("slices")
    data, labels = pair()
    return {"jax": export(JaxSlicer(data, labels, SLICER_SETTINGS), root / "jax"),
            "ours": export(TrainingDataSlicer(data, labels, SLICER_SETTINGS),
                           root / "ours")}


@pytest.mark.parametrize("label_kind", ["binary_255", "multilabel"])
def test_slicer_png_files_equal_jax(label_kind, tmp_path):
    data, labels = pair(label_kind)
    dirs = {name: export(cls(data, labels, SLICER_SETTINGS), tmp_path / name)
            for name, cls in (("jax", JaxSlicer), ("ours", TrainingDataSlicer))}
    for ours, ref in zip(dirs["ours"], dirs["jax"]):
        names = sorted(p.name for p in ours.iterdir())
        assert names == sorted(p.name for p in ref.iterdir())
        assert len(names) == sum(SHAPE)
        assert f"{ours.name}0_y_stack_19.png" in names
        for name in names:
            want = cv2.imread(str(ref / name), cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(cv2.imread(str(ours / name),
                                                     cv2.IMREAD_GRAYSCALE), want)
            # The JAX package's (imageio's) files through the port's reader.
            np.testing.assert_array_equal(read_grey(ref / name), want)
    seg = [read_grey(p) for p in dirs["ours"][1].iterdir()]
    assert max(s.max() for s in seg) == (3 if label_kind == "multilabel" else 1)


def test_clean_up_slices_deletes_what_it_wrote(tmp_path):
    data, labels = pair()
    slicer = TrainingDataSlicer(data, labels, SLICER_SETTINGS)
    data_dir, seg_dir = export(slicer, tmp_path)
    slicer.clean_up_slices()
    assert not data_dir.exists() and not seg_dir.exists()
    ref = JaxSlicer(data, labels, SLICER_SETTINGS)
    export(ref, tmp_path / "jax")
    ref.clean_up_slices()
    assert not (tmp_path / "jax" / "data").exists()


def test_dataset_equals_jax(slice_dirs):
    settings = SimpleNamespace(image_size=32)
    ours = get_2d_training_dataset(*slice_dirs["ours"], settings)
    ref = jax_training_dataset(*slice_dirs["jax"], settings)
    assert [p.name for p in ours.images_fps] == [p.name for p in ref.images_fps]
    assert [p.name for p in ours.masks_fps] == [p.name for p in ref.masks_fps]
    assert ours.images_fps[0].name == "data0_x_stack_0.png"  # natural sort
    assert VolSeg2dDataset.natsort("a_y_stack_10") == JaxDataset.natsort(
        "a_y_stack_10") == natsort("a_y_stack_10")
    images, masks = ours.stacked_arrays()
    ref_images, ref_masks = ref.stacked_arrays()
    assert images.shape == (sum(SHAPE), 32, 32) and images.dtype == np.uint8
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(masks, ref_masks)
    assert len(ours) == len(ref)
    for i in (0, 7, len(ref) - 1):
        (image, mask), (ref_image, ref_mask) = ours[i], ref[i]
        assert image.dtype == ref_image.dtype == np.float32
        assert image.shape == ref_image.shape == (1, 32, 32)
        np.testing.assert_array_equal(image, ref_image)
        np.testing.assert_array_equal(mask, ref_mask)


def test_mismatched_slice_counts_raise_as_jax(slice_dirs, tmp_path):
    data_dir, seg_dir = slice_dirs["ours"]
    short = tmp_path / "short"
    short.mkdir()
    for p in sorted(seg_dir.iterdir())[:-1]:
        (short / p.name).write_bytes(p.read_bytes())
    with pytest.raises(ValueError, match="slice counts differ") as ours:
        VolSeg2dDataset(data_dir, short)
    with pytest.raises(ValueError, match="slice counts differ") as ref:
        JaxDataset(data_dir, short)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("shape", [(3, 37, 45), (2, 64, 33), (2, 32, 64)])
def test_prediction_dataset_and_transforms_equal_jax(shape):
    vol = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    ours, ref = get_2d_prediction_dataset(vol), jax_prediction_dataset(vol)
    assert len(ours) == len(ref) == shape[0]
    for i in range(shape[0]):
        np.testing.assert_array_equal(ours[i], ref[i])
        assert ours[i].dtype == ref[i].dtype
    image = vol[0]
    h, w = augs.get_padded_dimension(shape[1]), augs.get_padded_dimension(shape[2])
    np.testing.assert_array_equal(augs.pad_image_to_dims(image, h + 3, w + 5),
                                  jax_augs.pad_image_to_dims(image, h + 3, w + 5))
    mask = (image > 100).astype(np.uint8)
    got = augs.get_postprocess_augs()(image=image, mask=mask)
    want = jax_augs.get_postprocess_augs()(image=image, mask=mask)
    for key in ("image", "mask"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    rgb = np.stack([image] * 3, axis=-1)
    np.testing.assert_array_equal(augs.ToChannelFirst()(image=rgb)["image"],
                                  jax_augs.ToChannelFirst()(image=rgb)["image"])


@pytest.mark.parametrize("batch", [2, 4])
def test_prediction_batcher_equals_jax(batch):
    vol = np.random.default_rng(2).random((7, 8, 9)).astype(np.float32)
    settings = SimpleNamespace(prediction_batch_size=batch)
    ours = get_2d_prediction_dataloader(vol, settings, device="cpu")
    assert ours.batch_size == batch
    # (The JAX factory rounds the batch up to its device count.)
    ref = JaxPredictionBatcher(vol, batch)
    assert len(ours) == len(ref) == -(-7 // batch)
    # The JAX batcher fills a short last batch with repeats of its last
    # slice; the port's last batch is short, and equals JAX's valid part.
    for (chunk, n), (ref_chunk, ref_n) in zip(ours, ref):
        assert n == ref_n == len(chunk)
        np.testing.assert_array_equal(chunk, ref_chunk[:ref_n])
    batches = list(PredictionBatcher(torch.from_numpy(vol), batch))
    assert [n for _, n in batches] == [n for _, n in ref]
    np.testing.assert_array_equal(torch.cat([c for c, _ in batches]).numpy(), vol)


def natsorted_lists(data, labels):
    """The slicer's in-memory slices in the PNG directories' order."""
    slicer = TrainingDataSlicer(data, labels, SLICER_SETTINGS)
    d, l = slicer.get_slice_arrays()
    names = [f"data0_{a}_stack_{i}.png" for a, n in zip("zyx", SHAPE)
             for i in range(n)]
    order = sorted(range(len(names)), key=lambda k: natsort(names[k]))
    return [d[k] for k in order], [l[k] for k in order]


def test_dataloaders_from_directories_equal_lists(slice_dirs):
    settings = train_settings()
    for path in (slice_dirs["ours"], tuple(str(p) for p in slice_dirs["jax"])):
        from_dirs = get_2d_training_dataloaders(*path, settings, device="cpu")
        from_lists = get_2d_training_dataloaders(*natsorted_lists(*pair()),
                                                 settings, device="cpu")
        for a, b in zip(from_dirs, from_lists):
            for attr in ("images", "masks", "indices", "batch_size"):
                np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    ref_images, _ = jax_training_dataset(*slice_dirs["jax"],
                                         settings).stacked_arrays()
    np.testing.assert_array_equal(from_dirs[0].images, ref_images)


def test_trainer_from_directories_trains_as_from_lists(slice_dirs):
    """Two seeded CPU steps, as the trainer takes them, from a trainer on
    the PNG directories and one on the same slices as lists: bit-equal
    losses."""
    settings = train_settings()
    trainers = [VolSeg2dTrainer(*slice_dirs["ours"], 2, settings, device="cpu"),
                VolSeg2dTrainer(*natsorted_lists(*pair()), 2, settings,
                                device="cpu")]
    losses = []
    for trainer in trainers:
        trainer._create_model_and_optimiser(1e-3, frozen=False)
        batches = iter(trainer.training_loader)
        losses.append([trainer._train_one_batch(
            *(torch.from_numpy(a) for a in next(batches)[:2]), 1e-3)
            for _ in range(2)])
    assert all(np.isfinite(losses[0]))
    assert losses[0] == losses[1]
