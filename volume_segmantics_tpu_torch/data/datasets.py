"""Slice datasets for training and prediction (port of the JAX package's
`data/datasets.py`, reference volume_segmantics/data/datasets.py:12-181).

A training dataset pairs the PNG slices of an image directory and a label
directory in natural-sort order; `stacked_arrays` reads every pair once
(`utils/png.py`, as ``cv2.imread(path, IMREAD_GRAYSCALE)`` reads them) and
preprocesses them into two contiguous (N, S, S) uint8 arrays, which the
trainer batches. Random augmentation and ImageNet normalisation run on the
device in the train step (`ops/augment.py`, `parallel/train.py`);
`__getitem__` keeps the reference's per-item pipeline.
"""

import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import volume_segmantics_tpu_torch.data.augmentations as augs
import volume_segmantics_tpu_torch.utils.config as cfg
from volume_segmantics_tpu_torch.utils.png import read_grey


def natsort(item):
    """Natural-sort key of a path: digit runs compare as numbers."""
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", str(item))]


def preprocess_slices(images, masks, preprocessing) -> tuple:
    """Run `preprocessing` over paired 2-D slices and stack the results
    into two uint8 arrays, in order. Slices of one shape go through the
    transforms as one stack (the port's transforms take stacks)."""
    if len(images) != len(masks):
        raise ValueError(f"{len(images)} image slices but {len(masks)} label "
                         "slices.")
    if not images:
        return np.empty((0, 0, 0), np.uint8), np.empty((0, 0, 0), np.uint8)
    by_shape = {}
    for i, img in enumerate(images):
        by_shape.setdefault(np.shape(img), []).append(i)
    out_images = out_masks = None
    for idx in by_shape.values():
        sample = preprocessing(image=np.stack([np.asarray(images[i]) for i in idx]),
                               mask=np.stack([np.asarray(masks[i]) for i in idx]))
        if out_images is None:
            out_images = np.empty((len(images), *sample["image"].shape[1:]),
                                  np.uint8)
            out_masks = np.empty((len(images), *sample["mask"].shape[1:]),
                                 np.uint8)
        out_images[idx] = sample["image"]
        out_masks[idx] = sample["mask"]
    return out_images, out_masks


class VolSeg2dDataset:
    """Pairs of image/mask PNG slices, natural-sorted, preprocessed to a
    common square size (reference datasets.py:12-87)."""

    imagenet_mean = cfg.IMAGENET_MEAN
    imagenet_std = cfg.IMAGENET_STD
    natsort = staticmethod(natsort)

    def __init__(self, images_dir, masks_dir, preprocessing=None,
                 augmentation=None, imagenet_norm=True, postprocessing=None):
        self.images_fps = sorted(Path(images_dir).glob("*.png"), key=natsort)
        self.masks_fps = sorted(Path(masks_dir).glob("*.png"), key=natsort)
        if len(self.images_fps) != len(self.masks_fps):
            # A silent zip-truncation here would train on mispaired slices.
            raise ValueError(
                f"Image/label slice counts differ: {len(self.images_fps)} "
                f"PNGs in {images_dir} vs {len(self.masks_fps)} in "
                f"{masks_dir}."
            )
        self.preprocessing = preprocessing
        self.augmentation = augmentation
        self.imagenet_norm = imagenet_norm
        self.postprocessing = postprocessing
        self._images = None
        self._masks = None

    def __len__(self):
        return len(self.images_fps)

    def __getitem__(self, i):
        """One (image, mask) pair through the reference's pipeline:
        preprocess -> augment -> normalise -> postprocess. The training
        path uses `stacked_arrays` instead."""
        image = read_grey(self.images_fps[i])
        mask = read_grey(self.masks_fps[i])
        if self.preprocessing:
            sample = self.preprocessing(image=image, mask=mask)
            image, mask = sample["image"], sample["mask"]
        if self.augmentation:
            sample = self.augmentation(image=image, mask=mask)
            image, mask = sample["image"], sample["mask"]
        if self.imagenet_norm:
            if np.issubdtype(image.dtype, np.integer):
                image = image.astype(np.float32) / 255
            image = (image - self.imagenet_mean) / self.imagenet_std
        if self.postprocessing:
            sample = self.postprocessing(image=image, mask=mask)
            image, mask = sample["image"], sample["mask"]
        return image, mask

    def stacked_arrays(self):
        """Every pair read and preprocessed once: (images, masks) as
        (N, S, S) uint8 arrays. Augmentation, normalisation and the
        postprocessing are left to the train step, on the device."""
        if self._images is None:
            # zlib releases the GIL: decode the files in a thread pool.
            with ThreadPoolExecutor() as pool:
                images = list(pool.map(read_grey, self.images_fps))
                masks = list(pool.map(read_grey, self.masks_fps))
            if self.preprocessing:
                self._images, self._masks = preprocess_slices(
                    images, masks, self.preprocessing)
            else:
                self._images = np.stack(images).astype(np.uint8)
                self._masks = np.stack(masks).astype(np.uint8)
        return self._images, self._masks


class VolSeg2dPredictionDataset:
    """Indexes z-slices of an in-memory volume, padded to the model-stride
    divisor (reference datasets.py:90-145)."""

    imagenet_mean = cfg.IMAGENET_MEAN
    imagenet_std = cfg.IMAGENET_STD

    def __init__(self, data_vol, preprocessing=None, imagenet_norm=True,
                 postprocessing=None):
        self.data_vol = data_vol
        self.preprocessing = preprocessing
        self.imagenet_norm = imagenet_norm
        self.postprocessing = postprocessing

    def __getitem__(self, i):
        image = self.data_vol[i]
        if self.preprocessing:
            image = self.preprocessing(image=image)["image"]
        if self.imagenet_norm:
            if np.issubdtype(image.dtype, np.integer):
                image = image.astype(np.float32) / 255
            image = (image - self.imagenet_mean) / self.imagenet_std
        if self.postprocessing:
            image = self.postprocessing(image=image)["image"]
        return image

    def __len__(self):
        return self.data_vol.shape[0]


def get_2d_training_dataset(image_dir: Path, label_dir: Path,
                            settings: SimpleNamespace) -> VolSeg2dDataset:
    """Training dataset factory (reference datasets.py:148-159). Random
    augmentation is the train step's, on the device."""
    return VolSeg2dDataset(
        image_dir, label_dir,
        preprocessing=augs.get_train_preprocess_augs(int(settings.image_size)),
        postprocessing=augs.get_postprocess_augs(),
    )


def get_2d_validation_dataset(image_dir: Path, label_dir: Path,
                              settings: SimpleNamespace) -> VolSeg2dDataset:
    """Validation dataset factory (reference datasets.py:162-172)."""
    return get_2d_training_dataset(image_dir, label_dir, settings)


def get_2d_prediction_dataset(data_vol: np.ndarray) -> VolSeg2dPredictionDataset:
    """Prediction dataset factory (reference datasets.py:175-181)."""
    y_dim, x_dim = data_vol.shape[1:]
    return VolSeg2dPredictionDataset(
        data_vol,
        preprocessing=augs.get_pred_preprocess_augs(y_dim, x_dim),
        postprocessing=augs.get_postprocess_augs(),
    )
