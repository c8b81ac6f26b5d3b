"""Host-side shape normalisation of training slices (resize, pad).

Port of the JAX package's `data/augmentations.py` without OpenCV: padding
is numpy's `reflect` mode, which is OpenCV's BORDER_REFLECT_101 (edge pixel
not repeated), applied repeatedly where a pad exceeds the slice. The random
training augmentations run on the device (`ops/augment.py`).

Transforms follow the albumentations calling convention:
``sample = t(image=..., mask=...)`` returning a dict.
"""

import math

import numpy as np

import volume_segmantics_tpu_torch.utils.config as cfg


class Compose:
    """Minimal albumentations-style compose over dict-transforms."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, **sample):
        for t in self.transforms:
            sample = t(**sample)
        return sample


class LongestMaxSize:
    """Rescale so the longest side equals `max_size`. Only the identity
    scale is supported: an OpenCV-exact bilinear resize is not ported yet,
    so any other scale raises."""

    def __init__(self, max_size: int):
        self.max_size = max_size

    def __call__(self, image=None, mask=None):
        h, w = image.shape[:2]
        if max(h, w) != self.max_size:
            raise NotImplementedError(
                f"LongestMaxSize: resizing a {h}x{w} slice to longest side "
                f"{self.max_size} is not supported by the PyTorch port; "
                f"slice the volume so its longest side equals image_size."
            )
        out = {"image": image}
        if mask is not None:
            out["mask"] = mask
        return out


class PadIfNeeded:
    """Centre-pad up to (min_height, min_width) with reflect-101 borders
    (albumentations PadIfNeeded defaults)."""

    def __init__(self, min_height: int, min_width: int):
        self.min_height = min_height
        self.min_width = min_width

    def _pads(self, h, w):
        pad_h = max(self.min_height - h, 0)
        pad_w = max(self.min_width - w, 0)
        top = pad_h // 2
        left = pad_w // 2
        return ((top, pad_h - top), (left, pad_w - left))

    def __call__(self, image=None, mask=None):
        pads = self._pads(*image.shape[:2])
        out = {"image": np.pad(image, pads, mode="reflect")}
        if mask is not None:
            out["mask"] = np.pad(mask, pads, mode="reflect")
        return out


def get_train_preprocess_augs(img_size: int) -> Compose:
    """Pad/resize images to the square training size
    (reference augmentations.py:12-27)."""
    return Compose(
        [
            LongestMaxSize(max_size=img_size),
            PadIfNeeded(min_height=img_size, min_width=img_size),
        ]
    )


def get_padded_dimension(dimension: int) -> int:
    """Round a dimension up to the model-stride divisor
    (reference augmentations.py:30-43)."""
    image_divisor = cfg.IM_SIZE_DIVISOR
    if dimension % image_divisor == 0:
        return dimension
    return (math.floor(dimension / image_divisor) + 1) * image_divisor
