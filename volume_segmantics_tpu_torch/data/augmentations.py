"""Host-side shape normalisation of training slices (resize, pad).

Port of the JAX package's `data/augmentations.py` without OpenCV, equal to
it at every pixel. The resize copies OpenCV's integer arithmetic for uint8
images (`cv2.resize`): INTER_LINEAR with 11-bit fixed-point weights, an
exact integer horizontal pass and the vertical pass of OpenCV's vector
code, or, where both sides shrink exactly 2x, the 2x2 mean OpenCV switches
to; masks INTER_NEAREST with floor indexing. It runs once per run, on a
stack of same-shaped slices at a time. Padding is numpy's `reflect` mode,
which is OpenCV's BORDER_REFLECT_101 (edge pixel not repeated), applied
repeatedly where a pad exceeds the slice. The prediction transforms pad
each slice to the stride divisor and put its channel first. The random
training augmentations run on the device (`ops/augment.py`).

Transforms follow the albumentations calling convention:
``sample = t(image=..., mask=...)`` returning a dict; the image and mask
may be single slices (H, W) or stacks of them (N, H, W).
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


COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _linear_taps(src: int, dst: int):
    """OpenCV's source index and float32 fraction of each output pixel:
    fx = (dx + 0.5) * scale - 0.5, scale = 1 / (dst / src)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), f - s


def _fixed_point(f):
    """The two 11-bit weights (1 - f, f), rounded half to even as OpenCV's
    saturate_cast<short> rounds them."""
    return (np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int32),
            np.rint(f * np.float32(COEF_SCALE)).astype(np.int32))


def resize_linear_u8(images: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """`cv2.resize(im, (new_w, new_h), interpolation=cv2.INTER_LINEAR)` of
    each (H, W) uint8 slice of an (N, H, W) stack, equal at every pixel."""
    _, h, w = images.shape
    if h == 2 * new_h and w == 2 * new_w:
        # OpenCV resizes exactly-2x shrinks as INTER_AREA: the 2x2 mean.
        s = images.astype(np.uint16)
        total = s[:, 0::2, 0::2] + s[:, 0::2, 1::2] + s[:, 1::2, 0::2] + s[:, 1::2, 1::2]
        return ((total + 2) >> 2).astype(np.uint8)
    # Horizontal pass: exact integers. At either edge the source column is
    # clamped and its weight is the whole COEF_SCALE.
    sx, fx = _linear_taps(w, new_w)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _fixed_point(fx)
    src = images.astype(np.int32)
    rows = src[..., sx] * a0 + src[..., np.minimum(sx + 1, w - 1)] * a1
    # Vertical pass: rows are clamped but their weights are not; each row
    # is shifted right by 4, multiplied by its weight keeping the high 16
    # bits, and the sum rounded off its last 2 bits (OpenCV's
    # VResizeLinearVec_32s8u, which cv2 runs on every column).
    sy, fy = _linear_taps(h, new_h)
    b0, b1 = _fixed_point(fy)
    top = rows[:, np.clip(sy, 0, h - 1)] >> 4
    bottom = rows[:, np.clip(sy + 1, 0, h - 1)] >> 4
    out = ((top * b0[:, None]) >> 16) + ((bottom * b1[:, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize_nearest(masks: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """`cv2.resize(m, (new_w, new_h), interpolation=cv2.INTER_NEAREST)` of
    each slice of an (N, H, W) stack: source index floor(d * src / dst)."""
    _, h, w = masks.shape

    def index(src, dst):
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))), src - 1
                          ).astype(np.int64)

    return masks[:, index(h, new_h)][:, :, index(w, new_w)]


class LongestMaxSize:
    """Rescale so the longest side equals `max_size` (both up and down),
    images bilinear / masks nearest, as OpenCV does it
    (albumentations LongestMaxSize)."""

    def __init__(self, max_size: int):
        self.max_size = max_size

    def __call__(self, image=None, mask=None):
        h, w = image.shape[-2:]
        scale = self.max_size / max(h, w)
        out = {"image": image, "mask": mask}
        if scale != 1.0:
            new_h, new_w = int(round(h * scale)), int(round(w * scale))
            if new_h < 1 or new_w < 1:
                raise ValueError(f"LongestMaxSize: a {h}x{w} slice would "
                                 f"resize to {new_h}x{new_w}.")
            if image.dtype != np.uint8:
                raise ValueError(f"LongestMaxSize resizes uint8 images only, "
                                 f"got {image.dtype}.")
            stack = image.reshape(-1, h, w)
            out["image"] = resize_linear_u8(stack, new_h, new_w).reshape(
                *image.shape[:-2], new_h, new_w)
            if mask is not None:
                out["mask"] = resize_nearest(mask.reshape(-1, h, w), new_h,
                                             new_w).reshape(*mask.shape[:-2],
                                                            new_h, new_w)
        if mask is None:
            out.pop("mask")
        return out


class PadIfNeeded:
    """Centre-pad up to (min_height, min_width) with reflect-101 borders
    (albumentations PadIfNeeded defaults)."""

    def __init__(self, min_height: int, min_width: int):
        self.min_height = min_height
        self.min_width = min_width

    def _pads(self, shape):
        pad_h = max(self.min_height - shape[-2], 0)
        pad_w = max(self.min_width - shape[-1], 0)
        top = pad_h // 2
        left = pad_w // 2
        return ((0, 0),) * (len(shape) - 2) + ((top, pad_h - top),
                                               (left, pad_w - left))

    def __call__(self, image=None, mask=None):
        pads = self._pads(image.shape)
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


def get_pred_preprocess_augs(img_size_y: int, img_size_x: int) -> Compose:
    """Pad prediction slices up to multiples of the stride divisor
    (reference augmentations.py:46-65)."""
    padded_y_dim = get_padded_dimension(img_size_y)
    padded_x_dim = get_padded_dimension(img_size_x)
    return Compose([PadIfNeeded(min_height=padded_y_dim, min_width=padded_x_dim)])


def pad_image_to_dims(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Centre reflect-101 pad of an image up to (out_h, out_w)."""
    return PadIfNeeded(out_h, out_w)(image=image)["image"]


class ToChannelFirst:
    """Postprocess: HW(C) numpy -> CHW float32 array (the counterpart of
    the reference's ToTensorV2, augmentations.py:104-110)."""

    def __call__(self, image=None, mask=None):
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[None, ...]
        else:
            img = np.moveaxis(img, -1, 0)
        out = {"image": np.ascontiguousarray(img, dtype=np.float32)}
        if mask is not None:
            out["mask"] = np.asarray(mask)
        return out


def get_postprocess_augs() -> Compose:
    """Final transform applied to each sample (reference
    augmentations.py:104-110)."""
    return Compose([ToChannelFirst()])
