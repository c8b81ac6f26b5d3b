"""The PyTorch port's `LongestMaxSize` (OpenCV's integer arithmetic in
numpy) against the JAX package's, which calls cv2: equal at every pixel,
images and masks, one slice or a stack; and the training preprocessing of
slice lists of mixed shapes equal to the JAX package's."""

import numpy as np
import pytest

from volume_segmantics_tpu.data.augmentations import LongestMaxSize as JaxLongestMaxSize
from volume_segmantics_tpu.data.dataloaders import (
    _preprocess_slice_lists as jax_preprocess_slice_lists,
)
from volume_segmantics_tpu_torch.data.augmentations import LongestMaxSize
from volume_segmantics_tpu_torch.data.dataloaders import _preprocess_slice_lists

# (height, width, max_size): up, down, exactly 2x (OpenCV's 2x2-mean
# case), near 2x, odd sides, one pixel thin, one side unchanged.
CASES = [
    (40, 48, 256), (97, 31, 256), (17, 3, 32), (1, 300, 256), (300, 1, 256),
    (300, 280, 256), (288, 320, 256), (80, 320, 256), (1024, 768, 256),
    (512, 512, 256), (64, 32, 32), (512, 301, 256), (301, 512, 256),
    (511, 513, 256), (513, 255, 256), (257, 255, 256), (255, 255, 256),
    (256, 100, 256), (3, 5, 64), (1, 2, 32), (40, 50, 50),
]


@pytest.mark.parametrize("h,w,size", CASES, ids=lambda v: str(v))
def test_longest_max_size_equals_cv2_at_every_pixel(h, w, size):
    rng = np.random.default_rng(h * 1000 + w)
    images = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    images[1] = np.linspace(0, 255, h * w).reshape(h, w).astype(np.uint8)
    masks = rng.integers(0, 4, (3, h, w), dtype=np.uint8)
    ours = LongestMaxSize(size)(image=images, mask=masks)
    for i in range(3):
        ref = JaxLongestMaxSize(size)(image=images[i], mask=masks[i])
        np.testing.assert_array_equal(ours["image"][i], ref["image"])
        np.testing.assert_array_equal(ours["mask"][i], ref["mask"])
        assert ours["image"].dtype == ref["image"].dtype == np.uint8
    single = LongestMaxSize(size)(image=images[0])
    assert set(single) == {"image"}
    np.testing.assert_array_equal(single["image"], ours["image"][0])


def test_identity_scale_passes_through_and_bad_inputs_raise():
    img = np.zeros((16, 64), np.uint8)
    assert LongestMaxSize(64)(image=img, mask=img)["image"] is img
    with pytest.raises(ValueError, match="uint8"):
        LongestMaxSize(32)(image=img.astype(np.float32))
    with pytest.raises(ValueError, match="resize to"):
        LongestMaxSize(32)(image=np.zeros((1, 200), np.uint8))


def test_slice_lists_of_mixed_shapes_preprocess_as_in_jax():
    rng = np.random.default_rng(0)
    shapes = [(40, 48), (40, 48), (12, 48), (12, 40), (40, 48), (12, 40)]
    data = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    labels = [rng.integers(0, 2, s, dtype=np.uint8) for s in shapes]
    settings = type("S", (), {"image_size": 32})()
    ours = _preprocess_slice_lists(data, labels, 32)
    ref = jax_preprocess_slice_lists(data, labels, settings)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == (6, 32, 32)
