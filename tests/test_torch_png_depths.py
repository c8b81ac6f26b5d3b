"""The port's PNG reader against ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
(the JAX package's slice reader), bit for bit, beyond 8-bit progressive
files: Adam7 interlacing (each pass filtered on its own, every image
size against the pass grid), grey and palette samples of 1, 2 and 4 bits,
and 16-bit RGB and RGBA, where libpng's rgb_to_gray runs on the 16-bit
samples before strip_16 keeps the high byte. Files are built chunk by
chunk (`tests/torch_png_builder.py`) or written by Pillow."""

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_png_builder import png_bytes
from volume_segmantics_tpu_torch.utils import png

COMBINATIONS = [  # (colour type, bit depth, channels)
    (png.GREY, 1, 1), (png.GREY, 2, 1), (png.GREY, 4, 1), (png.GREY, 8, 1),
    (png.GREY, 16, 1), (png.PALETTE, 1, 1), (png.PALETTE, 2, 1),
    (png.PALETTE, 4, 1), (png.PALETTE, 8, 1), (png.RGB, 8, 3), (png.RGB, 16, 3),
    (png.RGBA, 8, 4), (png.RGBA, 16, 4), (png.GREY_ALPHA, 8, 2),
    (png.GREY_ALPHA, 16, 2),
]
SHAPES = [(13, 17), (1, 1), (3, 2), (9, 9), (33, 20)]


def assert_reads_as_cv2(path):
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert ref is not None
    got = png.read_grey(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return ref


def image(colour, depth, channels, shape, seed):
    rng = np.random.default_rng(seed)
    high = min(2 ** depth, 24) if colour == png.PALETTE else 2 ** depth
    pixels = rng.integers(0, high, (*shape, channels))
    pixels[shape[0] // 2:, :shape[1] // 2] = pixels[0, 0]  # a flat patch
    palette = rng.integers(0, 256, (24, 3)) if colour == png.PALETTE else None
    return pixels, palette


@pytest.mark.parametrize("interlace", [0, 1], ids=["progressive", "adam7"])
@pytest.mark.parametrize("colour,depth,channels", COMBINATIONS,
                         ids=[f"c{c}_{d}bit" for c, d, _ in COMBINATIONS])
def test_reader_equals_cv2_at_every_depth(colour, depth, channels, interlace,
                                          tmp_path):
    for i, shape in enumerate(SHAPES):
        pixels, palette = image(colour, depth, channels, shape, seed=i)
        path = tmp_path / f"{i}.png"
        path.write_bytes(png_bytes(pixels, colour, depth, (0, 1, 2, 3, 4),
                                   palette, interlace))
        assert_reads_as_cv2(path)


@pytest.mark.parametrize("side", range(1, 10))
def test_adam7_at_every_size_against_the_pass_grid(side, tmp_path):
    """Images of 1 to 9 pixels a side leave passes empty (no bytes, not
    even filter bytes) in every pattern; each pass has its own filters."""
    for width in (side, 2 * side + 1):
        pixels, _ = image(png.GREY, 8, 1, (side, width), seed=side)
        path = tmp_path / f"{width}.png"
        path.write_bytes(png_bytes(pixels, png.GREY, 8, (4, 1, 3, 0, 2),
                                   interlace=1))
        np.testing.assert_array_equal(assert_reads_as_cv2(path), pixels[..., 0])


def test_16_bit_colour_is_grey_before_strip_16(tmp_path):
    """libpng turns 16-bit RGB into 16-bit grey (rounded), then keeps the
    high byte; stripping first and converting 8-bit samples differs."""
    pixels, _ = image(png.RGB, 16, 3, (40, 50), seed=7)
    path = tmp_path / "rgb16.png"
    path.write_bytes(png_bytes(pixels, png.RGB, 16))
    ref = assert_reads_as_cv2(path)
    strip_first = png._to_grey((pixels >> 8).astype(np.uint8))
    assert not np.array_equal(strip_first, ref)


@pytest.mark.parametrize("mode,bits", [("1", None), ("P", 1), ("P", 2), ("P", 4),
                                       ("L", 4)])
def test_reader_equals_cv2_on_pillow_sub_byte_pngs(mode, bits, tmp_path):
    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (21, 19), dtype=np.uint8)
    im = Image.fromarray(grey)
    if mode == "1":
        im = im.convert("1")
    elif mode == "P":
        im = im.quantize(2 ** bits)
    save = {} if bits is None else {"bits": bits}
    im.save(tmp_path / "p.png", **save)
    assert_reads_as_cv2(tmp_path / "p.png")
