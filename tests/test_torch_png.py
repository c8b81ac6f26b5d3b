"""The port's PNG codec (`utils/png.py`) against OpenCV, Pillow and
imageio: the reader equals ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (the
JAX package's `VolSeg2dDataset` reader) on PNGs Pillow writes and on PNGs
built chunk by chunk (`tests/torch_png_builder.py`) with each row filter;
the writer's files read back exactly through cv2 and imageio; the
features this reader once refused read as cv2 reads them; an unknown
critical chunk raises NotImplementedError naming it."""

import struct

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from torch_png_builder import chunk, png_bytes
from volume_segmantics_tpu_torch.utils import png

SHAPE = (13, 17)


def rng(seed=0):
    return np.random.default_rng(seed)


def assert_reads_as_cv2(path):
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert ref is not None
    got = png.read_grey(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def pillow_image(mode):
    r = rng(1)
    if mode == "I;16":
        return Image.fromarray(r.integers(0, 65536, SHAPE, dtype=np.uint16))
    if mode in ("P", "P+tRNS"):
        im = Image.fromarray(r.integers(0, 256, (*SHAPE, 3), dtype=np.uint8))
        im = im.quantize(40)
        if mode == "P+tRNS":
            im.info["transparency"] = 3
        return im
    channels = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[mode]
    return Image.fromarray(r.integers(0, 256, (*SHAPE, *channels), dtype=np.uint8),
                           mode=mode)


@pytest.mark.parametrize("mode", ["L", "I;16", "LA", "RGB", "RGBA", "P", "P+tRNS"])
def test_reader_equals_cv2_on_pillow_pngs(mode, tmp_path):
    im = pillow_image(mode)
    kwargs = {"transparency": 3} if mode == "P+tRNS" else {}
    im.save(tmp_path / "a.png", **kwargs)
    assert_reads_as_cv2(tmp_path / "a.png")


CASES = {  # name: (colour, depth, channels, filters)
    **{f"grey8_filter{f}": (png.GREY, 8, 1, (f,)) for f in range(5)},
    "grey16_mixed": (png.GREY, 16, 1, (0, 1, 2, 3, 4)),
    "grey_alpha8_mixed": (png.GREY_ALPHA, 8, 2, (4, 3, 2, 1, 0)),
    "grey_alpha16_mixed": (png.GREY_ALPHA, 16, 2, (1, 4, 3)),
    "rgb8_mixed": (png.RGB, 8, 3, (3, 4, 1, 2, 0)),
    "rgba8_mixed": (png.RGBA, 8, 4, (2, 4, 1, 3)),
    "palette_mixed": (png.PALETTE, 8, 1, (1, 4, 3, 2)),
}


@pytest.mark.parametrize("name", CASES)
def test_reader_equals_cv2_for_every_filter_and_colour_type(name, tmp_path):
    colour, depth, channels, filters = CASES[name]
    r = rng(2)
    high = 2 ** depth if colour != png.PALETTE else 24
    pixels = r.integers(0, high, (*SHAPE, channels)).astype(
        np.uint16 if depth == 16 else np.uint8)
    pixels[3:6] = pixels[3, 0]  # runs, where the filters' zero residues show
    palette = r.integers(0, 256, (24, 3)) if colour == png.PALETTE else None
    path = tmp_path / f"{name}.png"
    path.write_bytes(png_bytes(pixels, colour, depth, filters, palette))
    assert_reads_as_cv2(path)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (7, 1), (31, 45), (4, 6, 3),
                                   (33, 20, 3)])
def test_writer_reads_back_through_cv2_and_imageio(shape, tmp_path):
    image = rng(3).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    png.write(path, image, text={"Title": "Predictions for m.pytorch"})
    flag = cv2.IMREAD_GRAYSCALE if image.ndim == 2 else cv2.IMREAD_COLOR
    back = cv2.imread(str(path), flag)
    np.testing.assert_array_equal(back if image.ndim == 2 else back[..., ::-1],
                                  image)
    np.testing.assert_array_equal(imageio.imread(path), image)
    assert Image.open(path).text == {"Title": "Predictions for m.pytorch"}
    if image.ndim == 2:
        np.testing.assert_array_equal(png.read_grey(path), image)


def test_writer_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.uint16), np.zeros((4, 4, 4), np.uint8),
                np.zeros(4, np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            png.write(tmp_path / "x.png", bad)


def test_refused_features_raise_by_name(tmp_path):
    data = png_bytes(np.zeros((*SHAPE, 1), np.uint8), png.GREY,
                     extra=[(b"ABCD", b"x")])
    (tmp_path / "r.png").write_bytes(data)
    with pytest.raises(NotImplementedError, match="critical chunk ABCD"):
        png.read_grey(tmp_path / "r.png")
    assert cv2.imread(str(tmp_path / "r.png"), cv2.IMREAD_GRAYSCALE) is None


@pytest.mark.parametrize("feature,build", [
    ("Adam7 interlacing", dict(interlace=1)),
    ("bit depths below 8", dict(depth=4)),
    ("16-bit colour", dict(colour=png.RGB, depth=16, channels=3)),
])
def test_formerly_refused_features_read_as_cv2(feature, build, tmp_path):
    """Each feature this reader refused before it read them as cv2 does
    (`tests/test_torch_png_depths.py` has every depth and colour type)."""
    colour, depth = build.get("colour", png.GREY), build.get("depth", 8)
    pixels = rng(4).integers(0, 2 ** depth, (*SHAPE, build.get("channels", 1)))
    (tmp_path / "f.png").write_bytes(png_bytes(
        pixels, colour, depth, (0, 1, 2, 3, 4), interlace=build.get("interlace", 0)))
    assert_reads_as_cv2(tmp_path / "f.png")


def test_corrupt_files_raise_value_error(tmp_path):
    good = png_bytes(np.zeros((*SHAPE, 1), np.uint8), png.GREY)
    cases = {
        "signature": b"GIF89a" + good[6:],
        "CRC": good[:29] + bytes([good[29] ^ 1]) + good[30:],
        "ends": good[:len(good) // 2],
        "image data": png_bytes(np.zeros((*SHAPE, 1), np.uint8), png.GREY).replace(
            struct.pack(">II", SHAPE[1], SHAPE[0]),
            struct.pack(">II", SHAPE[1], SHAPE[0] + 5), 1),
    }
    for what, data in cases.items():
        if what == "image data":  # IHDR claims more rows than IDAT holds
            data = data[:8] + chunk(b"IHDR", data[16:29]) + data[33:]
        (tmp_path / "c.png").write_bytes(data)
        with pytest.raises(ValueError):
            png.read_grey(tmp_path / "c.png")
