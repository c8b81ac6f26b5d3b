"""The port's TIFF reader (`utils/tiff.py`) against the JAX package's
`numpy_from_tiff` (``imageio.volread``, through imageio's own copy of
tifffile here) on multipage files Pillow writes (uncompressed, Deflate,
LZW; uint8, uint16, int32, float32) and on files built byte by byte by
`chip_smoke.write_tiff` (BigTIFF, tiles, big-endian, predictor 2, ImageJ
stacks, every sample type), each also against the array written; the LZW
codec both ways through libtiff (Pillow); the features this reader once
refused, now read as JAX reads them; and each refused feature by name."""

import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from volume_segmantics_tpu.utils.base_data_utils import (
    get_numpy_from_path as jax_get_numpy_from_path,
)
from volume_segmantics_tpu.utils.base_data_utils import (
    numpy_from_tiff as jax_numpy_from_tiff,
)
from torch_tiff_contract import assert_reads_as_jax
from volume_segmantics_tpu_torch.utils import base_data_utils, tiff

SHAPE = (3, 21, 30)


def volume(dtype, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        vol = rng.normal(0, 1e3, shape).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vol = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    vol[:, 5:9] = vol[0, 5, 0]  # runs, for LZW's long strings
    return vol


@pytest.mark.parametrize("compression", [None, "tiff_deflate", "tiff_lzw"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32", "float32"])
def test_pillow_multipage_equals_jax(compression, dtype, tmp_path):
    vol = volume(dtype)
    pages = [Image.fromarray(p) for p in vol]
    kwargs = {} if compression is None else {"compression": compression}
    path = tmp_path / "v.tif"
    pages[0].save(path, save_all=True, append_images=pages[1:], **kwargs)
    ref = jax_numpy_from_tiff(path)
    np.testing.assert_array_equal(ref, vol)
    got = tiff.read(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


BUILT = {  # name: (dtype, write_tiff options)
    "bigtiff_deflate": ("uint8", dict(bigtiff=True, compression="deflate")),
    "bigtiff_raw_u16": ("uint16", dict(bigtiff=True)),
    "tiles_lzw": ("uint8", dict(tile=(16, 16), compression="lzw")),
    "tiles_predictor2_u16": ("uint16", dict(tile=(16, 32), compression="deflate",
                                            predictor=2)),
    "big_endian_i16": ("int16", dict(byteorder=">")),
    "big_endian_lzw_u16": ("uint16", dict(byteorder=">", compression="lzw")),
    "predictor2_lzw_u8": ("uint8", dict(compression="lzw", predictor=2)),
    "predictor2_deflate_i32": ("int32", dict(compression="deflate", predictor=2,
                                             rows_per_strip=4)),
    "strips_of_5_f64": ("float64", dict(rows_per_strip=5, compression="deflate")),
    "u32": ("uint32", dict(compression="lzw")),
    "u64_big_endian": ("uint64", dict(byteorder=">")),
    "i64": ("int64", dict(bigtiff=True, compression="deflate")),
    "imagej_stack_u8": ("uint8", dict(imagej=True)),
    "imagej_stack_f32_big_endian": ("float32", dict(imagej=True, byteorder=">")),
}


@pytest.mark.parametrize("name", BUILT)
def test_built_files_read_back_exactly(name, tmp_path):
    dtype, options = BUILT[name]
    vol = volume(dtype, seed=1)
    path = tmp_path / "b.tif"
    chip_smoke.write_tiff(path, vol, **options)
    got = tiff.read(path)
    assert got.dtype == vol.dtype.newbyteorder("=") and got.shape == vol.shape
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, jax_numpy_from_tiff(path))


@pytest.mark.parametrize("suffix", [".tif", ".tiff"])
def test_get_numpy_from_path_dispatches_tiff_as_jax(suffix, tmp_path):
    vol = volume("uint8", seed=2)
    path = tmp_path / f"v{suffix}"
    chip_smoke.write_tiff(path, vol, compression="deflate")
    got, chunking = base_data_utils.get_numpy_from_path(path)
    ref, ref_chunking = jax_get_numpy_from_path(path)
    np.testing.assert_array_equal(got, ref)
    assert chunking == ref_chunking is True


@pytest.mark.parametrize("data", ["constant", "noise", "ramp", "empty", "one"])
def test_lzw_round_trip_and_libtiff(data, tmp_path):
    rng = np.random.default_rng(3)
    raw = {"constant": bytes(70000), "empty": b"", "one": b"\x07",
           "noise": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
           "ramp": bytes(np.arange(70000) % 251 // 3)}[data]
    np.testing.assert_array_equal(
        tiff.lzw_decode(chip_smoke.lzw_encode(raw)), np.frombuffer(raw, np.uint8))
    if len(raw) >= 700:  # the same bytes through libtiff (Pillow) both ways
        page = np.frombuffer(raw[:700 * (len(raw) // 700)], np.uint8).reshape(-1, 700)
        # Two pages: a single 2-D page is no volume (JAX reads it as 2-D).
        Image.fromarray(page).save(tmp_path / "p.tif", compression="tiff_lzw",
                                   save_all=True,
                                   append_images=[Image.fromarray(page)])
        np.testing.assert_array_equal(tiff.read(tmp_path / "p.tif")[0], page)
        chip_smoke.write_tiff(tmp_path / "o.tif", page[None], compression="lzw")
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.tif")), page)


def ifd_offsets(data: bytes):
    """Offsets of each IFD of a little-endian classic TIFF."""
    out, at = [], struct.unpack_from("<I", data, 4)[0]
    while at:
        out.append(at)
        count = struct.unpack_from("<H", data, at)[0]
        at = struct.unpack_from("<I", data, at + 2 + 12 * count)[0]
    return out


def second_page_taller(path):
    """Give the file's second page one row fewer than its first."""
    data = bytearray(path.read_bytes())
    at = ifd_offsets(data)[1]
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        if struct.unpack_from("<H", data, entry)[0] == 257:
            struct.pack_into("<I", data, entry + 8, SHAPE[1] - 1)
    path.write_bytes(bytes(data))


REFUSED = {  # feature named: (dtype, write_tiff options, file edit)
    "JPEG compression": ("uint8", dict(extra_tags={259: (3, [7])}), None),
    "CCITT Group 4 compression": ("uint8", dict(extra_tags={259: (3, [4])}), None),
    "predictor 3 on samples that are not floating point": (
        "uint16", dict(extra_tags={317: (3, [3])}), None),
    "pixels of 3 samples": ("uint8", dict(extra_tags={277: (3, [3])}), None),
    "12-bit samples": ("uint16", dict(extra_tags={258: (3, [12])}), None),
    "SampleFormat 6": ("uint8", dict(extra_tags={339: (3, [6])}), None),
    "volume tiles": ("uint8", dict(extra_tags={32997: (4, [2])}), None),
}


@pytest.mark.parametrize("feature", REFUSED)
def test_refused_features_raise_by_name(feature, tmp_path):
    dtype, options, edit = REFUSED[feature]
    path = tmp_path / "r.tif"
    chip_smoke.write_tiff(path, volume(dtype, seed=4), **options)
    if edit is not None:
        edit(path)
    assert_reads_as_jax(path, feature)


FORMERLY_REFUSED = {  # feature: (dtype, write_tiff options, file edit)
    "PackBits compression": ("uint8", dict(compression="packbits"), None),
    "predictor 3": ("float32", dict(compression="deflate", predictor=3), None),
    "predictor 2 on floating-point": ("float32", dict(predictor=2), None),
    "reduced-resolution pages": ("uint8", dict(extra_tags={254: (4, [1])}), None),
    "fill order 2": ("uint8", dict(fill_order=2), None),
    "photometric interpretation 0": ("uint8", dict(extra_tags={262: (3, [0])}), None),
    "ImageJ hyperstacks": ("uint8", dict(imagej=True, extra_tags={
        270: (2, b"ImageJ=1.54f\nimages=3\nchannels=3\n")}), None),
    "pages that differ in shape or type": ("uint8", dict(), second_page_taller),
}


@pytest.mark.parametrize("feature", FORMERLY_REFUSED)
def test_formerly_refused_features_read_as_jax(feature, tmp_path):
    """Each feature this reader refused before it read them as the JAX
    package does; a page of another shape starts a series of its own."""
    dtype, options, edit = FORMERLY_REFUSED[feature]
    path = tmp_path / "r.tif"
    chip_smoke.write_tiff(path, volume(dtype, seed=4), **options)
    if edit is not None:
        edit(path)
    assert_reads_as_jax(path)


def halve_last_strip_count(path):
    """Halve the byte count of the last page's first strip."""
    data = bytearray(path.read_bytes())
    at = ifd_offsets(data)[-1]
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        if struct.unpack_from("<H", data, entry)[0] == 279:
            where = struct.unpack_from("<I", data, entry + 8)[0]
            count = struct.unpack_from("<I", data, where)[0]
            struct.pack_into("<I", data, where, count // 2)
    path.write_bytes(bytes(data))


def test_not_tiff_and_truncated_files_raise_value_error(tmp_path):
    path = tmp_path / "t.tif"
    for data in (b"", b"GIF89a-not-a-tiff", b"II\x2b\x00\x04\x00\x00\x00",
                 b"II\x2a\x00\x08\x00\x00\x00\x05\x00"):
        path.write_bytes(data)
        with pytest.raises(ValueError):
            tiff.read(path)
    for compression in (None, "deflate", "lzw"):
        chip_smoke.write_tiff(path, volume("uint8", seed=5),
                              compression=compression, rows_per_strip=7)
        halve_last_strip_count(path)
        with pytest.raises(ValueError):
            tiff.read(path)
