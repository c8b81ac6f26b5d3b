"""The port's TIFF codecs and page types against the JAX package's
`numpy_from_tiff` (imageio's tifffile copy): PackBits, LZMA, the
floating-point predictor (3) and the horizontal one (2) on floating-point
samples, fill order 2, 1, 2 and 4-bit samples, photometric 0 (MinIsWhite)
and 3 (palette) as raw samples, in strips and tiles, both byte orders,
with files from `chip_smoke.write_tiff` and Pillow (libtiff); the refusals
of what JAX cannot read (12-bit samples, CCITT, JPEG, predictor 3 on
integers or in tiles); each codec function against tifffile's own; and
1-bit and predictor-3 volumes through both packages' data managers."""

from types import SimpleNamespace

import numpy as np
import pytest
from imageio.plugins import _tifffile as tifffile
from PIL import Image

import chip_smoke
from torch_tiff_contract import assert_reads_as_jax
from volume_segmantics_tpu.data.base_data_manager import (
    BaseDataManager as JaxBaseDataManager,
)
from volume_segmantics_tpu.data.slicers import TrainingDataSlicer as JaxSlicer
from volume_segmantics_tpu.utils.base_data_utils import (
    get_numpy_from_path as jax_get_numpy_from_path,
)
from volume_segmantics_tpu_torch.data import TrainingDataSlicer
from volume_segmantics_tpu_torch.data.base_data_manager import BaseDataManager
from volume_segmantics_tpu_torch.utils import base_data_utils, tiff_codecs

SHAPE = (3, 21, 30)


def volume(dtype, shape=SHAPE, seed=0, bits=None):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if bits is not None:
        vol = rng.integers(0, 1 << bits, shape).astype(dtype)
    elif dtype.kind == "f":
        vol = rng.normal(0, 1e3, shape).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vol = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    vol[:, 5:9] = vol[0, 5, 0]  # runs, for PackBits' repeats
    return vol


def built(dtype, bits=None, shape=SHAPE, **options):
    vol = volume(dtype, shape, bits=bits)

    def build(path):
        chip_smoke.write_tiff(path, vol, bits=bits, **options)
        return vol
    return build


def pillow(mode, **save):
    vol = volume("uint8", seed=1)

    def build(path):
        if mode == "1":
            pages = [Image.fromarray(p > 127).convert("1") for p in vol]
            vol_written = vol > 127
        elif mode == "I;16":
            vol_written = vol.astype(np.uint16) * 257
            pages = [Image.fromarray(p) for p in vol_written]
        elif mode == "P":
            pages = [Image.fromarray(p).convert("P") for p in vol]
            vol_written = vol
        else:
            pages = [Image.fromarray(p) for p in vol]
            vol_written = vol
        pages[0].save(path, save_all=True, append_images=pages[1:], **save)
        return vol_written if mode != "P" else None
    return build


PALETTE = {320: (3, list(range(3 * 16)))}

CASES = {  # name: (builder, feature refused or None, whether JAX returns the array written)
    # PackBits.
    "packbits_u8": (built("uint8", compression="packbits"), None, True),
    "packbits_u16_big_endian": (built("uint16", compression="packbits",
                                      byteorder=">"), None, True),
    "packbits_f32_tiles": (built("float32", compression="packbits",
                                 tile=(16, 16)), None, True),
    "packbits_pillow_u8": (pillow("L", compression="packbits"), None, True),
    "packbits_pillow_u16": (pillow("I;16", compression="packbits"), None, True),
    # LZMA.
    "lzma_u8": (built("uint8", compression="lzma"), None, True),
    "lzma_i16_big_endian": (built("int16", compression="lzma", byteorder=">"),
                            None, True),
    "lzma_f32_tiles": (built("float32", compression="lzma", tile=(16, 16)),
                       None, True),
    # Predictor 3 (floating point).
    "predictor3_f32_deflate": (built("float32", compression="deflate",
                                     predictor=3), None, True),
    "predictor3_f32_deflate_big_endian": (built(
        "float32", compression="deflate", predictor=3, byteorder=">"), None, True),
    "predictor3_f64_lzw_strips_of_4": (built(
        "float64", compression="lzw", predictor=3, rows_per_strip=4), None, True),
    "predictor3_f16_deflate": (built("float16", compression="deflate",
                                     predictor=3), None, True),
    "predictor3_f32_packbits": (built("float32", compression="packbits",
                                      predictor=3), None, True),
    "predictor3_f32_uncompressed": (built("float32", predictor=3), None, True),
    # tifffile swaps a contiguous big-endian page to native order before
    # it undoes the predictor: not the array written, but what JAX reads.
    "predictor3_f32_uncompressed_big_endian": (built(
        "float32", predictor=3, byteorder=">"), None, False),
    "predictor3_f32_tiles_spanning_the_rows": (built(
        "float32", shape=(3, 32, 32), predictor=3, tile=(16, 32)), None, True),
    "predictor3_f32_tiles_spanning_the_rows_big_endian": (built(
        "float32", shape=(3, 32, 32), predictor=3, tile=(16, 32), byteorder=">"),
        None, False),
    "predictor3_f32_tiles": (built("float32", predictor=3, tile=(16, 16),
                                   compression="deflate"), "predictor 3 in tiles",
                             None),
    "predictor3_on_integers": (built("uint16", compression="deflate",
                                     extra_tags={317: (3, [3])}),
                               "predictor 3 on samples that are not floating",
                               None),
    # Predictor 2 on floating-point samples: tifffile's cumulative sum.
    "predictor2_f32_deflate": (built("float32", compression="deflate",
                                     predictor=2), None, False),
    "predictor2_f64_tiles_big_endian": (built(
        "float64", compression="deflate", predictor=2, tile=(16, 16),
        byteorder=">"), None, False),
    # Fill order 2.
    "fill_order2_u8": (built("uint8", fill_order=2), None, True),
    "fill_order2_u16_lzw_big_endian": (built(
        "uint16", fill_order=2, compression="lzw", byteorder=">"), None, True),
    "fill_order2_u8_deflate_tiles": (built(
        "uint8", fill_order=2, compression="deflate", tile=(16, 16)), None, True),
    "fill_order2_4bit": (built("uint8", bits=4, fill_order=2), None, True),
    # Sub-byte samples.
    "bits1": (built("bool", bits=1), None, True),
    "bits1_packbits_strips_of_5": (built("bool", bits=1, compression="packbits",
                                         rows_per_strip=5), None, True),
    "bits1_tiles": (built("bool", bits=1, tile=(16, 16)), None, True),
    "bits1_pillow": (pillow("1"), None, True),
    "bits1_pillow_packbits": (pillow("1", compression="packbits"), None, True),
    "bits1_pillow_ccitt_group4": (pillow("1", compression="group4"),
                                  "CCITT Group 4", None),
    "bits2": (built("uint8", bits=2), None, True),
    "bits2_lzma_big_endian": (built("uint8", bits=2, compression="lzma",
                                    byteorder=">"), None, True),
    "bits4_deflate": (built("uint8", bits=4, compression="deflate"), None, True),
    "bits4_palette": (built("uint8", bits=4, extra_tags={262: (3, [3]), **PALETTE}),
                      None, True),
    "bits12": (built("uint16", extra_tags={258: (3, [12])}), "12-bit samples", None),
    # Photometric interpretations: raw samples.
    "photometric0_min_is_white": (built("uint8", extra_tags={262: (3, [0])}),
                                  None, True),
    "photometric3_palette_u8": (built("uint8", extra_tags={
        262: (3, [3]), 320: (3, list(range(3 * 256)))}), None, True),
    "photometric3_palette_pillow": (pillow("P"), None, None),
    # Compressions JAX cannot decode here.
    "jpeg_pillow": (pillow("L", compression="jpeg"), "JPEG compression", None),
}


@pytest.mark.parametrize("name", CASES)
def test_codecs_and_page_types_read_as_jax(name, tmp_path):
    build, refused, returns_written = CASES[name]
    path = tmp_path / f"{name}.tif"
    written = build(path)
    assert_reads_as_jax(path, refused, written if returns_written else None)


def packbits_streams():
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    runs = bytes(np.repeat(rng.integers(0, 256, 60, dtype=np.uint8),
                           rng.integers(1, 300, 60)))
    return {
        "empty": b"", "noise": noise, "runs": runs, "mixed": runs + noise + runs,
        "literal_cut_short": bytes([5, 1, 2]),
        "repeat_without_its_byte": bytes([1, 7, 8, 0xFE]),
        "no_op_headers": bytes([128, 0, 9, 128, 0xFD, 3]),
    }


@pytest.mark.parametrize("name", packbits_streams())
def test_packbits_decode_equals_tifffile(name):
    stream = packbits_streams()[name]
    np.testing.assert_array_equal(
        tiff_codecs.packbits_decode(stream),
        np.frombuffer(tifffile.decode_packbits(stream), np.uint8))
    if name in ("noise", "runs", "mixed", "empty"):  # raw data round trip
        np.testing.assert_array_equal(
            tiff_codecs.packbits_decode(chip_smoke.packbits_encode(stream)),
            np.frombuffer(stream, np.uint8))


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
@pytest.mark.parametrize("samples", [1, 3])
def test_float_predictor_equals_tifffile(dtype, samples):
    """`undo_float_predictor` on a block of interleaved samples against
    tifffile's `decode_floats`, and the writer's encoder inverted."""
    rng = np.random.default_rng(3)
    rows, cols = 5, 7
    raw = rng.integers(0, 256, rows * cols * samples * np.dtype(dtype).itemsize,
                       dtype=np.uint8)
    ref = tifffile.decode_floats(raw.copy().view(dtype).reshape(1, rows, cols, samples))
    got = tiff_codecs.undo_float_predictor(raw, rows, cols, samples, np.dtype(dtype))
    np.testing.assert_array_equal(got.view(f"u{np.dtype(dtype).itemsize}"),
                                  ref.reshape(rows, -1).view(got.view(
                                      f"u{np.dtype(dtype).itemsize}").dtype))
    values = rng.normal(0, 1e3, (rows, cols)).astype(dtype)
    encoded = chip_smoke.float_predictor_encode(values).ravel()
    np.testing.assert_array_equal(
        tiff_codecs.undo_float_predictor(encoded, rows, cols, 1, np.dtype(dtype)),
        values)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("cols", [1, 7, 8, 13])
def test_unpack_bits_equals_tifffile(bits, cols):
    rng = np.random.default_rng(bits * cols)
    rows = 4
    raw = rng.integers(0, 256, rows * ((cols * bits + 7) // 8), dtype=np.uint8)
    ref = tifffile.unpack_ints(raw.tobytes(), "?" if bits == 1 else "B", bits, cols)
    got = tiff_codecs.unpack_bits(raw, rows, cols, bits)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.ravel(), ref[:rows * cols])


def test_bit_reversal_table_equals_tifffile():
    assert tiff_codecs.REVERSED_BITS == tifffile.TIFF.REVERSE_BITORDER_BYTES


def manager_settings(clip_data):
    return SimpleNamespace(st_dev_factor=2.575, downsample=False,
                           clip_data=clip_data, data_hdf5_path="/data",
                           seg_hdf5_path="/seg", training_axes="All")


def outcome(make):
    """What a constructor gives: its object, or the type of its error."""
    try:
        return make()
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e)


DOWNSTREAM = {  # name: (data file options, labels file options)
    "bool_pair": (dict(dtype="bool", bits=1), dict(dtype="bool", bits=1)),
    "predictor3_f32_data_u8_labels": (
        dict(dtype="float32", compression="deflate", predictor=3),
        dict(dtype="uint8", bits=None)),
    "predictor3_f32_data_bool_labels": (
        dict(dtype="float32", compression="deflate", predictor=3),
        dict(dtype="bool", bits=1)),
}


@pytest.mark.parametrize("clip_data", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("name", DOWNSTREAM)
def test_bool_and_float_tiffs_through_both_packages(name, clip_data, tmp_path):
    """`get_numpy_from_path`, the training slicer and the prediction
    side's data manager on 1-bit and predictor-3 files: equal results in
    both packages, or the same exception type."""
    rng = np.random.default_rng(6)
    vol = rng.normal(100, 30, (6, 24, 20))
    paths = []
    for kind, options in zip(("data", "labels"), DOWNSTREAM[name]):
        options = dict(options)
        dtype = np.dtype(options.pop("dtype"))
        array = (vol > 100) if dtype == bool else vol.astype(dtype) if kind == "data" \
            else (vol > 110).astype(dtype)
        paths.append(tmp_path / f"{kind}.tif")
        chip_smoke.write_tiff(paths[-1], array, **options)
    for path in paths:
        got, ref = base_data_utils.get_numpy_from_path(path), \
            jax_get_numpy_from_path(path)
        assert got[0].dtype == ref[0].dtype and got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])
    settings = manager_settings(clip_data)
    ours = outcome(lambda: TrainingDataSlicer(*paths, settings))
    ref = outcome(lambda: JaxSlicer(*paths, settings))
    if isinstance(ref, type):
        assert ours is ref
    else:
        assert ours.codes == ref.codes and ours.num_seg_classes == ref.num_seg_classes
        assert ours.seg_vol.dtype == ref.seg_vol.dtype
        np.testing.assert_array_equal(ours.data_vol, ref.data_vol)
        got, want = outcome(ours.get_slice_arrays), outcome(ref.get_slice_arrays)
        if isinstance(want, type):
            assert got is want
        else:
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    ours = outcome(lambda: BaseDataManager(paths[0], settings))
    ref = outcome(lambda: JaxBaseDataManager(paths[0], settings))
    if isinstance(ref, type):
        assert ours is ref
    else:
        assert ours.data_vol.dtype == ref.data_vol.dtype
        np.testing.assert_array_equal(ours.data_vol, ref.data_vol)


def test_float32_vessels_preprocess_as_their_uint8_copy(tmp_path):
    """The volume that chip_smoke's formats phase predicts on as a
    predictor-3 float32 file, here at 64^3: with the shipped
    `clip_data: True` both packages turn the float32 copy into the same
    uint8 volume as the uint8 one, so its labels must be the uint8 run's."""
    vol, _ = chip_smoke.make_vessel_volume((64, 64, 64), seed=7)
    path = tmp_path / "vessels_f32.tif"
    chip_smoke.write_tiff(path, vol.astype(np.float32), compression="deflate",
                          predictor=3)
    settings = manager_settings(True)
    preprocessed = []
    for manager in (BaseDataManager, JaxBaseDataManager):
        from_u8 = manager(vol.copy(), settings).data_vol
        from_f32 = manager(path, settings).data_vol
        assert from_u8.dtype == from_f32.dtype == np.uint8
        np.testing.assert_array_equal(from_f32, from_u8)
        preprocessed.append(from_f32)
    np.testing.assert_array_equal(*preprocessed)
