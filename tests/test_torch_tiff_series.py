"""The port's TIFF reader picks the file's first series as the JAX package's
`numpy_from_tiff` (imageio's tifffile copy) does: tifffile's two-array
files (fault F7: a second `save` made the port stack both arrays),
stacks with thumbnails before, after or between their pages, reduced-
resolution pages of the stack's shape, shaped descriptions (JSON and the
old ``shape=``), ImageJ stacks of frames, slices and channels, OME-XML,
several samples per pixel (planar and interleaved), and the refusals of
every first series that is not 3-D and of the formats tifffile reads by
rules of their own. Each case builds its file with imageio's bundled
`TiffWriter` or `chip_smoke.write_tiff` and holds the port to
`tests/torch_tiff_contract.py`."""

import json

import numpy as np
import pytest
from imageio.plugins._tifffile import TiffWriter

import chip_smoke
from torch_tiff_contract import assert_reads_as_jax
from volume_segmantics_tpu_torch.utils import tiff

RNG = np.random.default_rng(18)
A = RNG.integers(0, 256, (5, 20, 30), dtype=np.uint8)
B = RNG.integers(0, 256, (6, 20, 30), dtype=np.uint8)
SMALL = RNG.integers(0, 256, (4, 8, 8), dtype=np.uint8)


def tifffile_saves(*saves, **writer):
    """A file of one `TiffWriter.save` per (array, options)."""
    def build(path):
        with TiffWriter(str(path), **writer) as w:
            for array, options in saves:
                w.save(array, **options)
    return build


def built(pages, **options):
    def build(path):
        chip_smoke.write_tiff(path, pages, **options)
    return build


def shaped(array) -> bytes:
    return json.dumps({"shape": list(array.shape)}).encode()


def imagej(**fields) -> bytes:
    return ("ImageJ=1.54f\n" + "".join(f"{k}={v}\n" for k, v in fields.items())).encode()


def ome(order, sizes, tiff_data="") -> bytes:
    attributes = " ".join(f'Size{k}="{v}"' for k, v in sizes.items())
    return ('<?xml version="1.0" encoding="UTF-8"?><OME xmlns="http://www.'
            'openmicroscopy.org/Schemas/OME/2016-06" UUID="urn:uuid:1"><Image '
            f'ID="Image:0"><Pixels ID="Pixels:0" DimensionOrder="{order}" '
            f'Type="uint8" {attributes}><Channel ID="Channel:0:0" '
            f'SamplesPerPixel="1"/>{tiff_data}</Pixels></Image></OME>').encode()


def interleaved(stack, thumbs):
    return [p for z in range(len(stack)) for p in (stack[z], thumbs[z])]


RGB = RNG.integers(0, 256, (3, 20, 30, 3), dtype=np.uint8)
ZYX = dict(X=30, Y=20, C=1, T=1)

CASES = {  # name: (builder, feature refused or None, array JAX returns)
    # F7: two arrays saved one after the other are two series.
    "f7_two_saves": (tifffile_saves((A, {}), (B, {})), None, A),
    "f7_two_saves_deflate": (tifffile_saves((A, dict(compress=6)),
                                            (B, dict(compress=6))), None, A),
    "f7_two_saves_bigtiff": (tifffile_saves((A, {}), (B, {}), bigtiff=True),
                             None, A),
    "f7_two_saves_big_endian_u16": (tifffile_saves(
        (A.astype(">u2"), {}), (B, {}), byteorder=">"), None, A.astype(np.uint16)),
    "f7_second_series_of_other_pages": (tifffile_saves((A, {}), (SMALL, {})),
                                        None, A),
    # Generic series: pages grouped by shape, in order of first appearance.
    "thumbnail_after_stack": (tifffile_saves(
        (A[:3], {}), (np.zeros((10, 10), np.uint8), {})), None, A[:3]),
    "thumbnails_interleaved": (built(interleaved(A, A[:, ::2, ::2].copy()),
                                     compression="deflate"), None, A),
    "thumbnails_interleaved_lzw_tiles": (built(
        interleaved(A, A[:, ::4, ::4].copy()), compression="lzw", tile=(16, 16)),
        None, A),
    "thumbnail_first_is_one_2d_page": (built([A[0, :10, :10].copy(), *A]),
                                       "single 2-D pages", None),
    "reduced_resolution_pages_of_the_stack_shape": (built(
        A, extra_tags={254: (4, [1])}), None, A),
    "mask_pages_of_the_stack_shape": (built(A, extra_tags={254: (4, [4])}),
                                      None, A),
    # tifffile's key leaves the type out: pages of another type but the
    # same shape join the stack, cast to its first page's type.
    "pages_of_another_type_join_the_stack": (built(
        [*A[:3], *A[3:].astype(np.uint16)]), None, A),
    "single_2d_page": (tifffile_saves((A[0], {})), "single 2-D pages", None),
    # Shaped descriptions: each keyframe starts a series.
    "shaped_second_series": (built([*A, *SMALL], descriptions={
        0: shaped(A), 5: shaped(SMALL)}), None, A),
    "shaped_old_style": (built([*A, *B], descriptions={
        0: b"shape=(5,20,30)", 5: b"shape=(6,20,30)"}), None, A),
    "shaped_then_plain_pages_read_generic": (built([*A, *B], descriptions={
        0: shaped(A)}), None, np.concatenate([A, B])),
    "shaped_4d": (built(A[:4], descriptions={0: b'{"shape": [2, 2, 20, 30]}'}),
                  "series of 4 axes", None),
    "shaped_with_axes": (built(A, descriptions={
        0: b'{"shape": [5, 20, 30], "axes": "ZYX"}'}), None, A),
    # ImageJ.
    "imagej_frames_one_ifd": (built(A[:3], imagej=True, descriptions={
        0: imagej(images=3, frames=3)}), None, A[:3]),
    "imagej_frames_pages": (built(A[:3], descriptions={
        0: imagej(images=3, frames=3)}), None, A[:3]),
    "imagej_slices_deflate": (built(A, compression="deflate", descriptions={
        0: imagej(images=5, slices=5)}), None, A),
    "imagej_channels": (built(A[:3], imagej=True, descriptions={
        0: imagej(images=3, channels=3)}), None, A[:3]),
    "imagej_images_beyond_the_pages": (built(A[:3], descriptions={
        0: imagej(images=5)}), None, A[:3]),
    "imagej_tifffile_writer": (tifffile_saves((A[:3], {}), imagej=True),
                               None, A[:3]),
    "imagej_hyperstack_channels_and_slices": (built(A[:4], imagej=True, descriptions={
        0: imagej(images=4, channels=2, slices=2, hyperstack="true")}),
        "series of 4 axes", None),
    "imagej_hyperstack_pages": (built(A[:4], descriptions={
        0: imagej(images=4, channels=2, slices=2)}), "series of 4 axes", None),
    "imagej_one_frame_of_slices": (built(A[:3], descriptions={
        0: imagej(images=3, slices=3, frames=1)}), "series of 4 axes", None),
    # OME-XML.
    "ome_z_plane_count": (built(A[:3], descriptions={0: ome("XYZCT", dict(
        ZYX, Z=3), '<TiffData IFD="0" PlaneCount="3"/>')}), None, A[:3]),
    "ome_every_plane": (built(A[:3], descriptions={0: ome("XYZCT", dict(
        ZYX, Z=3), "<TiffData/>")}), None, A[:3]),
    "ome_time": (built(A[:4], descriptions={0: ome("XYCZT", dict(
        ZYX, Z=1, T=4), '<TiffData IFD="0" NumPlanes="4"/>')}), None, A[:4]),
    "ome_without_tiff_data_read_generic": (built(A[:3], descriptions={
        0: ome("XYZCT", dict(ZYX, Z=3))}), None, A[:3]),
    "ome_4d": (built(A[:4], descriptions={0: ome("XYZCT", dict(
        ZYX, Z=2, C=2), "<TiffData/>")}), "series of 4 axes", None),
    # Several samples per pixel.
    "planar_three_slices": (tifffile_saves((A[:3], {})), None, A[:3]),
    "planar_four_slices": (tifffile_saves((A[:4], {})), None, A[:4]),
    "rgb_one_page": (tifffile_saves((A[:3].transpose(1, 2, 0).copy(),
                                     dict(photometric="rgb"))),
                     None, A[:3].transpose(1, 2, 0)),
    "rgb_stack": (tifffile_saves((RGB, dict(photometric="rgb"))),
                  "pixels of 3 samples", None),
    # Formats tifffile reads by rules of their own.
    "zeiss_lsm": (built(A[:3], extra_tags={34412: (1, list(range(8)))}),
                  "Zeiss LSM", None),
    "nih_image": (built(A[:3], extra_tags={43314: (1, list(range(8)))}),
                  "NIH Image", None),
}


@pytest.mark.parametrize("name", CASES)
def test_first_series_reads_as_jax(name, tmp_path):
    build, refused, written = CASES[name]
    path = tmp_path / f"{name}.tif"
    build(path)
    assert_reads_as_jax(path, refused, written)


@pytest.mark.parametrize("tag,feature", [(34362, "FluoView"), (33445, "GEL")])
def test_other_series_formats_are_refused_by_name(tag, feature, tmp_path):
    """FluoView and MD Gel pages: tifffile reads these by their own
    metadata, which the tag alone does not make readable to it either."""
    path = tmp_path / "f.tif"
    chip_smoke.write_tiff(path, A[:3], extra_tags={tag: (1, list(range(8)))})
    with pytest.raises(NotImplementedError, match=feature):
        tiff.read(path)
