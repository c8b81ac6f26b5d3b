"""Writes the HDF5 fixtures of tests/data/torch_hdf5/ with h5py, for the
machine that has no h5py: `chip_smoke.py`'s interchange and virtual phases
read them there and hold each against its array, rebuilt by
`chip_smoke.fixture_arrays()`; `tests/test_torch_hdf5_fixtures.py` holds
them against h5py's reading here. `chip_smoke.FIXTURE_READS` lists the
files and what each holds, `chip_smoke.FIXTURE_OTHERS` the rest.

    python tests/torch_hdf5_fixtures.py

The committed files were written with h5py 3.14.0 on HDF5 1.14.6 (szip
through its libaec). Rewriting the older files changes their bytes (their
object headers hold times): write only the new ones, as

    python tests/torch_hdf5_fixtures.py write_option_fixtures

does for the files of `write_option_fixtures`. Those use what h5py does
not offer through its own API: offsets and lengths of other sizes
(`H5Pset_sizes`, which h5py's low level has) and unfiltered partial edge
chunks (`H5Pset_chunk_opts`, called through `ctypes` on the libhdf5 that
h5py loads, here and in the tests only).
"""

import ctypes
import glob
import itertools
import os
import sys
from pathlib import Path

import h5py
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

NEXUS_PATH = chip_smoke.NEXUS_DATA


def write_fixtures(folder: Path) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    arrays = chip_smoke.fixture_arrays()
    vol, labels, crop = arrays["vessels"], arrays["labels"], arrays["crop"]

    # The volume in a superblock 3 file: one unlimited axis (an extensible
    # array), shuffle + gzip + Fletcher-32.
    with h5py.File(folder / "vessels_latest.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=vol, chunks=(8, 48, 48),
                         maxshape=(None, 96, 96), shuffle=True,
                         compression="gzip", fletcher32=True)
    # The NeXus file: track-ordered groups; final_result_tomo holds 13
    # links (dense: a fractal heap behind B-trees of names and creation
    # order), its data an external link into the file above.
    with h5py.File(folder / "vessels.nxs", "w", track_order=True) as f:
        entry = f.create_group("entry", track_order=True)
        entry.attrs["NX_class"] = "NXentry"
        entry["title"] = np.bytes_("synthetic vessels")
        tomo = entry.create_group("final_result_tomo", track_order=True)
        tomo.attrs["NX_class"] = "NXdata"
        tomo.attrs["signal"] = "data"
        for axis, size in zip("zyx", vol.shape):
            tomo[axis] = np.arange(size, dtype="<f4") * 0.5
        for i in range(9):
            tomo[f"parameter_{i}"] = np.float64(i)
        tomo["data"] = h5py.ExternalLink("vessels_latest.h5", "/data")
    # The labels in a fixed array (superblock 3, gzip).
    with h5py.File(folder / "vessels_labels.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=labels, chunks=(8, 48, 48),
                         compression="gzip")

    # One small file for each other chunk index and variant.
    with h5py.File(folder / "single_chunk.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop, chunks=crop.shape,
                         compression="gzip", fletcher32=True)
    with h5py.File(folder / "implicit.h5", "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((5, 10, 10))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(f.id, b"data", h5py.h5t.STD_U8LE,
                        h5py.h5s.create_simple(crop.shape), dcpl=dcpl)
        f["data"][...] = crop
    with h5py.File(folder / "fixed_array_paged.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop, chunks=(1, 1, 6))  # 1,152 chunks
    with h5py.File(folder / "btree2.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop, chunks=(5, 10, 10),
                         maxshape=(None, None, 24), compression="gzip")
    with h5py.File(folder / "contiguous_latest.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop)
    with h5py.File(folder / "superblock_2.h5", "w", libver=("v108", "latest")) as f:
        f.create_dataset("data", data=crop, chunks=(5, 10, 10), compression="gzip")
    with h5py.File(folder / "user_block.h5", "w", userblock_size=512) as f:
        f.create_dataset("data", data=crop, chunks=True, compression="gzip")
    with h5py.File(folder / "soft_link.nxs", "w") as f:
        f.create_dataset("raw/data", data=crop, chunks=True, compression="gzip")
        f[NEXUS_PATH] = h5py.SoftLink("/raw/data")


def write_virtual_fixtures(folder: Path) -> None:
    """The filters beyond zlib's, external raw storage and virtual
    datasets, each file holding one array of `chip_smoke.fixture_arrays()`.
    Virtual datasets name their sources relatively: the library finds them
    beside the virtual dataset's file."""
    arrays = chip_smoke.fixture_arrays()
    crop, crop_u2 = arrays["crop"], arrays["crop_u2"]

    with h5py.File(folder / "crop_lzf.h5", "w") as f:
        f.create_dataset("data", data=crop_u2, chunks=(6, 12, 12),
                         compression="lzf", shuffle=True, fletcher32=True)
    with h5py.File(folder / "crop_scaleoffset_int.h5", "w") as f:
        f.create_dataset("data", data=crop_u2, chunks=(5, 10, 10), scaleoffset=0)
    with h5py.File(folder / "crop_scaleoffset_float.h5", "w") as f:
        f.create_dataset("data", data=arrays["crop_quarters"], chunks=(5, 10, 10),
                         scaleoffset=2)
    with h5py.File(folder / "crop_nbit.h5", "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((6, 12, 12))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        ds = h5py.h5d.create(f.id, b"data", h5py.h5t.STD_U8LE,
                             h5py.h5s.create_simple(crop.shape), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, crop)
    # External raw data: two segments of one file, the second at an offset;
    # its name is relative (h5py finds it in the working directory, or under
    # $HDF5_EXTFILE_PREFIX).
    raw = crop.tobytes()
    cut, gap = 2000, 96
    (folder / "crop_external.raw").write_bytes(raw[:cut] + bytes(gap) + raw[cut:])
    with h5py.File(folder / "crop_external.h5", "w") as f:
        f.create_dataset("data", shape=crop.shape, dtype=crop.dtype, external=[
            ("crop_external.raw", 0, cut),
            ("crop_external.raw", cut + gap, len(raw) - cut)])
    # Four quadrants: from this file ("."), from a sibling file, from a
    # missing file (the fill value) and from a virtual dataset in this file
    # over another sibling.
    with h5py.File(folder / "crop_virtual.h5", "w") as f:
        f.create_dataset("local", data=crop, chunks=(6, 12, 12),
                         compression="gzip")
        inner = h5py.VirtualLayout(shape=crop.shape, dtype="u1")
        inner[...] = h5py.VirtualSource("crop_nbit.h5", "data", shape=crop.shape)
        f.create_virtual_dataset("inner", inner)
        layout = h5py.VirtualLayout(shape=(12, 48, 48), dtype="<u2")
        layout[:, :24, :24] = h5py.VirtualSource(".", "local", shape=crop.shape)
        layout[:, :24, 24:] = h5py.VirtualSource("crop_lzf.h5", "data",
                                                 shape=crop.shape)
        layout[:, 24:, :24] = h5py.VirtualSource("missing.h5", "data",
                                                 shape=crop.shape)
        layout[:, 24:, 24:] = h5py.VirtualSource(".", "inner", shape=crop.shape)
        f.create_virtual_dataset("data", layout, fillvalue=chip_smoke.VIRTUAL_FILL)

    # The LZF tile and the two virtual datasets that tile it.
    tile, side = arrays["tile"], chip_smoke.TILE_SIDE
    with h5py.File(folder / "tile_lzf.h5", "w") as f:
        f.create_dataset("data", data=tile, chunks=tile.shape, compression="lzf")
    for copies in chip_smoke.TILE_COPIES:
        n = side * copies
        layout = h5py.VirtualLayout(shape=(n, n, n), dtype="u1")
        source = h5py.VirtualSource("tile_lzf.h5", "data", shape=tile.shape)
        for z, y, x in itertools.product(range(0, n, side), repeat=3):
            layout[z:z + side, y:y + side, x:x + side] = source
        with h5py.File(folder / f"tile_{n}.h5", "w") as f:
            f.create_virtual_dataset("data", layout)

    # The training pair: a NeXus volume stitched from an LZF half (uint8)
    # and an integer scale-offset half (uint16) under a uint16 virtual
    # dataset; the labels in integer scale-offset behind gzip.
    top, bottom = arrays["stitched_top"], arrays["stitched_bottom"]
    with h5py.File(folder / "stitched_lzf.h5", "w") as f:
        f.create_dataset("data", data=top, chunks=(8, 48, 48), compression="lzf")
    with h5py.File(folder / "stitched_scaleoffset.h5", "w") as f:
        f.create_dataset("data", data=bottom, chunks=(8, 48, 48), scaleoffset=0)
    stitched = arrays["stitched"]
    layout = h5py.VirtualLayout(shape=stitched.shape, dtype="<u2")
    half = len(top)
    layout[:half] = h5py.VirtualSource("stitched_lzf.h5", "data", shape=top.shape,
                                       dtype="u1")
    layout[half:] = h5py.VirtualSource("stitched_scaleoffset.h5", "data",
                                       shape=bottom.shape)
    with h5py.File(folder / "stitched.nxs", "w") as f:
        entry = f.create_group("entry")
        entry.attrs["NX_class"] = "NXentry"
        tomo = entry.create_group("final_result_tomo")
        tomo.attrs["NX_class"] = "NXdata"
        tomo.attrs["signal"] = "data"
        tomo.create_virtual_dataset("data", layout)
    with h5py.File(folder / "stitched_labels.h5", "w") as f:
        f.create_dataset("data", data=arrays["stitched_labels"], chunks=(8, 48, 48),
                         scaleoffset=0, compression="gzip")


def write_szip_fixtures(folder: Path) -> None:
    """szip (libaec) chunks under the nearest-neighbour preprocessor: the
    crop as bytes, as big-endian uint16 on a scanline that is not whole
    blocks, and in float32 quarters after shuffle with Fletcher-32; the
    vessels volume, and its labels under entropy coding alone (which the
    crop's values do not shrink under), a pair that `model-train-2d` and
    `model-predict-2d` read."""
    arrays = chip_smoke.fixture_arrays()
    for name, array, chunks, dtype, options, extra in (
            ("crop_szip.h5", "crop", (3, 24, 24), "u1", ("nn", 8), {}),
            ("crop_szip_u2.h5", "crop_u2", (6, 12, 20), ">u2", ("nn", 16), {}),
            ("crop_szip_float.h5", "crop_quarters", (5, 10, 10), "<f4",
             ("nn", 32), dict(shuffle=True, fletcher32=True)),
            ("vessels_szip.h5", "vessels", (8, 48, 48), "u1", ("nn", 16), {}),
            ("vessels_labels_szip.h5", "labels", (8, 48, 48), "u1", ("ec", 8),
             {})):
        with h5py.File(folder / name, "w") as f:
            f.create_dataset("data", data=arrays[array].astype(dtype),
                             chunks=chunks, compression="szip",
                             compression_opts=options, **extra)


def write_type_fixtures(folder: Path) -> None:
    """Types h5py writes beyond the plain ones: the crop as uint16 under a
    committed (named) datatype, at libver earliest and latest; as 12-bit
    uint16 from bit 2, unfiltered, and from bit 0 under the n-bit filter;
    less 128 as 11-bit int16 from bit 3 under n-bit and gzip; and a
    virtual int8 dataset over the uint8 crop (its values saturate at
    127)."""
    arrays = chip_smoke.fixture_arrays()
    for name, libver in (("crop_committed.h5", "earliest"),
                         ("crop_committed_latest.h5", "latest")):
        with h5py.File(folder / name, "w", libver=libver) as f:
            f["voxel"] = np.dtype("<u2")
            f.create_dataset("data", data=arrays["crop_u2"], dtype=f["voxel"],
                             chunks=(6, 12, 12), compression="gzip")
    for name, array, base, precision, offset, chunks, nbit in (
            ("crop_reduced.h5", "crop_u2", h5py.h5t.STD_U16LE, 12, 2, None,
             False),
            ("crop_nbit_12.h5", "crop_u2", h5py.h5t.STD_U16LE, 12, 0,
             (6, 12, 12), True),
            ("crop_nbit_signed.h5", "crop_signed", h5py.h5t.STD_I16LE, 11, 3,
             (5, 10, 10), True)):
        datatype = base.copy()
        datatype.set_precision(precision)
        datatype.set_offset(offset)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        if chunks:
            dcpl.set_chunk(chunks)
        if nbit:
            dcpl.set_filter(h5py.h5z.FILTER_NBIT)
            if array == "crop_signed":
                dcpl.set_deflate(4)
        with h5py.File(folder / name, "w") as f:
            ds = h5py.h5d.create(f.id, b"data", datatype,
                                 h5py.h5s.create_simple(arrays[array].shape),
                                 dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, arrays[array])
    crop = arrays["crop"]
    layout = h5py.VirtualLayout(shape=crop.shape, dtype="i1")
    layout[...] = h5py.VirtualSource("crop_nbit.h5", "data", shape=crop.shape)
    with h5py.File(folder / "crop_saturated.h5", "w") as f:
        f.create_virtual_dataset("data", layout)


def write_sourceless_fixtures(folder: Path) -> None:
    """The two virtual datasets committed without their sources: a %b
    mapping of Z blocks of (BLOCK_DEPTH, 256, 256) uint8, each block's
    source file named with its number, stored with no block; and an
    unlimited mapping of a (z, 24, 24) uint16 source, stored at z = 12."""
    side = 256
    block = (chip_smoke.BLOCK_DEPTH, side, side)
    with h5py.File(folder / chip_smoke.BLOCKS_VDS, "w", libver="latest") as f:
        vspace = h5py.h5s.create_simple((0, side, side),
                                        (h5py.h5s.UNLIMITED, side, side))
        vspace.select_hyperslab((0, 0, 0), (h5py.h5s.UNLIMITED, 1, 1),
                                stride=(block[0], 1, 1), block=block)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_virtual(vspace, chip_smoke.BLOCK_SOURCE.encode(), b"/data",
                         h5py.h5s.create_simple(block))
        h5py.h5d.create(f.id, b"data", h5py.h5t.STD_U8LE, vspace, dcpl=dcpl)
    source = h5py.VirtualSource(chip_smoke.GROWING_SOURCE, "data",
                                shape=(12, 24, 24), maxshape=(None, 24, 24))
    layout = h5py.VirtualLayout(shape=(12, 24, 24), maxshape=(None, 24, 24),
                                dtype="<u2")
    layout[0:h5py.h5s.UNLIMITED] = source[0:h5py.h5s.UNLIMITED]
    with h5py.File(folder / chip_smoke.GROWING_VDS, "w", libver="latest") as f:
        f.create_virtual_dataset("data", layout, fillvalue=chip_smoke.VIRTUAL_FILL)


DONT_FILTER_PARTIAL_CHUNKS = 0x2  # H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS


def set_dont_filter_partial_chunks(dcpl) -> None:
    """Chunk option flag 1 on a dataset creation property list: the
    library then stores partial edge chunks unfiltered. h5py has no call
    for it; this calls the libhdf5 h5py loads (its wheel's own copy)."""
    folder = os.path.dirname(h5py.__file__) + ".libs"
    lib = ctypes.CDLL(glob.glob(os.path.join(folder, "libhdf5-*.so*"))[0])
    set_chunk_opts = lib.H5Pset_chunk_opts  # (hid_t plist, unsigned opts)
    set_chunk_opts.argtypes = [ctypes.c_int64, ctypes.c_uint]
    set_chunk_opts.restype = ctypes.c_int  # herr_t
    if set_chunk_opts(dcpl.id, DONT_FILTER_PARTIAL_CHUNKS) < 0:
        raise RuntimeError("H5Pset_chunk_opts failed")


def sized_file(path: Path, sizes, libver: str) -> h5py.File:
    """A new h5py File whose offsets and lengths are of `sizes` bytes."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(*sizes)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    if libver == "latest":
        fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC,
                                     fcpl=fcpl, fapl=fapl))


def edge_dataset(f: h5py.File, array: np.ndarray, chunks, maxshape=None,
                 fletcher32=False) -> None:
    """`array` at /data of `f`, shuffled and deflated, partial edge chunks
    stored unfiltered."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    dcpl.set_shuffle()
    dcpl.set_deflate(6)
    if fletcher32:
        dcpl.set_fletcher32()
    set_dont_filter_partial_chunks(dcpl)
    maxshape = tuple(h5py.h5s.UNLIMITED if m is None else m
                     for m in (maxshape or array.shape))
    ds = h5py.h5d.create(f.id, b"data", h5py.h5t.py_create(array.dtype),
                         h5py.h5s.create_simple(array.shape, maxshape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(array))


def write_option_fixtures(folder: Path) -> None:
    """What the library writes beyond h5py's defaults: the vessels labels
    as h5py's bool; the crop as a big-endian int16 enumeration with gaps
    between its values; the crop in files of offsets and lengths of (4, 4),
    (8, 4), (4, 8) and (2, 2) bytes, at superblock 0 and 3; the vessels
    volume at (4, 4) with unfiltered partial edge chunks (10 x 20 x 20
    chunks divide neither 48 nor 96: 61 of its 125 chunks are partial and
    stored raw, 461 KB); and the crop with them under a fixed array, an
    extensible array and a version 2 B-tree."""
    arrays = chip_smoke.fixture_arrays()
    crop, enum = arrays["crop"], arrays["crop_enum"]
    with h5py.File(folder / "labels_bool.h5", "w") as f:
        f.create_dataset("data", data=arrays["labels_bool"], chunks=True,
                         compression="gzip")
    members = {f"V{v}": int(v) for v in np.unique(enum)}
    with h5py.File(folder / "crop_enum.h5", "w") as f:
        f.create_dataset("data", data=enum.astype(">i2"), chunks=(5, 10, 10),
                         compression="gzip",
                         dtype=h5py.enum_dtype(members, basetype=">i2"))
    for name, sizes, libver in chip_smoke.SIZED_FIXTURES:
        with sized_file(folder / name, sizes, libver) as f:
            f.create_dataset("data", data=crop, chunks=(5, 10, 10), shuffle=True,
                             compression="gzip")
    with sized_file(folder / "vessels_sizes_44_edges.h5", (4, 4), "earliest") as f:
        edge_dataset(f, arrays["vessels"], (10, 20, 20))
    for name, maxshape in (("crop_edges_fixed.h5", None),
                           ("crop_edges_extensible.h5", (None, 24, 24)),
                           ("crop_edges_btree2.h5", (None, None, 24))):
        with h5py.File(folder / name, "w", libver="latest") as f:
            edge_dataset(f, crop, (5, 10, 10), maxshape, fletcher32=True)


if __name__ == "__main__":
    writers = (write_fixtures, write_virtual_fixtures, write_szip_fixtures,
               write_type_fixtures, write_sourceless_fixtures,
               write_option_fixtures)
    chosen = sys.argv[1:] or [w.__name__ for w in writers]
    for writer in writers:
        if writer.__name__ in chosen:
            writer(Path(chip_smoke.FIXTURE_DIR))
