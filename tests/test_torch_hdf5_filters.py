"""The port's HDF5 reader (`utils/hdf5.py`, `utils/hdf5_filters.py`) on the
filters beyond zlib's that h5py writes: LZF (h5py's filter 32000), alone
and behind shuffle and Fletcher-32, with chunks it stored compressed and
chunks it could not shrink (left unfiltered, their mask bit set);
scale-offset on integers (the library's minimum bits, fill values, a
constant chunk at minbits 0, chunks at full width) and on floats with a
decimal scale, bit for bit; n-bit on full-precision types and on
integers of reduced precision at bit offsets; szip
(libaec's decoder) on every integer and float type h5py writes with it,
under the nearest-neighbour preprocessor and entropy coding alone, 8, 16
and 32 pixels a block, scanlines that are not whole blocks, behind
shuffle with Fletcher-32, and on data that takes every coding option.
Each file is built here by h5py and read whole and by basic selections
equal to h5py's reading, at tolerance 0 (szip also through
`numpy_from_hdf5` and `LazyHDF5Volume`); edge chunks are partial on every
axis. A corrupt LZF or szip stream raises ValueError. Scale-offset's
E-scale method, which the library cannot write, is refused by h5py and by
the port alike."""

import struct

import h5py
import numpy as np
import pytest

from volume_segmantics_tpu_torch.utils import hdf5, hdf5_filters
from volume_segmantics_tpu_torch.utils.base_data_utils import (
    LazyHDF5Volume,
    numpy_from_hdf5,
)

SHAPE = (13, 20, 18)
CHUNKS = (5, 8, 7)  # partial edge chunks on every axis
SELECTIONS = [(), np.s_[3], np.s_[2:9, 5:17, 1:12], np.s_[-1, :, 4], np.s_[4, 7, 9],
              np.s_[:, 0:0]]
SELECTIONS_2D = [(), np.s_[1], np.s_[1:7, 2:13], np.s_[-1, 5], np.s_[:, 0:0]]


def compressible(dtype, shape=SHAPE, seed=0):
    """Smooth values with runs and noise, so that LZF and scale-offset both
    have something to do."""
    rng = np.random.default_rng(seed)
    z, y, x = np.indices(shape)
    base = 40 * np.sin(z / 3.0) + 25 * np.cos(y / 5.0) + x
    base[:, ::4] = 0  # runs of one value
    vol = base + rng.normal(scale=3, size=shape)
    if np.dtype(dtype).kind in "ui":
        info = np.iinfo(dtype)
        vol = np.clip(np.round(vol), max(info.min, -2000), min(info.max, 2000))
    return vol.astype(dtype)


def assert_reads_equal(path, name):
    with h5py.File(path, "r") as f:
        ds = f[name]
        selections = SELECTIONS if ds.ndim == 3 else SELECTIONS_2D
        refs = [ds[sel] for sel in selections]
    with hdf5.File(path) as f:
        ds = f[name]
        for sel, ref in zip(selections, refs):
            got = ds[sel]
            assert np.asarray(got).dtype == np.asarray(ref).dtype.newbyteorder("=")
            np.testing.assert_array_equal(got, ref, strict=False)
            if isinstance(ref, np.ndarray):
                assert got.tobytes() == ref.astype(got.dtype).tobytes()
            else:
                assert np.asarray(got).tobytes() == np.asarray(ref).astype(
                    np.asarray(got).dtype).tobytes()
    return refs[0]


def chunk_masks(path, name):
    with h5py.File(path, "r") as f:
        dsid = f[name].id
        return [dsid.get_chunk_info(i).filter_mask
                for i in range(dsid.get_num_chunks())]


LZF_CASES = {
    "alone_u1": ("u1", dict()),
    "alone_le_i2": ("<i2", dict()),
    "alone_be_f4": (">f4", dict()),
    "shuffle_u2": ("<u2", dict(shuffle=True)),
    "shuffle_fletcher32_i4": ("<i4", dict(shuffle=True, fletcher32=True)),
    "fletcher32_be_f8": (">f8", dict(fletcher32=True)),
}


@pytest.mark.parametrize("case", list(LZF_CASES))
def test_lzf_reads_equal_h5py(tmp_path, case):
    dtype, options = LZF_CASES[case]
    path = tmp_path / "lzf.h5"
    data = compressible(dtype)
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=CHUNKS, compression="lzf",
                         **options)
    np.testing.assert_array_equal(assert_reads_equal(path, "data"), data)
    with hdf5.File(path) as f:
        ids = [fid for fid, _, _ in f["data"]._filters]
    assert hdf5.FILTER_LZF in ids


def test_lzf_chunks_it_could_not_shrink_are_read_unfiltered(tmp_path):
    """h5py's LZF filter is optional: on a chunk LZF would grow it fails,
    and the library stores that chunk as it is with the filter's mask bit
    set. Noise does that; a run of zeros compresses."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (16, 32, 32), dtype=np.uint8)
    data[8:] = 0
    path = tmp_path / "mixed.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=(8, 32, 32), compression="lzf",
                         shuffle=True)
    assert sorted(chunk_masks(path, "data")) == [0, 2]  # LZF is filter 1
    np.testing.assert_array_equal(assert_reads_equal(path, "data"), data)


def test_lzf_back_references_that_overlap_their_output():
    """A run of one byte, and of a period of 3, each a back reference that
    reads what it writes; a long reference takes the extra length byte."""
    stream = bytes([2, 7, 8, 9,  # literal 7 8 9
                    (7 << 5) | 0, 20, 2,  # 7 + 20 + 2 = 29 bytes from 3 back
                    0, 5,  # literal 5
                    (1 << 5) | 0, 0])  # 3 bytes from 1 back
    want = bytes([7, 8, 9] * 11)[:32] + bytes([5, 5, 5, 5])
    assert hdf5_filters.lzf_decode(stream) == want


@pytest.mark.parametrize("chunk, message", [
    (bytes([31, 1, 2]), "literal run passes the end"),
    (bytes([0, 9, 1 << 5]), "back reference passes the end"),
    (bytes([0, 9, 7 << 5, 4]), "back reference passes the end"),
    (bytes([0, 9, 1 << 5, 5]), "points before the output"),
])
def test_a_corrupt_lzf_stream_raises_value_error(tmp_path, chunk, message):
    path = tmp_path / "corrupt.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("data", shape=(4, 8), dtype="u1", chunks=(4, 8),
                              compression="lzf")
        ds.id.write_direct_chunk((0, 0), chunk, filter_mask=0)
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["data"][()]
    with hdf5.File(path) as f, pytest.raises(ValueError, match=message):
        f["data"][()]


SCALEOFFSET_INT_CASES = {
    "u1": ("u1", dict()),
    "i1": ("i1", dict()),
    "le_u2": ("<u2", dict()),
    "be_i2": (">i2", dict()),
    "le_i4_fill": ("<i4", dict(fillvalue=-7)),
    "be_u4_fill": (">u4", dict(fillvalue=3)),
    "le_i8": ("<i8", dict()),
    "u2_shuffle_lzf": ("<u2", dict(shuffle=True, compression="lzf")),
    "i2_shuffle_gzip": ("<i2", dict(shuffle=True, compression="gzip")),
    "u2_fixed_minbits": ("<u2", dict(scaleoffset=12)),
}


@pytest.mark.parametrize("case", list(SCALEOFFSET_INT_CASES))
def test_integer_scaleoffset_reads_equal_h5py(tmp_path, case):
    """scaleoffset=0: the library picks each chunk's minimum bits. Values
    equal to a defined fill value are stored as the all-ones code; chunks
    never written take the fill value."""
    dtype, options = SCALEOFFSET_INT_CASES[case]
    options = {"scaleoffset": 0, **options}
    data = compressible(dtype)
    if "fillvalue" in options:
        data[::3, 2, :] = options["fillvalue"]
    path = tmp_path / "so.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=CHUNKS, **options)
        ds = f.create_dataset("partly_written", shape=SHAPE, dtype=dtype,
                              chunks=CHUNKS, **options)
        ds[2:9, 3:11, :] = data[2:9, 3:11, :]
    np.testing.assert_array_equal(assert_reads_equal(path, "data"), data)
    assert_reads_equal(path, "partly_written")


def scaleoffset_chunk(minbits: int, minval: int, packed: bytes = b"") -> bytes:
    """A scale-offset chunk as the filter lays it out: minbits (4 bytes),
    the size of minval (1 byte), minval (8 of the 16 bytes kept for it),
    then the packed codes."""
    return (struct.pack("<IB", minbits, 8) + minval.to_bytes(8, "little")
            + bytes(8) + packed)


@pytest.mark.parametrize("fill_defined", [True, False])
def test_scaleoffset_chunks_of_one_value(tmp_path, fill_defined):
    """h5py always defines a fill value for the filter, so a chunk of one
    value takes 1 bit a value. A chunk at minbits 0 holds the minimum
    alone, and where a fill value is defined the library reads its code, 0,
    as the fill value. The file without a defined fill value is h5py's with
    that flag of the filter's parameters cleared."""
    data = np.full((8, 16), 9, np.int16)
    data[4:, 8:] = -200
    path = tmp_path / "so.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("data", data=data, chunks=(4, 8), scaleoffset=0,
                              fillvalue=5)
        ds.id.write_direct_chunk((0, 8), scaleoffset_chunk(0, 2**64 - 17))
    if not fill_defined:
        raw = bytearray(path.read_bytes())
        name = raw.index(b"scaleoffset\0")
        values = name + 16  # the name, padded to 8 bytes
        assert struct.unpack_from("<8I", raw, values)[:8] == (2, 0, 32, 0, 2, 1, 0, 1)
        struct.pack_into("<I", raw, values + 28, 0)
        path.write_bytes(bytes(raw))
    got = assert_reads_equal(path, "data")
    np.testing.assert_array_equal(got[:, 8:][:4], 5 if fill_defined else -17)
    np.testing.assert_array_equal(got[4:], data[4:])


@pytest.mark.parametrize("dtype, data", [
    ("u1", np.r_[0:256:8, 255].astype("u1")[:32].reshape(4, 8)),
    ("<f4", np.array([[0.5, 3e9], [-4e9, 1.25]], "<f4")),
])
def test_scaleoffset_chunks_at_full_width(tmp_path, dtype, data):
    """A chunk that spans its type's whole range (integers), or whose
    scaled span passes the integer range (floats), is stored at full
    width: the values as they are after the header. HDF5 1.14.6 writes
    such chunks but fails to read them back ("filter returned failure
    during read"), so the port is held to the data written."""
    data = data.copy()
    if dtype == "u1":
        data[0, 0], data[-1, -1] = 0, 255
    path = tmp_path / "so.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=data.shape,
                         scaleoffset=0 if dtype == "u1" else 2)
        dsid = f["data"].id
        chunk = dsid.read_direct_chunk((0, 0))[1]
    assert int.from_bytes(chunk[:4], "little") == 8 * data.itemsize
    got, _ = hdf5.read(path, "data")
    assert got.tobytes() == data.tobytes()


SCALEOFFSET_FLOAT_CASES = {
    "le_f4_d2": ("<f4", 2, None),
    "be_f4_d3": (">f4", 3, None),
    "le_f8_d2": ("<f8", 2, None),
    "be_f8_d5": (">f8", 5, None),
    "le_f4_d0": ("<f4", 0, None),
    "le_f4_d2_fill": ("<f4", 2, 1.5),
    "le_f8_d4_fill": ("<f8", 4, -2.25),
}


@pytest.mark.parametrize("case", list(SCALEOFFSET_FLOAT_CASES))
def test_float_scaleoffset_reads_bit_equal_to_h5py(tmp_path, case):
    """D-scale is lossy: the port must give h5py's values bit for bit
    (code / 10^D + min in the type's own precision), not the data."""
    dtype, digits, fill = SCALEOFFSET_FLOAT_CASES[case]
    data = (compressible("<f8") / 7.3).astype(dtype)
    data[1, 1, :4] = [-1e-3, 1e-3, 0.0, 123.456]
    options = {} if fill is None else {"fillvalue": fill}
    if fill is not None:
        data[::4, 3, :] = fill
    path = tmp_path / "so.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=CHUNKS, scaleoffset=digits,
                         **options)
        f.create_dataset("shuffled", data=data, chunks=CHUNKS, scaleoffset=digits,
                         shuffle=True, compression="lzf", **options)
    got = assert_reads_equal(path, "data")
    assert not np.array_equal(got, data) or digits == 0 and fill is None
    assert_reads_equal(path, "shuffled")


def test_scaleoffset_behind_fletcher32(tmp_path):
    """h5py refuses scale-offset with Fletcher-32; the library writes it."""
    data = compressible("<i2")
    path = tmp_path / "so.h5"
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(CHUNKS)
        dcpl.set_scaleoffset(h5py.h5z.SO_INT, 0)
        dcpl.set_fletcher32()
        ds = h5py.h5d.create(f.id, b"data", h5py.h5t.STD_I16LE,
                             h5py.h5s.create_simple(SHAPE), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    np.testing.assert_array_equal(assert_reads_equal(path, "data"), data)


@pytest.mark.parametrize("dtype", ["u1", "<i2", ">u4", "<i8", "<f4", ">f8"])
def test_nbit_on_full_precision_types_reads_equal_h5py(tmp_path, dtype):
    """The library marks full-precision data as needing no packing: the
    port checks the filter's parameters (atom class, size, order,
    precision, offset) and reads the data as it is."""
    data = compressible(dtype)
    path = tmp_path / "nbit.h5"
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(CHUNKS)
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        dcpl.set_deflate(1)
        ds = h5py.h5d.create(f.id, b"data", h5py.h5t.py_create(np.dtype(dtype)),
                             h5py.h5s.create_simple(SHAPE), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
    np.testing.assert_array_equal(assert_reads_equal(path, "data"), data)
    with hdf5.File(path) as f:
        nbit = [values for fid, _, values in f["data"]._filters
                if fid == hdf5.FILTER_NBIT][0]
    size = np.dtype(dtype).itemsize
    assert nbit[:2] == (8, 1)  # eight values; no packing needed
    assert nbit[3:] == (hdf5_filters.NBIT_ATOMIC, size,
                        int(np.dtype(dtype).str[0] == ">" and size > 1), 8 * size, 0)


# (base type, precision, bit offset, deflate after n-bit)
NBIT_REDUCED = [("STD_U8LE", 3, 0, False), ("STD_I8LE", 6, 2, True),
                ("STD_U16LE", 12, 0, False), ("STD_U16BE", 12, 4, True),
                ("STD_I16LE", 11, 3, False), ("STD_I16BE", 9, 7, False),
                ("STD_U32LE", 25, 7, True), ("STD_I32LE", 31, 1, False),
                ("STD_U64BE", 50, 14, False)]


@pytest.mark.parametrize("base, precision, offset, deflate", NBIT_REDUCED,
                         ids=[f"{b}-{p}-{o}{'-deflate' if d else ''}"
                              for b, p, o, d in NBIT_REDUCED])
def test_nbit_on_reduced_precision_integers_reads_equal_h5py(tmp_path, base,
                                                             precision, offset,
                                                             deflate):
    """The n-bit filter packs each value's `precision` bits, most
    significant first, one after another; the port unpacks them to the
    bit offset and converts as the library does (sign-extended), on
    partial edge chunks, with a fill value in the chunks never written,
    through `numpy_from_hdf5` and `LazyHDF5Volume` too."""
    datatype = h5py.h5t.__dict__[base].copy()
    datatype.set_precision(precision)
    datatype.set_offset(offset)
    signed = datatype.get_sign() == h5py.h5t.SGN_2
    lo, hi = ((-(1 << (precision - 1)), (1 << (precision - 1)) - 1) if signed
              else (0, (1 << precision) - 1))
    numpy_type = f"{'i' if signed else 'u'}{datatype.get_size()}"
    data = np.random.default_rng(precision).integers(
        lo, hi, SHAPE, endpoint=True).astype(numpy_type)
    data[:, :4] = hi  # every bit of the precision set
    path = tmp_path / "nbit.h5"
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(CHUNKS)
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        if deflate:
            dcpl.set_deflate(1)
        dcpl.set_fill_value(np.array([lo], numpy_type))
        h5py.h5d.create(f.id, b"data", datatype, h5py.h5s.create_simple(SHAPE),
                        dcpl=dcpl)
        f["data"][:10] = data[:10]  # chunks from 10 on are never written
    expected = data.copy()
    expected[10:] = lo
    np.testing.assert_array_equal(assert_reads_equal(path, "data"), expected)
    assert_szip_reads_equal(path, expected)  # numpy_from_hdf5, LazyHDF5Volume
    with hdf5.File(path) as f:
        ds = f["data"]
        (nbit,) = [values for fid, _, values in ds._filters
                   if fid == hdf5.FILTER_NBIT]
        assert nbit[1] == 0 and nbit[6:] == (precision, offset)
        assert ds._bits == (offset, precision)


def test_the_nbit_parameter_check_refuses_what_it_cannot_read():
    """Reduced precision is read (`test_reduced_precision_integers_read_
    equal_h5py`); the parameters must describe the dataset's own type, and
    atoms of other classes stay refused."""
    stored = np.dtype("<u2")
    with pytest.raises(ValueError, match="12 bits at bit 0, data of full "
                                         "precision"):
        hdf5_filters.nbit_check((8, 0, 20, 1, 2, 0, 12, 0), stored, None)
    with pytest.raises(ValueError, match="12 bits at bit 0, data of \\(2, 12\\)"):
        hdf5_filters.nbit_check((8, 0, 20, 1, 2, 0, 12, 0), stored, (2, 12))
    with pytest.raises(NotImplementedError, match="datatype class code 3"):
        hdf5_filters.nbit_check((8, 0, 20, 3, 2, 0, 16, 0), stored, None)
    with pytest.raises(ValueError, match="4-byte atom"):
        hdf5_filters.nbit_check((8, 1, 20, 1, 4, 0, 32, 0), stored, None)
    hdf5_filters.nbit_check((8, 1, 20, 1, 2, 0, 16, 0), stored, None)
    hdf5_filters.nbit_check((8, 0, 20, 1, 2, 0, 12, 0), stored, (0, 12))


def test_scaleoffset_e_scale_is_refused_by_h5py_and_the_port(tmp_path):
    """The library writes no E-scale (scale type 1) chunks, and reading one
    fails in it: a D-scale float dataset whose filter parameters are
    patched to E-scale raises OSError in h5py and NotImplementedError
    naming the method in the port."""
    path = tmp_path / "dscale.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=compressible("<f4"), chunks=CHUNKS,
                         scaleoffset=2)
        cd = f["data"].id.get_create_plist().get_filter(0)[2]
    assert cd[0] == hdf5_filters.SO_FLOAT_DSCALE
    raw = path.read_bytes()
    at = raw.index(struct.pack("<8I", *cd[:8]))
    escale = tmp_path / "escale.h5"
    escale.write_bytes(raw[:at] + struct.pack("<I", hdf5_filters.SO_FLOAT_ESCALE)
                       + raw[at + 4:])
    with h5py.File(escale, "r") as f:
        assert f["data"].id.get_create_plist().get_filter(0)[2][0] == 1
        with pytest.raises(OSError, match="filter returned failure"):
            f["data"][()]
    with pytest.raises(NotImplementedError, match="E-scale"):
        hdf5.read(escale)


SZIP_TYPES = ["u1", "i1", "<u2", ">u2", "<i2", "<u4", ">i4", "<f4", ">f4",
              "<f8", "<i8"]
SZIP_CASES = [(dtype, coding, block) for dtype in SZIP_TYPES
              for coding in ("nn", "ec") for block in (8, 16, 32)]


def assert_szip_reads_equal(path, data, selections=False):
    """h5py, `numpy_from_hdf5`, a `LazyHDF5Volume` (a slab) and, with
    `selections`, the port's reader by basic selections read the same
    values, bit for bit."""
    with h5py.File(path, "r") as f:
        ref, ref_chunks = f["data"][()], f["data"].chunks
    np.testing.assert_array_equal(ref, data)
    got, chunks = numpy_from_hdf5(path)
    assert chunks == ref_chunks
    assert got.dtype == ref.dtype.newbyteorder("=")
    assert got.tobytes() == ref.astype(got.dtype).tobytes()
    lazy = LazyHDF5Volume(path)
    try:
        assert lazy[2:7, 3:11].tobytes() == got[2:7, 3:11].tobytes()
    finally:
        lazy.close()
    if selections:
        assert_reads_equal(path, "data")


@pytest.mark.parametrize("dtype, coding, block", SZIP_CASES,
                         ids=[f"{t}-{c}-{b}" for t, c, b in SZIP_CASES])
def test_szip_reads_equal_h5py(tmp_path, dtype, coding, block):
    data = compressible(dtype)
    path = tmp_path / "szip.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=CHUNKS, compression="szip",
                         compression_opts=(coding, block))
    assert 0 in chunk_masks(path, "data")  # szip kept some chunks
    assert_szip_reads_equal(path, data)
    with hdf5.File(path) as f:
        (options, ppb, bpp, _), = [values for fid, _, values in f["data"]._filters
                                   if fid == hdf5.FILTER_SZIP]
    assert ppb == block and bpp == 8 * np.dtype(dtype).itemsize
    assert bool(options & hdf5_filters.SZ_NN) == (coding == "nn")
    assert bool(options & hdf5_filters.SZ_MSB) == (
        np.dtype(dtype).str[0] == ">" and np.dtype(dtype).itemsize > 1)


@pytest.mark.parametrize("dtype", ["u1", ">u2", "<f4", ">f8"])
def test_szip_behind_shuffle_with_fletcher32_on_a_padded_scanline(tmp_path,
                                                                   dtype):
    """Chunks whose last axis (21 pixels a scanline) is not a whole number
    of 16-pixel blocks, partial edges on every axis, after shuffle and with
    Fletcher-32."""
    data = compressible(dtype, shape=(9, 17, 30))
    path = tmp_path / "szip.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=(4, 5, 21), shuffle=True,
                         fletcher32=True, compression="szip",
                         compression_opts=("nn", 16))
    with hdf5.File(path) as f:
        ids = [fid for fid, _, _ in f["data"]._filters]
        (_, ppb, _, per_line), = [values for fid, _, values in f["data"]._filters
                                  if fid == hdf5.FILTER_SZIP]
    assert ids == [hdf5.FILTER_SHUFFLE, hdf5.FILTER_SZIP, hdf5.FILTER_FLETCHER32]
    assert per_line % ppb
    assert_szip_reads_equal(path, data, selections=True)


def szip_options_data(kind):
    rng = np.random.default_rng(4)
    if kind == "labels":  # zero-block runs to the end of a segment
        return (rng.random((8, 40, 64)) > 0.98).astype("u1")
    if kind == "noise":  # uncompressed blocks
        return rng.integers(0, 1 << 16, (6, 20, 64)).astype("<u2")
    # runs and steps: split samples of every k and the second extension
    ramp = np.arange(6 * 40 * 64).reshape(6, 40, 64)
    return np.where(ramp % 7 == 0, ramp % 5000, ramp // 64 % 3).astype("<i2")


@pytest.mark.parametrize("kind", ["labels", "noise", "steps"])
@pytest.mark.parametrize("coding", ["nn", "ec"])
def test_szip_on_data_that_takes_every_coding_option(tmp_path, kind, coding):
    data = szip_options_data(kind)
    path = tmp_path / "szip.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, chunks=(3, 16, 64),
                         compression="szip", compression_opts=(coding, 8))
    assert_szip_reads_equal(path, data, selections=True)


@pytest.mark.parametrize("cut", [6, 100, -3])
def test_a_truncated_szip_stream_raises_value_error(tmp_path, cut):
    """libaec stops at the end of its input without an error, so h5py reads
    the samples a truncated chunk lost as zeros; the port raises."""
    data = compressible("<u2")
    path = tmp_path / "szip.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("data", data=data, chunks=CHUNKS,
                              compression="szip", compression_opts=("nn", 16))
        mask, chunk = ds.id.read_direct_chunk((0, 0, 0))
        ds.id.write_direct_chunk((0, 0, 0), chunk[:cut], filter_mask=mask)
    with h5py.File(path, "r") as f:
        assert not np.array_equal(f["data"][()], data)
    with hdf5.File(path) as f, pytest.raises(
            ValueError, match="the chunk at .* does not decode .*szip"):
        f["data"][()]


def szip_bits(*fields):
    """A stream from (value, width) fields, most significant bit first,
    after the 4-byte little-endian decoded size (8 one-byte pixels)."""
    text = "".join(format(value, f"0{width}b") for value, width in fields)
    text += "0" * (-len(text) % 8)
    return struct.pack("<I", 8) + int(text, 2).to_bytes(len(text) // 8, "big")


def test_corrupt_szip_streams_raise_value_error():
    """One 8-pixel block an interval under the preprocessor: a second
    extension code past the table, a zero-block run past its interval and
    a stream that ends inside its block."""
    cd = (hdf5_filters.SZ_NN | 8, 8, 8, 8)
    stored = np.dtype("u1")
    zero_ids = [(0, 3), (1, 1), (7, 8)]  # low entropy, second extension, ref
    with pytest.raises(ValueError, match="second extension code 91"):
        hdf5_filters.szip_decode(szip_bits(*zero_ids, (1, 92)), cd, stored)
    with pytest.raises(ValueError, match="zero-block run passes the end"):
        hdf5_filters.szip_decode(szip_bits((0, 3), (0, 1), (7, 8), (1, 2)), cd,
                                 stored)
    with pytest.raises(ValueError, match="ends inside a block"):
        hdf5_filters.szip_decode(szip_bits((7, 3), (1, 8)), cd, stored)
    # the same blocks well formed: a zero block after the reference 7, and
    # an uncompressed block
    assert hdf5_filters.szip_decode(
        szip_bits((0, 3), (0, 1), (7, 8), (1, 1)), cd, stored) == bytes([7] * 8)
    assert hdf5_filters.szip_decode(
        szip_bits((7, 3), *[(v, 8) for v in (9, 2, 4, 6, 8, 10, 12, 14)]), cd,
        stored) == bytes([9, 10, 12, 15, 19, 24, 30, 37])
