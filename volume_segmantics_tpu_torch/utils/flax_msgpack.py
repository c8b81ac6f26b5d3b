"""The msgpack subset that `flax.serialization.msgpack_serialize` writes,
read and written in numpy and the standard library only.

The JAX package stores its native checkpoints (`VSTPU1` files) and its
converted pretrained-encoder cache in this format. The GPU machine has no
flax and may have no `msgpack`, so the port carries its own codec, as
`utils/hdf5.py` does for HDF5.

What is supported, on both sides:
- maps with str keys, arrays (lists), nil, bool, ints of every msgpack
  width, float32 and float64, str and bin;
- ext type 1, a numpy array: the msgpack of `(shape, dtype name, C-order
  buffer)`;
- ext type 3, a numpy scalar, stored as a 0-d array.

`msgpack_serialize(tree)` gives the bytes flax gives for the same tree:
map keys sorted, Python floats as float64, every numpy array or scalar an
ext, each header in its smallest form. Ext type 2 (a Python complex), flax's
chunked arrays (`__msgpack_chunked_array__`, arrays over 2**30 bytes) and
any dtype outside numpy's bool, int, uint and float types (bfloat16
included: the JAX package keeps its parameters in float32) raise
NotImplementedError.
"""

import struct
from typing import Any

import numpy as np

CHUNK_LIMIT = 2**30  # flax's MAX_CHUNK_SIZE: larger arrays are chunked
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_KINDS = {"b", "i", "u", "f"}  # bool, int, uint, float


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not supported by the PyTorch port's msgpack reader "
        "(see ROADMAP.md)."
    )


def _dtype(name: str) -> np.dtype:
    """numpy dtype of a flax dtype name; only bool, int, uint and float."""
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in _KINDS or dtype.name != name:
        raise _unsupported(f"Array dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix_base, fix_max, codes) -> None:
    """A str/bin/array/map header: the fix form below `fix_max` (when the
    type has one), else the 8-, 16- or 32-bit length form in `codes`."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too long: {n}")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                                 (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int too big for msgpack: {v}")
    else:
        for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                 (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int too small for msgpack: {v}")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: the msgpack of (shape, name, buffer)."""
    _dtype(arr.dtype.name)
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, x: Any) -> None:
    t = type(x)  # exact types, as flax packs with strict_types=True
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif t is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(x)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif t is dict:
        # flax copies the tree with jax.tree_util first, which sorts keys.
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for key in sorted(x):
            _pack(out, key)
            _pack(out, x[key])
    elif t is list:
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, np.ndarray):
        if x.nbytes > CHUNK_LIMIT:
            raise _unsupported(
                f"An array of {x.nbytes} bytes (flax chunks arrays over "
                f"{CHUNK_LIMIT} bytes)"
            )
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif t is complex:
        raise _unsupported("A complex number (msgpack ext type 2)")
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def msgpack_serialize(tree: Any) -> bytes:
    """Bytes of `tree` (nested dicts and lists of the supported leaves),
    equal to `flax.serialization.msgpack_serialize(tree)`."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data is truncated")
        chunk = self.data[self.pos:end].tobytes()
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if type(key) not in (str, bytes):
                raise ValueError(f"msgpack map key of type {type(key).__name__}")
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == EXT_COMPLEX:
            raise _unsupported("A complex number (msgpack ext type 2)")
        raise _unsupported(f"msgpack ext type {code}")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", self.take), 0xC5: (">H", self.take),
            0xC6: (">I", self.take),
            0xD9: (">B", self.str_), 0xDA: (">H", self.str_),
            0xDB: (">I", self.str_),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
            0xC9: (">I", self.ext),
        }
        if b in sized:
            fmt, then = sized[b]
            return then(self.unpack(fmt))
        fixed_ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed_ext:
            return self.ext(fixed_ext[b])
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {self.pos - 1}")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buffer = _Reader(data).read()
    return np.frombuffer(buffer, dtype=_dtype(name)).reshape(shape, order="C")


def _refuse_chunked(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise _unsupported(
                "A chunked array (flax's __msgpack_chunked_array__, arrays "
                f"over {CHUNK_LIMIT} bytes)"
            )
        for value in tree.values():
            _refuse_chunked(value)
    elif isinstance(tree, list):
        for value in tree:
            _refuse_chunked(value)


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` gives: dicts,
    lists, Python scalars, str, bytes and read-only numpy arrays."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(
            f"msgpack data has {len(reader.data) - reader.pos} extra bytes"
        )
    _refuse_chunked(tree)
    return tree
