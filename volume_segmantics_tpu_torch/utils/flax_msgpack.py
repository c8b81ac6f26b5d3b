"""The msgpack subset that `flax.serialization.msgpack_serialize` writes,
read and written in numpy and the standard library only.

The JAX package stores its native checkpoints (`VSTPU1` files) and its
converted pretrained-encoder cache in this format. The GPU machine has no
flax and may have no `msgpack`, so the port carries its own codec, as
`utils/hdf5.py` does for HDF5.

What is supported, on both sides:
- maps with str keys, arrays (lists), nil, bool, ints of every msgpack
  width, float32 and float64, str and bin;
- ext type 1, an array: the msgpack of `(shape, dtype name, C-order
  buffer)`, of numpy's bool, int, uint, float and complex types, and of
  bfloat16, which numpy lacks: such an array reads as a `torch.bfloat16`
  tensor, and a `torch.bfloat16` tensor is written as one (a tensor of
  another type is written as its numpy array);
- ext type 2, a Python complex: the msgpack of `(real, imag)`;
- ext type 3, a numpy scalar, stored as a 0-d array; a bfloat16 one reads
  as a `BFloat16Scalar`, a 0-d `torch.bfloat16` tensor that is written
  back as ext type 3 (a plain 0-d tensor is written as ext type 1, as
  flax writes a 0-d array);
- flax's chunked arrays: an array of more than `CHUNK_LIMIT` bytes (flax's
  MAX_CHUNK_SIZE) that is a map's value, or the whole tree, is written as
  the map {"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": ..., ...}} of flat pieces of CHUNK_LIMIT bytes (those
  keys in that order), and such a map in a map, or as the tree, reads as
  the array whole, as flax reassembles it.

`msgpack_serialize(tree)` gives the bytes flax gives for the same tree:
map keys sorted, Python floats as float64, every array or numpy scalar an
ext, each header in its smallest form. Any other dtype (float8 types,
int4, ...) and any other ext type raise NotImplementedError.
"""

import struct
from typing import Any

import numpy as np
import torch

CHUNK_LIMIT = 2**30  # flax's MAX_CHUNK_SIZE: larger arrays are chunked
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
BFLOAT16 = "bfloat16"  # a dtype name numpy does not know
# numpy's own bool, int, uint, float and complex types (whatever other
# types a package such as ml_dtypes registers with numpy).
_NAMES = {"bool", "float16", "float32", "float64", "complex64", "complex128",
          *(f"{k}int{b}" for k in ("", "u") for b in (8, 16, 32, 64))}


class BFloat16Scalar(torch.Tensor):
    """A bfloat16 numpy scalar as the port holds it: a 0-d `torch.bfloat16`
    tensor that `msgpack_serialize` writes as ext type 3, as flax writes an
    `ml_dtypes.bfloat16` scalar. Make one with `torch.tensor(v,
    dtype=torch.bfloat16).as_subclass(BFloat16Scalar)`; what a torch
    function makes of it is a plain tensor."""

    __torch_function__ = torch._C._disabled_torch_function_impl


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not supported by the PyTorch port's msgpack reader "
        "(see ROADMAP.md)."
    )


def _dtype(name: str) -> np.dtype:
    """numpy dtype of a flax dtype name; only bool, int, uint, float and
    complex."""
    if name not in _NAMES:
        raise _unsupported(f"Array dtype {name!r}")
    return np.dtype(name)


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


def _ndarray_bytes(arr) -> bytes:
    """flax's `_ndarray_to_bytes`: the msgpack of (shape, name, buffer), of
    a numpy array or a `torch.bfloat16` tensor."""
    if isinstance(arr, torch.Tensor):
        name = BFLOAT16
        data = arr.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
    else:
        name = _dtype(arr.dtype.name).name
        data = arr.tobytes("C")
    out = bytearray()
    _pack(out, [list(arr.shape), name, data])
    return bytes(out)


def _as_array(x):
    """A tensor leaf as flax would see it: a bfloat16 tensor stays one,
    any other becomes its numpy array."""
    if x.dtype == torch.bfloat16:
        return x
    return x.detach().cpu().numpy()


def _nbytes(arr) -> int:
    return (arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor)
            else arr.size * arr.dtype.itemsize)


def _pack_chunked(out: bytearray, arr) -> None:
    """flax's `_chunk`: a map of the marker, the shape and flat pieces of
    CHUNK_LIMIT bytes, in that order, each numbered in order ("0", "1",
    ..., "10"): flax builds it after its tree is sorted."""
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, int(CHUNK_LIMIT / itemsize))
    flat = arr.reshape(-1)
    _pack_len(out, 3, 0x80, 16, (None, 0xDE, 0xDF))
    _pack(out, CHUNKED)
    _pack(out, True)
    for key, items in (("shape", [int(n) for n in arr.shape]),
                       ("chunks", [flat[i:i + size]
                                   for i in range(0, flat.shape[0], size)])):
        _pack(out, key)
        _pack_len(out, len(items), 0x80, 16, (None, 0xDE, 0xDF))
        for i, item in enumerate(items):
            _pack(out, str(i))
            _pack(out, item)


def _pack_leaf(out: bytearray, x) -> None:
    """A map's value or the whole tree: an array over CHUNK_LIMIT bytes is
    chunked, as flax chunks those (and no array in a list)."""
    if isinstance(x, torch.Tensor):
        x = _as_array(x)
    if isinstance(x, (np.ndarray, torch.Tensor)) and _nbytes(x) > CHUNK_LIMIT:
        _pack_chunked(out, x)
    else:
        _pack(out, x)


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
            _pack_leaf(out, x[key])
    elif t is list:
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, BFloat16Scalar):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(x.as_subclass(torch.Tensor)))
    elif isinstance(x, torch.Tensor):
        x = _as_array(x)
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif t is complex:
        data = bytearray()
        _pack(data, [x.real, x.imag])  # msgpack.packb((real, imag))
        _pack_ext(out, EXT_COMPLEX, bytes(data))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def msgpack_serialize(tree: Any) -> bytes:
    """Bytes of `tree` (nested dicts and lists of the supported leaves),
    equal to `flax.serialization.msgpack_serialize(tree)`."""
    out = bytearray()
    _pack_leaf(out, tree)
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
            scalar = _ndarray_from_bytes(data)
            if isinstance(scalar, torch.Tensor):
                return scalar.as_subclass(BFloat16Scalar)
            return scalar[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
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


def _ndarray_from_bytes(data: bytes):
    shape, name, buffer = _Reader(data).read()
    if name == BFLOAT16:
        bits = np.frombuffer(buffer, np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=_dtype(name)).reshape(shape, order="C")


def _unchunk(tree: dict):
    """flax's `_unchunk`: the pieces joined and shaped."""
    pieces = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
    shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
    if isinstance(pieces[0], torch.Tensor):
        return torch.cat(pieces).reshape(shape)
    return np.concatenate(pieces).reshape(shape)


def _unchunk_leaves(tree):
    """flax's `_unchunk_array_leaves_in_place`: a chunked map as the tree,
    or as a map's value at any depth of maps, becomes its array."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                tree[key] = _unchunk_leaves(value)
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` gives: dicts,
    lists, Python scalars, str, bytes, read-only numpy arrays (writable
    where reassembled from chunks), `torch.bfloat16` tensors where flax
    gives bfloat16 arrays and `BFloat16Scalar`s where it gives bfloat16
    scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(
            f"msgpack data has {len(reader.data) - reader.pos} extra bytes"
        )
    return _unchunk_leaves(tree)


def numpy_leaves(tree):
    """`tree` with each tensor leaf (in dicts and lists) as a numpy array,
    a bfloat16 one as float32 (exactly), a `BFloat16Scalar` as a float32
    scalar: what the weight mappings take."""
    if isinstance(tree, dict):
        return {k: numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_leaves(v) for v in tree]
    if isinstance(tree, BFloat16Scalar):
        return tree.float().numpy()[()]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree
