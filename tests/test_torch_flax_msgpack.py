"""The port's msgpack codec (`utils/flax_msgpack.py`) against
`flax.serialization`: byte-equal output on seeded trees, a U-Net/ResNet-34
`to_state_dict` among them; round trips through each other's reader; and
each refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.utils import flax_msgpack


def seeded_tree(seed):
    """Every leaf type of the subset, at every header width."""
    rng = np.random.default_rng(seed)
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "weights": {
            "kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
            "bias": rng.normal(size=(4,)).astype(np.float64),
            "half": rng.normal(size=(5,)).astype(np.float16),
            "transposed": rng.normal(size=(3, 5)).astype(np.float32).T,
            "empty": np.zeros((0, 3), np.float32),
        },
        "ints": ints + [int(v) for v in rng.integers(-2**40, 2**40, 8)],
        "int_arrays": [rng.integers(-100, 100, (4,)).astype(d)
                       for d in ("int8", "int16", "int32", "int64")]
        + [rng.integers(0, 200, (4,)).astype(d)
           for d in ("uint8", "uint16", "uint32", "uint64")],
        "scalars": [np.float32(rng.normal()), np.float64(rng.normal()),
                    np.int64(-7), np.uint8(200), np.bool_(True)],
        "flags": np.array([True, False, True]),
        "float": float(rng.normal()), "none": None, "yes": True, "no": False,
        "strings": ["", "x" * 31, "y" * 32, "é" * 200, "z" * 70000],
        "bytes": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000],
        "wide_map": {f"k{i}": i for i in range(int(rng.integers(16, 40)))},
        "long_list": list(range(int(rng.integers(16, 40)))),
        "unsorted": {"b": 1, "a": 2, "c": {"z": 0, "y": 1}},
        "empty_map": {}, "empty_list": [],
    }


def assert_same_tree(got, ref):
    assert type(got) is type(ref), (type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for key in ref:
            assert_same_tree(got[key], ref[key])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert_same_tree(a, b)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serialize_is_byte_equal_to_flax(seed):
    tree = seeded_tree(seed)
    assert flax_msgpack.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


@pytest.fixture(scope="module")
def unet_state():
    bundle = jax_create_model_on_device(
        0, {"type": JaxModelType.U_NET, "encoder_name": "resnet34",
            "encoder_weights": None, "in_channels": 1, "classes": 3},
        rng=jax.random.PRNGKey(5))
    return jax.tree_util.tree_map(np.asarray,
                                  serialization.to_state_dict(bundle.variables))


def test_unet_state_dict_is_byte_equal_to_flax(unet_state):
    data = serialization.msgpack_serialize(unet_state)
    assert flax_msgpack.msgpack_serialize(unet_state) == data
    assert_same_tree(flax_msgpack.msgpack_restore(data),
                     serialization.msgpack_restore(data))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_trips_through_each_others_reader(seed):
    tree = seeded_tree(seed)
    ours = flax_msgpack.msgpack_serialize(tree)
    restored = flax_msgpack.msgpack_restore(ours)
    assert_same_tree(restored, serialization.msgpack_restore(ours))
    # What the port reads back serialises to the same bytes again.
    assert flax_msgpack.msgpack_serialize(restored) == ours
    assert_same_tree(flax_msgpack.msgpack_restore(
        serialization.msgpack_serialize(tree)), serialization.msgpack_restore(ours))


@pytest.mark.parametrize("leaf", ["float8_e4m3fn", "int4", "float8_scalar"])
def test_unsupported_leaves_are_refused_both_ways(leaf):
    """Dtypes beyond numpy's own and bfloat16 (bfloat16, complex arrays and
    Python complex numbers, refused before, now read and written:
    tests/test_torch_flax_msgpack_extras.py)."""
    value = {"float8_e4m3fn": np.asarray(jnp.zeros(3, jnp.float8_e4m3fn)),
             "int4": np.asarray(jnp.zeros(3, jnp.int4)),
             "float8_scalar": np.asarray(jnp.zeros(3, jnp.float8_e5m2))[0]}[leaf]
    data = serialization.msgpack_serialize({"w": value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flax_msgpack.msgpack_restore(data)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flax_msgpack.msgpack_serialize({"w": value})


def test_chunked_arrays_are_refused():
    """Other ext types than flax's three stay refused. (Flax's chunked
    arrays, `__msgpack_chunked_array__` maps of arrays over 2**30 bytes,
    refused before, now read and written:
    tests/test_torch_flax_msgpack_extras.py.)"""
    import msgpack

    data = msgpack.packb({"w": msgpack.ExtType(7, b"\0\1")})
    with pytest.raises(NotImplementedError, match="ext type 7.*ROADMAP"):
        flax_msgpack.msgpack_restore(data)


def test_malformed_input_raises():
    data = serialization.msgpack_serialize({"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        flax_msgpack.msgpack_restore(data + b"\xc0")
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.msgpack_serialize({"w": (1, 2)})
