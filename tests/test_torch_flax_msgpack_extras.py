"""flax msgpack's extras in the port's codec (`utils/flax_msgpack.py`),
byte for byte against `flax.serialization` both ways: ext type 2 (a Python
complex), complex64 and complex128 arrays and scalars, bfloat16 arrays
(read as `torch.bfloat16` tensors of the same bits, written from them),
bfloat16 scalars (ext type 3, read as `flax_msgpack.BFloat16Scalar` and
written back as ext type 3) and
flax's chunked arrays (`__msgpack_chunked_array__`), with flax's
MAX_CHUNK_SIZE and the port's CHUNK_LIMIT patched small together; and
`load_checkpoint` of a JAX package `VSTPU1` file holding them, against the
JAX `load_checkpoint`. `ml_dtypes` (through `jax.numpy`) makes the
reference bfloat16 arrays here only."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.models.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from volume_segmantics_tpu.models.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.models.checkpoint import load_checkpoint
from volume_segmantics_tpu_torch.utils import flax_msgpack

BF16 = jnp.bfloat16


def bf16(values) -> np.ndarray:
    return np.asarray(jnp.asarray(np.asarray(values, np.float32)).astype(BF16))


def to_port(x):
    """The tree the port reads for flax's `x`: bfloat16 arrays as tensors,
    bfloat16 scalars as `BFloat16Scalar`s."""
    if isinstance(x, np.generic) and x.dtype == BF16:
        return to_port(np.asarray(x)).as_subclass(flax_msgpack.BFloat16Scalar)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, np.ndarray) and x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return x


def assert_same(got, ref):
    """`got` (the port's) is `ref` (flax's): bfloat16 leaves bit for bit,
    complex ones by their bits (NaNs, -0.0) and type."""
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for key in ref:
            assert_same(got[key], ref[key])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert_same(a, b)
    elif isinstance(ref, np.generic) and ref.dtype == BF16:
        assert type(got) is flax_msgpack.BFloat16Scalar
        assert got.dtype == torch.bfloat16 and got.shape == ()
        assert got.view(torch.int16).item() == np.asarray(ref).view(np.int16)
    elif isinstance(ref, np.ndarray) and ref.dtype == BF16:
        assert type(got) is torch.Tensor and got.dtype == torch.bfloat16
        assert tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref) and got.dtype == ref.dtype
        assert np.shape(got) == np.shape(ref)
        np.testing.assert_array_equal(np.asarray(got).reshape(-1).view(np.uint8),
                                      np.asarray(ref).reshape(-1).view(np.uint8))
    elif isinstance(ref, complex):
        assert type(got) is complex
        assert [math.copysign(1, v) for v in (got.real, got.imag)] == [
            math.copysign(1, v) for v in (ref.real, ref.imag)]
        np.testing.assert_array_equal(np.array([got]), np.array([ref]))
    else:
        assert type(got) is type(ref) and got == ref


def complex_tree(seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    return {
        "python": [1 + 2j, -0.0 - 0.0j, complex(float("inf"), float("nan")),
                   complex(rng.normal(), rng.normal()), 1e300j],
        "c64": z.astype(np.complex64), "c128": z.T,
        "c64_scalar": np.complex64(3 - 4j), "c128_scalar": np.complex128(-1j),
        "empty": np.zeros((0, 2), np.complex64),
        "nested": {"b": [z[0].astype(np.complex64), 2.5j], "a": 7},
    }


def bf16_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "kernel": bf16(rng.normal(size=(3, 3, 2, 5))),
        "bias": bf16(rng.normal(size=(5,))),
        "special": bf16([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 3.4e38]),
        "zero_d": bf16(1.5).reshape(()),
        "scalar": bf16(rng.normal())[()],  # ext type 3, not a 0-d array
        "empty": bf16(np.zeros((0,))),
        "list": [bf16(rng.normal(size=(2,))), np.float32(1), bf16(-0.0)[()]],
    }


@pytest.mark.parametrize("make", [complex_tree, bf16_tree],
                         ids=["complex", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_extras_are_byte_equal_to_flax_both_ways(make, seed):
    tree = make(seed)
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.msgpack_restore(data)
    assert_same(got, serialization.msgpack_restore(data))
    assert flax_msgpack.msgpack_serialize(got) == data
    assert flax_msgpack.msgpack_serialize(to_port(tree)) == data


def test_a_python_complex_is_ext_type_2_of_its_parts():
    data = flax_msgpack.msgpack_serialize({"z": 1.5 - 2j})
    assert data == serialization.msgpack_serialize({"z": 1.5 - 2j})
    assert data[3:6] == bytes([0xC7, 19, 2])  # ext 8, 19 bytes, type 2
    assert data[6:8] == bytes([0x92, 0xCB])  # (real, imag) as float64


def test_bfloat16_tensors_keep_their_bits():
    """Every bfloat16 bit pattern, from the port's tensor to flax's array
    and back."""
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    tensor = bits.view(torch.bfloat16).reshape(256, 256)
    data = flax_msgpack.msgpack_serialize({"w": tensor})
    ref = serialization.msgpack_restore(data)["w"]
    assert ref.dtype == BF16 and ref.shape == (256, 256)
    np.testing.assert_array_equal(ref.view(np.int16), bits.numpy().reshape(256, 256))
    back = flax_msgpack.msgpack_restore(data)["w"]
    assert torch.equal(back.view(torch.int16), tensor.view(torch.int16))


LIMIT = 24  # bytes: small enough to chunk, both sides patched alike


@pytest.fixture()
def small_chunks(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", LIMIT)
    monkeypatch.setattr(flax_msgpack, "CHUNK_LIMIT", LIMIT)


def chunked_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "big": rng.normal(size=(7, 5)).astype(np.float32),  # 12 chunks: "10" < "2"
        "exact": np.arange(6, dtype=np.float32),  # 24 bytes: not chunked
        "over": np.arange(25, dtype=np.uint8),
        "bf16": bf16(rng.normal(size=(4, 4))),
        "c128": (rng.normal(size=(3,)) + 1j).astype(np.complex128),
        "inner": {"w": rng.integers(0, 9, (2, 3, 4)).astype(np.int16), "k": 1},
        "in_list": [np.arange(40, dtype=np.float64)],  # flax chunks no list item
        "scalar": np.float64(2.0),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_arrays_are_byte_equal_to_flax_both_ways(small_chunks, seed):
    tree = chunked_tree(seed)
    data = serialization.msgpack_serialize(tree)
    assert data.count(b"__msgpack_chunked_array__") == 5
    got = flax_msgpack.msgpack_restore(data)
    assert_same(got, serialization.msgpack_restore(data))
    assert got["big"].shape == (7, 5)
    assert flax_msgpack.msgpack_serialize(got) == data
    assert flax_msgpack.msgpack_serialize(to_port(tree)) == data


def test_a_chunked_tree_and_chunked_maps_read_whole(small_chunks):
    """An array as the whole tree is chunked too; a chunked map read as a
    map's value reassembles, one inside a list does not (flax's rule)."""
    top = np.arange(20, dtype=np.float32)
    data = serialization.msgpack_serialize(top)
    assert flax_msgpack.msgpack_serialize(top) == data
    np.testing.assert_array_equal(flax_msgpack.msgpack_restore(data), top)
    chunked = {"__msgpack_chunked_array__": True, "shape": {"0": 2},
               "chunks": {"0": np.zeros(1, np.float32), "1": np.ones(1, np.float32)}}
    data = serialization.msgpack_serialize({"m": chunked, "l": [chunked]})
    ours, ref = (f.msgpack_restore(data) for f in (flax_msgpack, serialization))
    np.testing.assert_array_equal(ours["m"], ref["m"])
    assert isinstance(ours["l"][0], dict) and isinstance(ref["l"][0], dict)


def test_load_checkpoint_gives_the_jax_leaves(tmp_path, monkeypatch):
    """A `VSTPU1` file the JAX package writes, its weights in bfloat16 and
    an extra of bfloat16, complex and chunked leaves: the port's
    `load_checkpoint` maps the weights as it maps the JAX ones in float32
    (bfloat16 widens exactly), and gives the extra's leaves as the JAX
    `load_checkpoint` does: bfloat16 bit for bit, chunked arrays whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_msgpack, "CHUNK_LIMIT", 4096)
    struc = {"type": JaxModelType.U_NET, "encoder_name": "resnet34",
             "encoder_weights": None, "in_channels": 1, "classes": 2}
    bundle = jax_create_model_on_device(0, struc, rng=jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(BF16),
        {"params": bundle.params, "batch_stats": bundle.batch_stats})
    rng = np.random.default_rng(3)
    extra = {"ema": bf16(rng.normal(size=(64, 40))),  # chunked: 5120 bytes
             "phase": np.exp(1j * rng.normal(size=(6,))).astype(np.complex64),
             "z": 2 - 1j, "table": rng.normal(size=(30, 30)),  # chunked
             "scale": bf16(0.375)[()]}
    path = tmp_path / "m.vstpu"
    jax_save_checkpoint(path, variables, struc, loss_val=0.25,
                        label_codes={"0": "label_val_False", "1": "label_val_True"},
                        extra=extra)
    ours, ref = load_checkpoint(path), jax_load_checkpoint(path)
    assert ours["label_codes"] == ref["label_codes"]
    assert ours["loss_val"] == ref["loss_val"] == 0.25
    assert_same(ours["extra"], ref["extra"])
    assert ours["extra"]["table"].shape == (30, 30)
    widened = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                     ref["model_state_dict"])
    want = jax_smp_state_dict(widened, dict(struc))
    for key, value in ours["model_state_dict"].items():
        if key.endswith("num_batches_tracked"):
            continue
        assert value.dtype == torch.float32
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]),
                                      err_msg=key)
