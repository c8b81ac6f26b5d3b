"""The port's encoder-cache converter (`models/torch_convert.py`,
`scripts/convert_torch_encoder.py`) against the JAX package's
(`models/torch_convert.py`, `tools/convert_torch_encoder.py`): for each of
the seven encoders and each naming the JAX converter takes, a seeded state
dict, made by inverting the converters, gives equal trees (names, order,
shapes, dtypes and bits); the command writes the JAX tool's bytes, and
the cache loads through both packages' `load_pretrained_encoder` into
encoders equal bit for bit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volume_segmantics_tpu.models import pretrained as jax_pretrained
from volume_segmantics_tpu.models import torch_export as jax_export
from volume_segmantics_tpu.models.torch_convert import (
    convert_encoder_state_dict as jax_convert,
)
from volume_segmantics_tpu_torch.models import pretrained
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.models.torch_convert import (
    convert_encoder_state_dict,
)
from volume_segmantics_tpu_torch.models.torch_export import (
    encoder_state_dict_from_variables,
    encoder_variables_from_state_dict,
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.scripts import convert_torch_encoder

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import convert_torch_encoder as jax_tool  # noqa: E402

torch.set_num_threads(1)

NAMINGS = {
    "resnet34": ("torchvision",),
    "resnet50": ("torchvision",),
    "resnext50_32x4d": ("torchvision",),
    "efficientnet-b3": ("timm", "lukemelas"),
    "efficientnet-b4": ("timm", "lukemelas"),
    "timm-resnest50d": ("timm",),
    "timm-resnest101e": ("timm",),
}
CASES = [(e, n) for e, namings in NAMINGS.items() for n in namings]


def struc(encoder_name, in_channels=3, weights=None):
    return {"type": "U_Net", "encoder_name": encoder_name,
            "encoder_weights": weights, "in_channels": in_channels,
            "classes": 2}


def seeded_encoder(encoder_name, seed=0):
    """(params, batch_stats) in the JAX naming of a 3-channel encoder whose
    every weight and statistic is drawn from `seed`."""
    with torch.device("meta"):  # names and shapes only
        model = create_model(struc(encoder_name))
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in model.state_dict().items():
        if not key.startswith("encoder."):
            continue
        if key.endswith("running_var"):
            sd[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif value.dtype == torch.float32:
            sd[key] = rng.normal(size=value.shape).astype(np.float32)
        else:
            sd[key] = np.zeros(value.shape, np.int64)  # num_batches_tracked
    tree = encoder_variables_from_state_dict(sd, encoder_name)
    return tree["params"], tree["batch_stats"]


@pytest.fixture(scope="module")
def trees():
    return {}


def torch_state_dict(trees, encoder_name, naming):
    """The seeded encoder under `naming`, with the "encoder." prefix: the
    JAX package's inverses give torchvision and timm names, the port's
    lukemelas names (with EfficientNet's unused classification tail)."""
    if encoder_name not in trees:
        trees[encoder_name] = seeded_encoder(encoder_name)
    params, stats = trees[encoder_name]
    sd = {}
    if naming == "lukemelas":
        sd = {k: v.numpy() for k, v in encoder_state_dict_from_variables(
            params, stats, encoder_name).items()}
        assert "encoder._conv_head.weight" in sd
    elif "efficientnet" in encoder_name:
        jax_export._inverse_efficientnet_encoder(sd, params, stats)
    elif "resnest" in encoder_name:
        jax_export._inverse_resnest_encoder(sd, params, stats)
    else:
        jax_export._inverse_resnet_encoder(sd, params, stats)
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def assert_trees_identical(ours, ref, path=()):
    assert list(ours) == list(ref), path  # the same names in the same order
    for key in ref:
        if isinstance(ref[key], dict):
            assert isinstance(ours[key], dict), path + (key,)
            assert_trees_identical(ours[key], ref[key], path + (key,))
        else:
            a, b = np.asarray(ours[key]), np.asarray(ref[key])
            assert (a.shape, a.dtype) == (b.shape, b.dtype), path + (key,)
            assert a.tobytes() == b.tobytes(), path + (key,)


@pytest.mark.parametrize("encoder_name,naming", CASES)
def test_trees_equal_the_jax_converter(trees, encoder_name, naming):
    sd = torch_state_dict(trees, encoder_name, naming)
    name = encoder_name.replace("timm-", "")
    params, stats = convert_encoder_state_dict(sd, name)
    ref_params, ref_stats = jax_convert(dict(sd), name)
    assert_trees_identical(params, ref_params)
    assert_trees_identical(stats, ref_stats)
    # The round trip gives back the seeded encoder.
    seed_params, seed_stats = trees[encoder_name]
    assert_trees_identical(params, seed_params)
    assert_trees_identical(stats, seed_stats)
    # Tensors in, another prefix: the same trees.
    moved = {f"model.encoder.{k[len('encoder.'):]}": torch.from_numpy(v)
             for k, v in sd.items()}
    params, stats = convert_encoder_state_dict(moved, name, prefix="model.encoder")
    assert_trees_identical(params, ref_params)
    assert_trees_identical(stats, ref_stats)


def write_pth(trees, encoder_name, naming, path):
    """The seeded encoder as a .pth file: its state_dict without the
    "encoder." prefix, under "state_dict" beside other entries."""
    sd = torch_state_dict(trees, encoder_name, naming)
    torch.save({"state_dict": {k[len("encoder."):]: torch.from_numpy(v)
                               for k, v in sd.items()}, "epoch": 3}, path)
    return path


@pytest.mark.parametrize("encoder_name,naming", CASES)
def test_command_writes_the_jax_tools_cache(trees, encoder_name, naming,
                                            tmp_path, monkeypatch):
    pth = write_pth(trees, encoder_name, naming, tmp_path / "weights.pth")
    ours = convert_torch_encoder.main([encoder_name, str(pth), "--out-dir",
                                       str(tmp_path / "ours")])
    assert ours == tmp_path / "ours" / f"{encoder_name}.vstpu"
    monkeypatch.setattr(sys, "argv", ["convert_torch_encoder", encoder_name,
                                      str(pth), "--out-dir",
                                      str(tmp_path / "jax")])
    jax_tool.main()
    assert ours.read_bytes() == (tmp_path / "jax" / ours.name).read_bytes()


@pytest.mark.parametrize("encoder_name",
                         ["resnet34", "efficientnet-b3", "timm-resnest50d"])
def test_both_packages_load_the_cache_into_equal_encoders(
        trees, encoder_name, tmp_path, monkeypatch):
    pth = write_pth(trees, encoder_name, NAMINGS[encoder_name][0],
                    tmp_path / "weights.pth")
    convert_torch_encoder.main([encoder_name, str(pth), "--out-dir",
                                str(tmp_path)])
    monkeypatch.setenv(pretrained.WEIGHTS_DIR_ENV, str(tmp_path))
    one = struc(encoder_name, in_channels=1)
    model = create_model(one, generator=torch.Generator().manual_seed(1))
    start = variables_from_smp_state_dict(model.state_dict(), one)
    assert pretrained.load_pretrained_encoder(model, encoder_name, 1)
    merged, loaded = jax_pretrained.load_pretrained_encoder(start, encoder_name, 1)
    assert loaded
    got = variables_from_smp_state_dict(model.state_dict(), one)
    for kind in ("params", "batch_stats"):
        assert_trees_identical(got[kind]["encoder"], merged[kind]["encoder"])
    # Every leaf but the first convolution (summed over its 3 inputs) is
    # the seeded one.
    params, stats = trees[encoder_name]
    assert_trees_identical(got["batch_stats"]["encoder"], stats)
    first = pretrained.first_conv_path(params)
    node, seed = got["params"]["encoder"], params
    for key in first:
        node, seed = node[key], seed[key]
    np.testing.assert_array_equal(node, seed.sum(axis=2, keepdims=True))


@pytest.mark.parametrize("encoder_name", ["vgg16", "mobilenet_v2", "densenet121"])
def test_unknown_encoders_raise_as_in_jax(encoder_name):
    sd = {"encoder.conv1.weight": np.zeros((4, 3, 3, 3), np.float32)}
    with pytest.raises(NotImplementedError) as ours:
        convert_encoder_state_dict(sd, encoder_name)
    with pytest.raises(NotImplementedError) as ref:
        jax_convert(sd, encoder_name)
    assert str(ours.value) == str(ref.value)


def test_a_lukemelas_block_count_of_no_known_depth_raises_as_in_jax(trees):
    sd = torch_state_dict(trees, "efficientnet-b3", "lukemelas")
    last = max(int(k.split(".")[2]) for k in sd if k.startswith("encoder._blocks."))
    assert last + 1 == 26  # B3's depth multiplier, 1.4
    sd = {k: v for k, v in sd.items()
          if not k.startswith(f"encoder._blocks.{last}.")}
    with pytest.raises(NotImplementedError) as ours:
        convert_encoder_state_dict(sd, "efficientnet-b3")
    with pytest.raises(NotImplementedError) as ref:
        jax_convert(sd, "efficientnet-b3")
    assert str(ours.value) == str(ref.value)
