"""The pretrained-encoder cache (`models/pretrained.py`) against the JAX
package's: a seeded 3-channel cache written by `flax.serialization` gives
the port's model the encoder the JAX model merges, at every element; the
first-conv adaptation; the warning and `pretrained_loaded` without a cache;
and the CLI's choice to fold the frozen epochs (`resolve_training_phases`)
in both branches, against the JAX function."""

import logging
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.models import pretrained as jax_pretrained
from volume_segmantics_tpu.models.torch_convert import _convert_resnet_encoder
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.scripts import train_2d_model as jax_train
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.model.model_2d import (
    create_model_from_file,
    create_model_on_device,
)
from volume_segmantics_tpu_torch.models import pretrained
from volume_segmantics_tpu_torch.models.checkpoint import save_checkpoint
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.scripts import train_2d_model as train

torch.set_num_threads(1)

STRUC = {"encoder_name": "resnet34", "encoder_weights": "imagenet",
         "in_channels": 1, "classes": 2}


def write_cache(folder, seed=0, stats=True):
    """A seeded resnet34 encoder, 3-channel first conv and random running
    statistics, converted and written by the JAX package's own code."""
    model = create_model(dict(STRUC, type="U_Net", in_channels=3),
                         generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in model.state_dict().items():
        value = value.numpy().copy()
        if key.endswith(("running_mean", "bn1.bias", "bn2.bias")):
            value = rng.normal(size=value.shape).astype(value.dtype)
        elif key.endswith(("running_var", "bn1.weight", "bn2.weight")):
            value = rng.uniform(0.5, 1.5, value.shape).astype(value.dtype)
        sd[key] = value
    params, batch_stats = {}, {}
    _convert_resnet_encoder(sd, params, batch_stats, prefix="encoder")
    blob = {"params": params["encoder"]}
    if stats:
        blob["batch_stats"] = batch_stats["encoder"]
    (folder / "resnet34.vstpu").write_bytes(serialization.msgpack_serialize(blob))
    return sd


@pytest.mark.parametrize("stats", [True, False], ids=["with_stats", "no_stats"])
def test_cached_encoder_equals_the_jax_merge(tmp_path, monkeypatch, stats):
    sd = write_cache(tmp_path, stats=stats)
    monkeypatch.setenv(pretrained.WEIGHTS_DIR_ENV, str(tmp_path))
    bundle = jax_create_model_on_device(0, dict(STRUC, type=JaxModelType.U_NET))
    model = create_model_on_device("cpu", dict(STRUC, type="U_Net"),
                                   generator=torch.Generator().manual_seed(1))
    assert bundle.pretrained_loaded and model.pretrained_loaded
    ref = jax_smp_state_dict(bundle.variables, dict(STRUC, type=JaxModelType.U_NET))
    ours = model.state_dict()
    encoder = [k for k in ref if k.startswith("encoder.")]
    assert len(encoder) == 36 + 36 * 5  # 36 conv/BN pairs, 5 BN keys each
    for key in encoder:
        if key.endswith(("running_mean", "running_var")) and not stats:
            continue  # both keep their initial statistics
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    kernel = ours["encoder.conv1.weight"].numpy()
    np.testing.assert_array_equal(kernel, sd["encoder.conv1.weight"].sum(
        axis=1, keepdims=True))
    if not stats:
        assert torch.equal(ours["encoder.bn1.running_var"], torch.ones(64))


@pytest.mark.parametrize("tree", [
    {"stem_conv": {"conv": {"kernel": None}, "bn": {}}},  # ResNet
    {"conv_stem": {"kernel": None}, "bnact_stem": {}},  # EfficientNet
    {"stem_conv1": {"conv": {"kernel": None}}, "stem_conv2": {}},  # ResNeSt
    {"layer1_0": {}},
], ids=["resnet", "efficientnet", "resnest", "none"])
def test_first_conv_path_matches_jax(tree):
    """The cache's first convolution is found as the JAX package finds it,
    and only it is adapted (a 3-channel kernel summed to one channel)."""
    path = pretrained.first_conv_path(tree)
    assert path == jax_pretrained._first_conv_path(tree)
    if path is None:
        return
    kernel = np.random.default_rng(0).normal(size=(3, 3, 3, 8)).astype(
        np.float32)
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = kernel
    adapted = pretrained._with_adapted_first_conv(tree, 1)
    got = adapted
    for key in path:
        got = got[key]
    np.testing.assert_array_equal(got, kernel.sum(axis=2, keepdims=True))
    assert node[path[-1]] is kernel  # the cache's tree is left as it was


@pytest.mark.parametrize("in_channels", [1, 2, 3, 5])
def test_adapt_first_conv_matches_jax(in_channels):
    kernel = np.random.default_rng(in_channels).normal(
        size=(7, 7, 3, 64)).astype(np.float32)
    got = pretrained._adapt_first_conv(kernel, in_channels)
    ref = jax_pretrained._adapt_first_conv(kernel, in_channels)
    assert got.shape == ref.shape == (7, 7, in_channels, 64)
    np.testing.assert_array_equal(got, ref)


def test_missing_cache_warns_as_jax_and_keeps_the_init(tmp_path, monkeypatch,
                                                       caplog):
    monkeypatch.delenv(pretrained.WEIGHTS_DIR_ENV, raising=False)
    make = lambda: create_model_on_device(
        "cpu", dict(STRUC, type="U_Net"), generator=torch.Generator().manual_seed(2))
    with caplog.at_level(logging.WARNING):
        model = make()
    assert not model.pretrained_loaded
    warning = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        jax_pretrained.load_pretrained_encoder({}, "resnet34", 1)
    # The JAX warning's text, but naming the port's converter, which needs
    # no JAX.
    assert warning == [caplog.records[0].getMessage().replace(
        "tools/convert_torch_encoder.py",
        "`python -m volume_segmantics_tpu_torch.scripts.convert_torch_encoder`")]
    random_init = create_model(dict(STRUC, type="U_Net"),
                               generator=torch.Generator().manual_seed(2))
    for key, value in random_init.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    # A rebuilt checkpoint counts as loaded and merges nothing.
    path = tmp_path / "m.pytorch"
    save_checkpoint(path, model, dict(STRUC, type="U_Net"))
    write_cache(tmp_path)
    monkeypatch.setenv(pretrained.WEIGHTS_DIR_ENV, str(tmp_path))
    rebuilt, _, _ = create_model_from_file(path, device="cpu")
    assert rebuilt.pretrained_loaded
    assert torch.equal(rebuilt.encoder.conv1.weight, model.encoder.conv1.weight)


@pytest.mark.parametrize("skip", [True, False], ids=["skip_on", "skip_off"])
@pytest.mark.parametrize("weights", ["imagenet", None], ids=["imagenet", "none"])
@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_resolve_training_phases_matches_jax(tmp_path, monkeypatch, skip,
                                             weights, cache):
    if cache:
        write_cache(tmp_path)
    monkeypatch.setenv(pretrained.WEIGHTS_DIR_ENV, str(tmp_path))
    assert pretrained.pretrained_weights_available("resnet34") == cache == \
        jax_pretrained.pretrained_weights_available("resnet34")
    settings = SimpleNamespace(
        num_cyc_frozen=8, num_cyc_unfrozen=5, skip_frozen_without_pretrained=skip,
        model={"type": "U_Net", "encoder_name": "resnet34",
               "encoder_weights": weights})
    got = train.resolve_training_phases(settings)
    assert got == jax_train.resolve_training_phases(settings)
    folded = skip and not (weights == "imagenet" and cache)
    assert got == ((0, 13) if folded else (8, 5))
