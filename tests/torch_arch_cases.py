"""Shared cases of the architecture tests (`test_torch_architectures_*.py`):
the seven decoders the port adds beside U-Net, each on ResNet-34, held
against the JAX package's model and the pure-torch smp oracle
(`tests/torch_oracle.py`).

Each test file star-imports this module and defines a module-scoped
`arch` fixture over some names of `CASES`; the tests below run once for
each. The JAX model is applied under
`jax.jit` (eager flax applies take several times as long on the CPU).
"""

import contextlib
import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import torch_oracle as oracle
import volume_segmantics_tpu.utils.config as jax_cfg
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.model.model_2d import (
    create_model_from_file,
    create_model_on_device,
)
from volume_segmantics_tpu_torch.models.checkpoint import MAGIC
from volume_segmantics_tpu_torch.models.layers import Dropout
from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_serialize

torch.set_num_threads(1)

STRUC = {"encoder_name": "resnet34", "encoder_weights": None,
         "in_channels": 1, "classes": 3}
# name -> (settings type string, oracle forward, oracle image side). PAN's
# oracle needs 128 px: its pools would empty a 4 x 4 stride-16 map, where
# the JAX decoder (and the port) pass it through.
CASES = {
    "U_NET_PLUS_PLUS": ("U_Net_Plus_Plus", "smp_unetpp_forward", 64),
    "FPN": ("FPN", "smp_fpn_forward", 64),
    "DEEPLABV3": ("DeepLabV3", "smp_deeplabv3_forward", 64),
    "DEEPLABV3_PLUS": ("DeepLabV3_Plus", "smp_deeplabv3plus_forward", 64),
    "MA_NET": ("MA_Net", "smp_manet_forward", 64),
    "LINKNET": ("Linknet", "smp_linknet_forward", 64),
    "PAN": ("PAN", "smp_pan_forward", 128),
}
SIDE = 64
# Eval logits, port against JAX and against the oracle, over the logits'
# largest magnitude: float32 throughout, but XLA's and oneDNN's convolutions
# sum in other orders over 40-90 layers with randomised BatchNorm (measured
# at most 6e-6 over the seven types; the JAX package's own oracle test
# allows 1e-3).
EVAL_RTOL = 3e-5
# Train mode divides by batch statistics, some over few values (at 64 px
# and batch 4: 16 values a channel at stride 32, 4 in DeepLab's image-pool
# branch), which magnifies the summation-order differences: logits within
# 5e-4 of their scale (measured at most 7.4e-5), running statistics within
# 1e-4 absolute (measured at most 2.3e-5; they move by 0.1 x the batch
# statistics from 0 and 1).
TRAIN_RTOL = 5e-4
STATS_ATOL = 1e-4


def numpy_tree(variables):
    return jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(variables))


def struc(arch, **more):
    """The port's structure dict (settings' type string)."""
    return dict(STRUC, type=CASES[arch][0], **more)


def jax_struc(arch):
    return dict(STRUC, type=JaxModelType[arch])


def carried_model(arch, tree) -> torch.nn.Module:
    model = create_model(struc(arch))
    model.load_state_dict(smp_state_dict_from_variables(tree, struc(arch)))
    return model


def randomize_norm_layers(tree, seed):
    """BatchNorm scales, biases and running statistics drawn at random in
    place (fresh-init BN is an identity in eval mode and would hide BN
    faults), as tests/test_torch_oracle.py does."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k, v in params.items():
            if not isinstance(v, dict):
                continue
            if k == "bn":
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
                v["bias"] = rng.normal(0.0, 0.2, v["bias"].shape).astype(np.float32)
                s = stats[k]
                s["mean"] = rng.normal(0.0, 0.5, s["mean"].shape).astype(np.float32)
                s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
            else:
                walk(v, stats.get(k, {}))

    walk(tree["params"], tree["batch_stats"])
    return tree


def image_batch(n, side, seed):
    """ImageNet-normalised uint8 noise, NHWC, as the training path feeds."""
    u8 = np.random.default_rng(seed).integers(0, 256, (n, side, side, 1),
                                              dtype=np.uint8)
    return ((u8 / 255.0 - jax_cfg.IMAGENET_MEAN)
            / jax_cfg.IMAGENET_STD).astype(np.float32)


def port_forward(model, x_nhwc, train=False):
    model.train(train)
    with torch.no_grad():
        out = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def assert_close_to_scale(got, ref, rtol, what):
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{what}: max|diff| {err:.3e}, scale {scale:.3e}"


@contextlib.contextmanager
def no_flax_dropout():
    """flax's Dropout as the identity (the JAX and torch masks cannot be
    equal, so train-mode comparisons run without them)."""
    saved = flax_nn.Dropout.__call__
    flax_nn.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    try:
        yield
    finally:
        flax_nn.Dropout.__call__ = saved


@pytest.fixture(scope="module")
def bundle(arch):
    """The seeded JAX model of `arch`, its variables as a numpy tree and a
    jitted eval apply."""
    b = jax_create_model_on_device(0, jax_struc(arch),
                                   rng=jax.random.PRNGKey(42))
    b.eval_fn = jax.jit(lambda v, x: b.module.apply(v, x, train=False))
    b.tree = numpy_tree(b.variables)
    return b


@pytest.fixture(scope="module")
def carried(arch, bundle):
    """The port's model with the JAX model's weights (copy before
    changing it)."""
    return carried_model(arch, bundle.tree)


# ---------------------------------------------------------------------------
# The tests, run once for each arch of the importing file
# ---------------------------------------------------------------------------


def test_carried_state_dict_equals_jax_export(arch, bundle, carried):
    ref = jax_smp_state_dict(bundle.variables, jax_struc(arch))
    ours = carried.state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_parameter_count_matches_jax(bundle, carried):
    assert (sum(p.numel() for p in carried.parameters())
            == bundle.count_parameters())


def test_variables_round_trip_bit_equal(arch, bundle, carried):
    back = variables_from_smp_state_dict(carried.state_dict(), struc(arch))
    ref = dict(jax.tree_util.tree_leaves_with_path(bundle.tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_eval_logits_match_jax_and_oracle(arch, bundle, carried):
    tree = randomize_norm_layers(numpy_tree(bundle.variables), seed=3)
    model = copy.deepcopy(carried)
    model.load_state_dict(smp_state_dict_from_variables(tree, struc(arch)))
    x = image_batch(2, SIDE, seed=5)
    variables = serialization.from_state_dict(bundle.variables, tree)
    ref = np.asarray(bundle.eval_fn(variables, jnp.asarray(x)))
    assert_close_to_scale(port_forward(model, x), ref, EVAL_RTOL, "JAX")

    _, oracle_fn, side = CASES[arch]
    x = image_batch(2, side, seed=6)
    sd = jax_smp_state_dict(variables, jax_struc(arch))
    with torch.no_grad():
        ref = getattr(oracle, oracle_fn)(
            torch.from_numpy(x).permute(0, 3, 1, 2), sd).permute(0, 2, 3, 1)
    assert_close_to_scale(port_forward(model, x), ref.numpy(), EVAL_RTOL,
                          "oracle")


def test_train_logits_and_running_stats_match_jax(arch, bundle, carried):
    x = image_batch(4, SIDE, seed=7)
    with no_flax_dropout():
        ref_logits, mutated = jax.jit(
            lambda v, x: bundle.module.apply(v, x, train=True,
                                             mutable=["batch_stats"])
        )(bundle.variables, jnp.asarray(x))
    ref_sd = jax_smp_state_dict(
        {"params": bundle.params, "batch_stats": mutated["batch_stats"]},
        jax_struc(arch))
    model = copy.deepcopy(carried)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    assert_close_to_scale(port_forward(model, x, train=True),
                          np.asarray(ref_logits), TRAIN_RTOL, "train logits")
    sd = model.state_dict()
    stat_keys = [k for k in ref_sd if k.endswith(("running_mean", "running_var"))]
    assert stat_keys
    for k in stat_keys:
        np.testing.assert_allclose(sd[k].numpy(), ref_sd[k], atol=STATS_ATOL,
                                   rtol=0, err_msg=k)


def test_native_checkpoint_loads_bit_equal(arch, bundle, carried, tmp_path):
    """A JAX `VSTPU1` file, written from the JAX tree with the port's
    msgpack writer, rebuilds the carried model through the checkpoint
    reader and `create_model_from_file`."""
    path = tmp_path / f"{arch}.pytorch"
    blob = {"model_state_dict": bundle.tree,
            "model_struc_dict": dict(STRUC, type=arch),
            "optimizer_state_dict": {}, "loss_val": 0.25,
            "label_codes": {}}
    path.write_bytes(MAGIC + msgpack_serialize(blob))
    model, classes, _ = create_model_from_file(path, device="cpu")
    ref = carried.state_dict()
    assert classes == STRUC["classes"]
    assert set(model.state_dict()) == set(ref)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("with_stats", [True, False])
def test_cached_encoder_loads(arch, bundle, carried, tmp_path, monkeypatch,
                              with_stats):
    """`$VOLSEG_TPU_WEIGHTS_DIR/resnet34.vstpu` loads into this decoder's
    model: its encoder takes the cache's weights (and, in a cache without
    batch statistics, keeps its own running statistics); the decoder and
    head keep their initialisation."""
    cache = {"params": bundle.tree["params"]["encoder"]}
    if with_stats:
        cache["batch_stats"] = bundle.tree["batch_stats"]["encoder"]
    (tmp_path / "resnet34.vstpu").write_bytes(msgpack_serialize(cache))
    monkeypatch.setenv(WEIGHTS_DIR_ENV, str(tmp_path))
    seed = lambda: torch.Generator().manual_seed(9)
    model = create_model_on_device("cpu", struc(arch, encoder_weights="imagenet"),
                                   generator=seed())
    init = create_model(struc(arch), generator=seed()).state_dict()
    ref = carried.state_dict()
    assert model.pretrained_loaded
    for k, v in model.state_dict().items():
        from_cache = k.startswith("encoder.") and (
            with_stats or not k.endswith(("running_mean", "running_var")))
        assert torch.equal(v, (ref if from_cache else init)[k]), k
