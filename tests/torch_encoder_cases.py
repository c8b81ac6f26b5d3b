"""Shared cases of the encoder tests (`test_torch_encoders_*.py`): the six
encoders the port adds beside ResNet-34, each under U-Net, held against the
JAX package's model, the pure-torch smp oracle (`tests/torch_oracle.py`)
and the canonical key sets of `tests/test_encoder_key_inventory.py`; and
every (decoder, encoder) pair's parameter count, keys and shapes against
JAX's, from `jax.eval_shape` (no pair compiles).

Each test file star-imports this module, defines a module-scoped `encoder`
fixture over two names of `ORACLES` and parametrises `check_pair` over its
pairs. JAX applies run under `jax.jit`; the dilated encoders are applied
to the U-Net bundle's own encoder variables (the output stride changes no
parameter).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
import torch_oracle as oracle
import volume_segmantics_tpu.utils.config as jax_cfg
from test_encoder_key_inventory import CANONICAL_INVENTORIES
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import (
    _freeze_mask,
)
from volume_segmantics_tpu.models.registry import _get_encoder
from volume_segmantics_tpu.models.registry import create_model as jax_create_model
from volume_segmantics_tpu.models.torch_convert import load_torch_checkpoint
from volume_segmantics_tpu.models.torch_export import export_torch_checkpoint
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.data.losses import get_loss_fn
from volume_segmantics_tpu_torch.model.model_2d import (
    create_model_from_file,
    create_model_on_device,
)
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
    frozen_parameter_names,
)
from volume_segmantics_tpu_torch.models.checkpoint import MAGIC, save_checkpoint
from volume_segmantics_tpu_torch.models.pretrained import WEIGHTS_DIR_ENV
from volume_segmantics_tpu_torch.models.registry import ENCODERS, create_model
from volume_segmantics_tpu_torch.models.torch_export import (
    encoder_state_dict_from_variables,
    smp_state_dict_from_variables,
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.parallel.train import (
    build_train_step,
    make_base_optimizer,
)
from volume_segmantics_tpu_torch.utils.flax_msgpack import msgpack_serialize

torch.set_num_threads(1)

STRUC = {"type": "U_Net", "encoder_weights": None, "in_channels": 1,
         "classes": 3}
# encoder -> (U-Net oracle, DeepLabV3+ oracle or None, oracle kwargs)
ORACLES = {
    "resnet50": ("smp_unet_forward", "smp_deeplabv3plus_forward",
                 {"bottleneck": True}),
    "resnext50_32x4d": ("smp_unet_forward", None,
                        {"bottleneck": True, "groups": 32}),
    "efficientnet-b3": ("smp_unet_efficientnet_forward",
                        "smp_deeplabv3plus_efficientnet_forward",
                        {"depth_mult": 1.4}),
    "efficientnet-b4": ("smp_unet_efficientnet_forward", None,
                        {"depth_mult": 1.8}),
    "timm-resnest50d": ("smp_unet_resnest_forward", None, {}),
    "timm-resnest101e": ("smp_unet_resnest_forward", None, {}),
}
DECODERS = ("U_Net", "U_Net_Plus_Plus", "FPN", "DeepLabV3", "DeepLabV3_Plus",
            "MA_Net", "Linknet", "PAN")
SIDE = 64
# Eval logits and features, port against JAX and against the oracle, over
# the largest magnitude: float32 throughout, but XLA's and oneDNN's
# convolutions sum in other orders over 50-340 layers with randomised
# BatchNorm (measured at most 1.2e-5; the JAX package's own oracle test
# allows 1e-3). The ResNet-34 decoders' tests use the same bound.
EVAL_RTOL = 3e-5
# Train mode divides by batch statistics, some over few values (at 64 px
# and batch 4: 16 values a channel at stride 32, and 4 in the ResNeSt
# split-attention's `bn1`, which normalises batch x 1 x 1 values), so how
# far float32 rounding moves the result depends on the model: against a
# float64 forward of the same port model the logits moved 3.5e-5 of their
# scale for ResNet-50, 1.6e-5 for EfficientNet-B4, 9.1e-4 for ResNeSt-50d
# and 6.9e-3 for ResNeSt-101e, and XLA's float32 result lay 1-6x as far
# from it. So the port is held to JAX within TRAIN_RTOL of the logits'
# scale (5e-4, the ResNet-34 decoders' bound), or FLOAT32_FACTOR times its
# own float32 distance from the float64 forward where that is larger; the
# running statistics within STATS_ATOL absolute (they move by 0.1 x the
# batch statistics from 0 and 1), or FLOAT32_FACTOR times their largest
# float32 distance, plus STATS_RTOL of their value: XLA's float32 batch
# variance of ResNet-50's 2048-channel stride-32 shortcut put one running
# variance of 1.13 at 1.0e-4 from the port's, which lay within 2.5e-5 of
# its float64 value.
TRAIN_RTOL = 5e-4
STATS_ATOL = 1e-4
STATS_RTOL = 1e-4
FLOAT32_FACTOR = 4


def numpy_tree(variables):
    return jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(variables))


def struc(encoder, **more):
    """The port's structure dict (settings' type string)."""
    return dict(STRUC, encoder_name=encoder, **more)


def jax_struc(encoder, mtype="U_Net"):
    return dict(STRUC, encoder_name=encoder,
                type=JaxModelType[mtype.upper()])


def randomize_norm_layers(tree, seed):
    """Every BatchNorm's scale, bias and running statistics drawn at random
    in place (`bn`, and ResNeSt's `bn0`/`bn1`): fresh-init BN is an
    identity in eval mode and would hide BN faults."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k, v in params.items():
            if not isinstance(v, dict):
                continue
            if k.startswith("bn") and "scale" in v:
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


def nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def port_forward(model, x_nhwc, train=False):
    model.train(train)
    with torch.no_grad():
        out = model(nchw(x_nhwc))
    return out.permute(0, 2, 3, 1).numpy()


def assert_close_to_scale(got, ref, rtol, what):
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{what}: max|diff| {err:.3e}, scale {scale:.3e}"


def assert_state_dicts_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


def port_model(encoder, tree, mtype="U_Net"):
    model = create_model(struc(encoder, type=mtype))
    model.load_state_dict(smp_state_dict_from_variables(
        tree, struc(encoder, type=mtype)))
    return model


def oracle_logits(name, x_nhwc, sd, encoder):
    with torch.no_grad():
        out = getattr(oracle, name)(nchw(x_nhwc), sd, **ORACLES[encoder][2])
    return out.permute(0, 2, 3, 1).numpy()


def with_wide_stem(tree):
    """The encoder subtrees with the first convolution widened to three
    input channels (the kernel, then zeros), as an ImageNet cache holds
    it: the port sums it back to the kernel."""
    params = copy.deepcopy(tree["params"]["encoder"])
    node = next(params[n] for n in ("stem_conv", "conv_stem", "stem_conv1")
                if n in params)
    node = node["conv"] if "conv" in node else node
    k = node["kernel"]
    node["kernel"] = np.concatenate([k, np.zeros_like(k), np.zeros_like(k)],
                                    axis=2)
    return {"params": params, "batch_stats": tree["batch_stats"]["encoder"]}


@pytest.fixture(scope="module")
def bundle(encoder):
    """The seeded JAX U-Net on `encoder`, its variables as a numpy tree and
    a jitted eval apply."""
    b = jax_create_model_on_device(0, jax_struc(encoder),
                                   rng=jax.random.PRNGKey(42))
    b.eval_fn = jax.jit(lambda v, x: b.module.apply(v, x, train=False))
    b.tree = numpy_tree(b.variables)
    return b


@pytest.fixture(scope="module")
def carried(encoder, bundle):
    """The port's U-Net with the JAX model's weights (copy before changing
    it)."""
    return port_model(encoder, bundle.tree)


@pytest.fixture(scope="module")
def randomized(bundle):
    """The bundle's tree with randomised BatchNorms."""
    return randomize_norm_layers(numpy_tree(bundle.variables), seed=3)


# ---------------------------------------------------------------------------
# The tests, run once for each encoder of the importing file
# ---------------------------------------------------------------------------


def test_carried_state_dict_equals_jax_export_and_canonical_keys(
        encoder, bundle, carried):
    """smp's names, lukemelas' tail included: the JAX export's tensors and
    exactly the upstream package's encoder keys."""
    ours = carried.state_dict()
    assert_state_dicts_equal(ours, jax_smp_state_dict(bundle.variables,
                                                      jax_struc(encoder)))
    assert ({k[len("encoder."):] for k in ours if k.startswith("encoder.")}
            == set(CANONICAL_INVENTORIES[encoder]))


def test_parameter_count_matches_jax(bundle, carried):
    assert (sum(p.numel() for p in carried.parameters())
            == bundle.count_parameters())


def test_variables_round_trip_bit_equal(encoder, bundle, carried):
    back = variables_from_smp_state_dict(carried.state_dict(), struc(encoder))
    ref = dict(jax.tree_util.tree_leaves_with_path(bundle.tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("output_stride,strides", [
    (32, (1, 2, 4, 8, 16, 32)),
    (16, (1, 2, 4, 8, 16, 16)),
    (8, (1, 2, 4, 8, 8, 8)),
], ids=["os32", "os16", "os8"])
def test_features_match_jax(encoder, randomized, output_stride, strides):
    """The six features, eval mode with randomised BatchNorm, at each
    output stride, from the U-Net bundle's encoder variables."""
    jax_encoder, channels = _get_encoder(encoder, jnp.float32, output_stride)
    enc_vars = {"params": randomized["params"]["encoder"],
                "batch_stats": randomized["batch_stats"]["encoder"]}
    x = image_batch(2, SIDE, seed=8)
    refs = jax.jit(lambda v, x: jax_encoder.apply(v, x, train=False))(
        enc_vars, jnp.asarray(x))
    port, port_channels = ENCODERS[encoder](1, output_stride)
    port.load_state_dict({
        k[len("encoder."):]: v for k, v in encoder_state_dict_from_variables(
            enc_vars["params"], enc_vars["batch_stats"], encoder).items()})
    port.eval()
    with torch.no_grad():
        feats = port(nchw(x))
    assert tuple(port_channels) == tuple(channels)
    assert len(feats) == len(refs) == 6
    for i, (f, ref, c, s) in enumerate(zip(feats, refs, channels, strides)):
        assert f.shape == (2, c, SIDE // s, SIDE // s), i
        assert_close_to_scale(f.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                              EVAL_RTOL, f"feature {i}")


def test_unet_eval_logits_match_jax_and_oracle(encoder, bundle, carried,
                                               randomized):
    model = copy.deepcopy(carried)
    model.load_state_dict(smp_state_dict_from_variables(randomized,
                                                        struc(encoder)))
    x = image_batch(2, SIDE, seed=5)
    got = port_forward(model, x)
    variables = serialization.from_state_dict(bundle.variables, randomized)
    assert_close_to_scale(got, np.asarray(bundle.eval_fn(variables,
                                                         jnp.asarray(x))),
                          EVAL_RTOL, "JAX")
    sd = jax_smp_state_dict(variables, jax_struc(encoder))
    assert_close_to_scale(got, oracle_logits(ORACLES[encoder][0], x, sd,
                                             encoder), EVAL_RTOL, "oracle")


def test_train_logits_and_running_stats_match_jax(encoder, bundle, carried):
    x = image_batch(4, SIDE, seed=7)
    ref_logits, mutated = jax.jit(
        lambda v, x: bundle.module.apply(v, x, train=True,
                                         mutable=["batch_stats"])
    )(bundle.variables, jnp.asarray(x))
    ref_sd = jax_smp_state_dict(
        {"params": bundle.params, "batch_stats": mutated["batch_stats"]},
        jax_struc(encoder))
    model, model64 = copy.deepcopy(carried), copy.deepcopy(carried).double()
    got = port_forward(model, x, train=True)
    model64.train()
    with torch.no_grad():
        got64 = model64(nchw(x).double()).permute(0, 2, 3, 1).numpy()
    scale = max(1.0, float(np.abs(got64).max()))
    floor = float(np.abs(got - got64).max()) / scale
    assert_close_to_scale(got, np.asarray(ref_logits),
                          max(TRAIN_RTOL, FLOAT32_FACTOR * floor),
                          "train logits")
    sd, sd64 = model.state_dict(), model64.state_dict()
    stat_keys = [k for k in ref_sd if k.endswith(("running_mean", "running_var"))
                 and not k.startswith("encoder._bn1.")]  # the inert tail
    assert stat_keys
    floor = max(float((sd[k].double() - sd64[k]).abs().max()) for k in stat_keys)
    for k in stat_keys:
        np.testing.assert_allclose(
            sd[k].numpy(), ref_sd[k], rtol=STATS_RTOL, err_msg=k,
            atol=max(STATS_ATOL, FLOAT32_FACTOR * floor))


def test_frozen_set_equals_jax_freeze_mask(encoder, bundle, carried):
    """The trainer's frozen parameters, marked 0 in a copy of the model
    (the rest 1) and carried to a flax tree, equal JAX's `_freeze_mask`
    leaf for leaf; the encoder's trainable leaves and elements are JAX's
    and `chip_smoke.ENCODER_PARAMS`'."""
    frozen = frozen_parameter_names(carried, struc(encoder))
    sd = carried.state_dict()
    for name, p in carried.named_parameters():
        sd[name] = torch.full_like(p, 0.0 if name in frozen else 1.0)
    marks = variables_from_smp_state_dict(sd, struc(encoder))["params"]
    mask = dict(jax.tree_util.tree_leaves_with_path(
        _freeze_mask(bundle.params, True)))
    got = dict(jax.tree_util.tree_leaves_with_path(marks))
    assert set(got) == set(mask)
    for path, m in mask.items():
        assert np.all(got[path] == float(m)), path
    leaves = [p for name, p in carried.named_parameters()
              if name.startswith("encoder.") and name not in frozen]
    jax_leaves = [got[path] for path, m in mask.items()
                  if path[0].key == "encoder" and m == 1.0]
    assert (len(leaves), sum(p.numel() for p in leaves)) == (
        len(jax_leaves), sum(leaf.size for leaf in jax_leaves)) == \
        chip_smoke.ENCODER_PARAMS[encoder][1:]


def test_chip_smoke_parameter_count_matches_jax(encoder):
    """`chip_smoke.py` holds the card's U-Net (2 classes) to this count."""
    module = jax_create_model(dict(jax_struc(encoder), classes=2))
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, SIDE, SIDE, 1)), train=False))
    assert chip_smoke.ENCODER_PARAMS[encoder][0] == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
            shapes["params"]))


def test_frozen_step_changes_exactly_the_unfrozen_set(encoder, carried):
    """One frozen `build_train_step` step, as the trainer sets it up:
    every trainable parameter moves, every frozen one keeps its bits, and
    every BatchNorm's running statistics move."""
    model = copy.deepcopy(carried)
    frozen = frozen_parameter_names(model, struc(encoder))
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name not in frozen)
        if p.requires_grad:
            trainable.append(p)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn = get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss"))
    step = build_train_step(model, loss_fn, make_base_optimizer(trainable),
                            num_labels=3, image_size=SIDE,
                            compute_dtype=torch.float32,
                            generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 256, (4, 72, 80), dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 3, (4, 72, 80), dtype=np.uint8))
    assert np.isfinite(step(images, masks, 1e-3).item())
    after = model.state_dict()
    changed = {name for name, _ in model.named_parameters()
               if not torch.equal(after[name], before[name])}
    assert changed == {name for name, _ in model.named_parameters()} - frozen
    stats = [k for k in after if k.endswith("running_mean")
             and not k.startswith("encoder._bn1.")]
    assert all(not torch.equal(after[k], before[k]) for k in stats)


def test_native_checkpoint_loads_bit_equal(encoder, bundle, carried, tmp_path):
    """A JAX `VSTPU1` file, written from the JAX tree with the port's
    msgpack writer, rebuilds the carried model through
    `create_model_from_file`."""
    path = tmp_path / f"{encoder}.pytorch"
    blob = {"model_state_dict": bundle.tree,
            "model_struc_dict": dict(STRUC, encoder_name=encoder,
                                     type="U_NET"),
            "optimizer_state_dict": {}, "loss_val": 0.25, "label_codes": {}}
    path.write_bytes(MAGIC + msgpack_serialize(blob))
    model, classes, _ = create_model_from_file(path, device="cpu")
    assert classes == STRUC["classes"]
    assert_state_dicts_equal(model.state_dict(), carried.state_dict())


def test_torch_files_cross_both_ways(encoder, bundle, carried, tmp_path):
    """A JAX-exported torch file loads strictly into the port, bit-equal;
    a file the port writes holds exactly the reference's keys (for
    EfficientNet the lukemelas tail too) and the JAX package's torch
    loader reads it back to the JAX tree."""
    exported = tmp_path / "jax.pytorch"
    export_torch_checkpoint(exported, {
        "model_state_dict": bundle.variables,
        "model_struc_dict": jax_struc(encoder), "loss_val": 0.5,
        "label_codes": {}})
    model, _, _ = create_model_from_file(exported, device="cpu")
    assert_state_dicts_equal(model.state_dict(), carried.state_dict())

    written = tmp_path / "port.pytorch"
    save_checkpoint(written, carried, struc(encoder, type=JaxModelType.U_NET))
    keys = set(torch.load(written, weights_only=False)["model_state_dict"])
    assert keys == set(jax_smp_state_dict(bundle.variables,
                                          jax_struc(encoder)))
    back = load_torch_checkpoint(written)["model_state_dict"]
    ref = dict(jax.tree_util.tree_leaves_with_path(bundle.tree))
    got = dict(jax.tree_util.tree_leaves_with_path(numpy_tree(back)))
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_cached_encoder_with_wide_stem_loads(encoder, bundle, carried,
                                             tmp_path, monkeypatch):
    """`$VOLSEG_TPU_WEIGHTS_DIR/<encoder>.vstpu` with a 3-channel first
    convolution: the encoder takes the cache's weights, the stem summed
    back to one channel; the decoder and head keep their
    initialisation."""
    (tmp_path / f"{encoder}.vstpu").write_bytes(
        msgpack_serialize(with_wide_stem(bundle.tree)))
    monkeypatch.setenv(WEIGHTS_DIR_ENV, str(tmp_path))
    seed = lambda: torch.Generator().manual_seed(9)
    model = create_model_on_device("cpu", struc(encoder,
                                                encoder_weights="imagenet"),
                                   generator=seed())
    init = create_model(struc(encoder), generator=seed()).state_dict()
    ref = carried.state_dict()
    assert model.pretrained_loaded
    for k, v in model.state_dict().items():
        assert torch.equal(v, (ref if k.startswith("encoder.") else init)[k]), k


def check_pair(encoder, mtype):
    """`mtype` on `encoder`: the parameter count and the state_dict's keys
    and shapes equal JAX's (`jax.eval_shape` of its init, exported from
    zeros of those shapes; the port's model built on the meta device)."""
    module = jax_create_model(jax_struc(encoder, mtype))
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, SIDE, SIDE, 1)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = jax_smp_state_dict(zeros, jax_struc(encoder, mtype))
    with torch.device("meta"):
        model = create_model(struc(encoder, type=mtype))
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == np.shape(v), k
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
            shapes["params"]))


def check_deeplabv3plus_logits(encoder):
    """DeepLabV3+ (the encoder at output stride 16) in eval mode with
    randomised BatchNorm, the port against JAX and the oracle. The weights
    are the port's seeded initialisation carried to JAX (the JAX model is
    only applied)."""
    s = struc(encoder, type="DeepLabV3_Plus")
    init = create_model(s, generator=torch.Generator().manual_seed(4))
    tree = randomize_norm_layers(
        variables_from_smp_state_dict(init.state_dict(), s), seed=6)
    model = port_model(encoder, tree, "DeepLabV3_Plus")
    x = image_batch(2, SIDE, seed=9)
    got = port_forward(model, x)
    module = jax_create_model(jax_struc(encoder, "DeepLabV3_Plus"))
    ref = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        tree, jnp.asarray(x))
    assert_close_to_scale(got, np.asarray(ref), EVAL_RTOL, "JAX")
    sd = jax_smp_state_dict(tree, jax_struc(encoder, "DeepLabV3_Plus"))
    assert_close_to_scale(got, oracle_logits(ORACLES[encoder][1], x, sd,
                                             encoder), EVAL_RTOL, "oracle")
