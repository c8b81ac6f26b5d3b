"""One PyTorch train step (augmentation off, float32, S=64, batch 2) from
weights carried across from the JAX model, against the JAX package's
`build_dp_train_step` with the same learning rate, frozen and unfrozen;
and one eval step with a padded tail (n_valid=1) against
`build_dp_eval_step`. For EfficientNet-B3 (batch 4), the same one-step
check frozen and unfrozen; two frozen and two unfrozen steps as the
trainer's phases run them, with the eval forward after each held to JAX's
within a fixed limit; and the trained model's bf16 eval forward.
`assert_step_matches_jax` serves the per-loss steps of `test_torch_losses.py`
too."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from volume_segmantics_tpu.data.losses import get_loss_fn as jax_get_loss_fn
from volume_segmantics_tpu.data.metrics import mean_iou as jax_mean_iou
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.models.registry import create_model as jax_create_model
from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import (
    VolSeg2dTrainer as JaxTrainer,
)
from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import _freeze_mask
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.parallel.mesh import get_mesh
from volume_segmantics_tpu.parallel.train import (
    build_dp_eval_step,
    build_dp_train_step,
)
from volume_segmantics_tpu.parallel.train import (
    make_base_optimizer as jax_make_base_optimizer,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.data.losses import get_loss_fn
from volume_segmantics_tpu_torch.data.metrics import mean_iou
from volume_segmantics_tpu_torch.model.operations.vol_seg_2d_trainer import (
    VolSeg2dTrainer,
    frozen_parameter_names,
)
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
    variables_from_smp_state_dict,
)
from volume_segmantics_tpu_torch.parallel.train import (
    build_eval_step,
    build_train_step,
    make_base_optimizer,
)

torch.set_num_threads(1)

S, BATCH, LR = 64, 2, 1e-3
STRUC = {"type": "U_NET", "encoder_name": "resnet34", "encoder_weights": None,
         "in_channels": 1, "classes": 2}
SETTINGS = SimpleNamespace(loss_criterion="DiceLoss", eval_metric="MeanIoU")


def numpy_tree(variables):
    return jax.tree_util.tree_map(np.array, serialization.to_state_dict(variables))


def make_setup(struc=STRUC, batch=BATCH):
    """The seeded JAX model and one batch of images and masks."""
    bundle = jax_create_model_on_device(
        0, dict(struc, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(0),
        dtype=jnp.float32,
    )
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (batch, S, S), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    return bundle, images, masks


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def carried(variables, struc=STRUC):
    model = create_model(struc)
    model.load_state_dict(smp_state_dict_from_variables(numpy_tree(variables), struc))
    return model


def jax_step(bundle, images, masks, frozen, settings=SETTINGS, struc=STRUC):
    tx = jax_make_base_optimizer(0.01)
    params = jax.tree_util.tree_map(jnp.array, bundle.params)
    step = build_dp_train_step(
        bundle.module, jax_get_loss_fn(settings), tx,
        _freeze_mask(params, frozen), num_labels=2, image_size=S,
        mesh=get_mesh(1), compute_dtype=jnp.float32, augment=False,
    )
    p, bs, _, loss = step(
        params, jax.tree_util.tree_map(jnp.array, bundle.batch_stats),
        tx.init(params), jnp.asarray(images), jnp.asarray(masks), LR,
        jax.random.PRNGKey(1),
    )
    return float(loss), jax_smp_state_dict(
        {"params": p, "batch_stats": bs}, dict(struc, type=JaxModelType.U_NET)
    )


def port_step(variables, images, masks, frozen, settings=SETTINGS, struc=STRUC):
    """The port's float32 train step, with the trainer's freeze set."""
    model = carried(variables, struc)
    freezable = frozen_parameter_names(model, struc) if frozen else frozenset()
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name not in freezable)
        if p.requires_grad:
            trainable.append(p)
    step = build_train_step(
        model, get_loss_fn(settings), make_base_optimizer(trainable, 0.01),
        num_labels=2, image_size=S, compute_dtype=torch.float32, augment=False,
    )
    loss = step(torch.from_numpy(images), torch.from_numpy(masks), LR)
    return loss.item(), model, freezable


def float64_grads(variables, images, masks, settings=SETTINGS, struc=STRUC):
    """The port's gradients of the same step in float64."""
    model = carried(variables, struc).double().train()
    x = torch.from_numpy(images).double() / 255.0
    x = ((x - 0.449) / 0.226)[:, None]
    targets = torch.nn.functional.one_hot(
        torch.from_numpy(masks).long(), 2).permute(0, 3, 1, 2).double()
    get_loss_fn(settings)(model(x), targets).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def assert_step_matches_jax(setup, frozen, settings=SETTINGS, min_share=0.25,
                            struc=STRUC):
    """The port's step against the JAX step from the same weights: the
    loss, every updated parameter above the float64 noise floor, and the
    running statistics."""
    bundle, images, masks = setup
    before = carried(bundle.variables, struc).state_dict()
    ref_loss, ref_sd = jax_step(bundle, images, masks, frozen, settings, struc)
    loss, model, freezable = port_step(bundle.variables, images, masks, frozen,
                                       settings, struc)
    np.testing.assert_allclose(loss, ref_loss, atol=1e-5, rtol=0)
    sd = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads64 = float64_grads(bundle.variables, images, masks, settings, struc)
    n_updated = n_trainable = 0
    for name, p in model.named_parameters():
        if name in freezable:
            # Frozen: unchanged bit for bit on both sides, and no gradient.
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(ref_sd[name], before[name].numpy(), name)
            assert grads[name] is None, name
            continue
        # Adam's first step is ~lr * sign(grad), so an element is compared
        # only where its gradient stands clear of float32 noise. Train-mode
        # BatchNorm over tiny maps makes that noise far above 1e-6 (up to
        # ~1e-2 of a tensor's largest gradient), so the floor is measured:
        # 10x the largest |float32 - float64| gradient difference of the
        # tensor, and at least 1e-6.
        g = grads[name].abs()
        noise = (grads[name].double() - grads64[name]).abs().max().item()
        moved = g >= max(1e-6, 10 * noise)
        assert not torch.equal(p.detach(), before[name]), name
        np.testing.assert_allclose(
            sd[name][moved].numpy(), ref_sd[name][moved.numpy()], atol=1e-6,
            rtol=0, err_msg=name,
        )
        n_updated += int(moved.sum())
        n_trainable += p.numel()
    # About a third of the elements stand clear of the noise floor.
    assert n_updated > min_share * n_trainable, (n_updated, n_trainable)
    for name in [k for k in ref_sd if k.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(sd[name].numpy(), ref_sd[name], atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_train_step_matches_jax(setup, frozen):
    assert_step_matches_jax(setup, frozen)


def test_trainable_parameter_counts_match_jax(setup):
    bundle, _, _ = setup
    model = carried(bundle.variables)
    trainer = SimpleNamespace(
        model=model, _freezable=frozen_parameter_names(model, STRUC))
    for frozen in (True, False):
        ref = JaxTrainer._count_trainable_parameters(
            SimpleNamespace(bundle=bundle), frozen
        )
        got = VolSeg2dTrainer._count_trainable_parameters(trainer, frozen)
        assert got == ref, frozen
    assert VolSeg2dTrainer._count_trainable_parameters(trainer, True) < sum(
        p.numel() for p in model.parameters())


def test_eval_step_with_padded_tail_matches_jax(setup):
    bundle, images, masks = setup
    ref_loss, ref_score = build_dp_eval_step(
        bundle.module, jax_get_loss_fn(SETTINGS), jax_mean_iou, num_labels=2,
        mesh=get_mesh(1), compute_dtype=jnp.float32,
    )(bundle.params, bundle.batch_stats, jnp.asarray(images),
      jnp.asarray(masks), 1)
    model = carried(bundle.variables)
    loss, score = build_eval_step(
        model, get_loss_fn(SETTINGS), mean_iou, num_labels=2,
        compute_dtype=torch.float32,
    )(torch.from_numpy(images), torch.from_numpy(masks), 1)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(score.item(), float(ref_score), atol=1e-5, rtol=0)


def test_optimizer_matches_optax_chain():
    """AdamW of the port == optax scale_by_adam + add_decayed_weights(0.01)
    followed by -lr * update, over a few steps with changing lr. The decay
    alone moves a parameter by up to 5e-4 here; the two implementations
    round the bias corrections differently, a few ulps of |p| <= 2.5."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = rng.normal(size=(4, 64)).astype(np.float32) * 1e-3
    lrs = [1e-2, 3e-3, 5e-2, 1e-3]
    tx = jax_make_base_optimizer(0.01)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_base_optimizer([param], 0.01)
    for g, lr in zip(grads, lrs):
        u, state = tx.update(jnp.asarray(g), state, jp)
        jp = jp - lr * u
        param.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# EfficientNet-B3: one step as ResNet-34's, frozen and unfrozen; then two
# frozen steps (the JAX freeze mask) and two unfrozen steps with a fresh
# optimizer, as the trainer's two phases run, and an eval-mode forward after
# each phase.
# ---------------------------------------------------------------------------

EFF_STRUC = {"type": "U_Net", "encoder_name": "efficientnet-b3",
             "encoder_weights": None, "in_channels": 1, "classes": 2}
EFF_BATCH = 4
# Adam's first steps move each parameter by ~lr * sign(grad), so a gradient
# whose sign float32 rounding flips moves it by 2 * lr on one side only, and
# at lr 1e-3 four steps compound that: the JAX and port float32 runs lay
# 4.9e-2 apart on logits of at most 0.48, each as far from a float64 run.
# At EFF_LR the steps stay linear: the two lay 2.9e-5 (after the frozen
# steps) and 7.2e-5 (after the unfrozen ones) apart, while the updates
# themselves moved JAX's logits by 1.6e-3 and 3.8e-3 (against the same
# steps at lr 0, which move only the running statistics). EFF_ATOL sits
# 4x above the first and EFF_MOVED below the second.
EFF_LR = 1e-5
EFF_ATOL = 3e-4
EFF_MOVED = 1e-3
# bf16 rounding of the trained weights' eval forward against JAX's float32
# one: measured 4.7e-3 (JAX in bf16) and 5.5e-3 (the port under autocast),
# labels 0.49% and 0.45% apart.
EFF_BF16_ATOL = 2e-2
EFF_BF16_MISS = 0.02


def eff_images(seed, n=EFF_BATCH):
    return np.random.default_rng(seed).integers(0, 256, (n, S, S),
                                                dtype=np.uint8)


def eff_normalised(images):
    return ((images / 255.0 - 0.449) / 0.226).astype(np.float32)


def eff_tree():
    """The port's seeded weights carried to a flax tree (no JAX init to
    trace)."""
    torch.manual_seed(0)
    return variables_from_smp_state_dict(create_model(EFF_STRUC).state_dict(),
                                         EFF_STRUC)


@pytest.fixture(scope="module")
def eff_setup():
    variables = jax.tree_util.tree_map(jnp.asarray, eff_tree())
    bundle = SimpleNamespace(
        module=jax_create_model(dict(EFF_STRUC, type=JaxModelType.U_NET)),
        variables=variables, params=variables["params"],
        batch_stats=variables["batch_stats"])
    images = eff_images(7)
    return bundle, images, (images > 128).astype(np.uint8)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_efficientnet_b3_train_step_matches_jax(eff_setup, frozen):
    """The port's float32 `build_train_step` on EfficientNet-B3 with the
    trainer's freeze set, held to the JAX step as ResNet-34's is (46% and
    49% of the trainable elements stand clear of the float64 floor,
    measured)."""
    assert_step_matches_jax(eff_setup, frozen, struc=EFF_STRUC)


@pytest.fixture(scope="module")
def eff_runs():
    """The step losses and the eval logits (NHWC, float64) after each phase:
    the JAX package's float32 steps at EFF_LR and at lr 0 (running
    statistics only), and the port's float32 `build_train_step` at EFF_LR,
    all from the same weights; and JAX's trained tree for the bf16 case."""
    tree = eff_tree()
    module = jax_create_model(dict(EFF_STRUC, type=JaxModelType.U_NET))
    batches = [(im, (im > 128).astype(np.uint8))
               for im in (eff_images(10 + i) for i in range(4))]
    phases = ((True, batches[:2]), (False, batches[2:]))
    x_eval = eff_normalised(eff_images(20))
    jax_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))
    params0 = jax.tree_util.tree_map(jnp.array, tree["params"])
    jax_steps = {}
    for frozen, _ in phases:
        tx = jax_make_base_optimizer(0.01)
        jax_steps[frozen] = tx, build_dp_train_step(
            module, jax_get_loss_fn(SETTINGS), tx,
            _freeze_mask(params0, frozen), num_labels=2, image_size=S,
            mesh=get_mesh(1), compute_dtype=jnp.float32, augment=False,
        )

    def jax_run(lr):
        params = jax.tree_util.tree_map(jnp.array, tree["params"])
        stats = jax.tree_util.tree_map(jnp.array, tree["batch_stats"])
        losses, logits = [], []
        for frozen, phase in phases:
            tx, step = jax_steps[frozen]
            opt_state = tx.init(params)
            for images, masks in phase:
                params, stats, opt_state, loss = step(
                    params, stats, opt_state, jnp.asarray(images),
                    jnp.asarray(masks), lr, jax.random.PRNGKey(1))
                losses.append(float(loss))
            logits.append(np.asarray(jax_eval(
                {"params": params, "batch_stats": stats},
                jnp.asarray(x_eval[..., None]))).astype(np.float64))
        return losses, logits, numpy_tree({"params": params,
                                           "batch_stats": stats})

    jax_losses, ref, trained = jax_run(EFF_LR)
    _, still, _ = jax_run(0.0)

    model = create_model(EFF_STRUC)
    model.load_state_dict(smp_state_dict_from_variables(tree, EFF_STRUC))
    freezable = frozen_parameter_names(model, EFF_STRUC)
    losses, got = [], []
    for frozen, phase in phases:
        trainable = []
        for name, p in model.named_parameters():
            p.requires_grad_(not (frozen and name in freezable))
            if p.requires_grad:
                trainable.append(p)
        step = build_train_step(
            model, get_loss_fn(SETTINGS), make_base_optimizer(trainable, 0.01),
            num_labels=2, image_size=S, compute_dtype=torch.float32,
            augment=False)
        for images, masks in phase:
            losses.append(step(torch.from_numpy(images),
                               torch.from_numpy(masks), EFF_LR).item())
        model.eval()
        with torch.no_grad():
            logits = model(torch.from_numpy(x_eval)[:, None])
        got.append(logits.permute(0, 2, 3, 1).double().numpy())
    return SimpleNamespace(jax=ref, still=still, port=got,
                           jax_losses=jax_losses, port_losses=losses,
                           trained=trained, x_eval=x_eval)


@pytest.mark.parametrize("phase", [0, 1], ids=["after_frozen", "after_unfrozen"])
def test_efficientnet_b3_phases_match_jax(eff_runs, phase):
    """The port's steps against JAX's: each step's loss within 1e-5, the
    eval logits after the phase within EFF_ATOL, and the argmax labels equal
    wherever JAX's two logits stand more than 2 * EFF_ATOL apart."""
    ref, got = eff_runs.jax[phase], eff_runs.port[phase]
    np.testing.assert_allclose(eff_runs.port_losses[:2 * phase + 2],
                               eff_runs.jax_losses[:2 * phase + 2],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=EFF_ATOL, rtol=0)
    # The parameter updates move the logits far beyond EFF_ATOL, so a
    # wrong or missing update cannot hide under it.
    moved = float(np.abs(ref - eff_runs.still[phase]).max())
    assert moved > EFF_MOVED, moved
    labels = ref.argmax(-1)
    clear = np.abs(ref[..., 1] - ref[..., 0]) > 2 * EFF_ATOL
    assert clear.mean() > 0.98, clear.mean()
    np.testing.assert_array_equal(got.argmax(-1)[clear], labels[clear])
    # Both classes are predicted: a constant label would hide nothing.
    assert 0.01 < labels.mean() < 0.99


def test_efficientnet_b3_bf16_eval_matches_jax(eff_runs):
    """The trained weights' eval forward in bf16, as prediction runs it: the
    JAX module built in bf16 and the port under bf16 autocast each lie
    within EFF_BF16_ATOL of JAX's float32 forward, and their labels differ
    from its labels at no more than EFF_BF16_MISS of the pixels."""
    module = jax_create_model(dict(EFF_STRUC, type=JaxModelType.U_NET),
                              dtype=jnp.bfloat16)
    x = eff_runs.x_eval
    f32 = eff_runs.jax[1]
    ref = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        eff_runs.trained, jnp.asarray(x[..., None]).astype(jnp.bfloat16))
    ).astype(np.float64)
    model = create_model(EFF_STRUC)
    model.load_state_dict(smp_state_dict_from_variables(eff_runs.trained,
                                                        EFF_STRUC))
    model.eval()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        bf16 = model(torch.from_numpy(x)[:, None]).float()
    bf16 = bf16.permute(0, 2, 3, 1).double().numpy()
    labels = f32.argmax(-1)
    for name, a in (("jax", ref), ("port", bf16)):
        err = float(np.abs(a - f32).max())
        miss = float(np.mean(a.argmax(-1) != labels))
        assert 0 < err <= EFF_BF16_ATOL, (name, err)
        assert miss <= EFF_BF16_MISS, (name, miss)
