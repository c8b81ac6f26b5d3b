"""One PyTorch train step (augmentation off, float32, S=64, batch 2) from
weights carried across from the JAX model, against the JAX package's
`build_dp_train_step` with the same learning rate, frozen and unfrozen;
and one eval step with a padded tail (n_valid=1) against
`build_dp_eval_step`. `assert_step_matches_jax` serves the per-loss steps
of `test_torch_losses.py` too."""

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


def make_setup():
    """The seeded JAX model and one batch of images and masks."""
    bundle = jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(0),
        dtype=jnp.float32,
    )
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (BATCH, S, S), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    return bundle, images, masks


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def carried(variables):
    model = create_model(STRUC)
    model.load_state_dict(smp_state_dict_from_variables(numpy_tree(variables), STRUC))
    return model


def jax_step(bundle, images, masks, frozen, settings=SETTINGS):
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
        {"params": p, "batch_stats": bs}, dict(STRUC, type=JaxModelType.U_NET)
    )


def port_step(variables, images, masks, frozen, settings=SETTINGS):
    model = carried(variables)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(not (frozen and name.startswith("encoder.")))
        if p.requires_grad:
            trainable.append(p)
    step = build_train_step(
        model, get_loss_fn(settings), make_base_optimizer(trainable, 0.01),
        num_labels=2, image_size=S, compute_dtype=torch.float32, augment=False,
    )
    loss = step(torch.from_numpy(images), torch.from_numpy(masks), LR)
    return loss.item(), model


def float64_grads(variables, images, masks, settings=SETTINGS):
    """The port's gradients of the same step in float64."""
    model = carried(variables).double().train()
    x = torch.from_numpy(images).double() / 255.0
    x = ((x - 0.449) / 0.226)[:, None]
    targets = torch.nn.functional.one_hot(
        torch.from_numpy(masks).long(), 2).permute(0, 3, 1, 2).double()
    get_loss_fn(settings)(model(x), targets).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def assert_step_matches_jax(setup, frozen, settings=SETTINGS, min_share=0.25):
    """The port's step against the JAX step from the same weights: the
    loss, every updated parameter above the float64 noise floor, and the
    running statistics."""
    bundle, images, masks = setup
    before = carried(bundle.variables).state_dict()
    ref_loss, ref_sd = jax_step(bundle, images, masks, frozen, settings)
    loss, model = port_step(bundle.variables, images, masks, frozen, settings)
    np.testing.assert_allclose(loss, ref_loss, atol=1e-5, rtol=0)
    sd = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads64 = float64_grads(bundle.variables, images, masks, settings)
    n_updated = n_trainable = 0
    for name, p in model.named_parameters():
        if frozen and name.startswith("encoder."):
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
