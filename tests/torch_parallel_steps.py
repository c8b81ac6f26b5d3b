"""Shared parts of the data-parallel train step tests
(`test_torch_parallel_step*.py`): the JAX model and batch, the 2-rank runs
of the port (`torch_parallel_cases.train_cases_rank`, spawned once a test
module), the JAX package's DP step on a 2-device mesh and the checks.

(a) The port's 2-rank step against JAX's on `get_mesh(2)`, from the same
weights and batch, augmentation off, 2 steps. Held to the tolerances
`test_torch_train_step.py` states for one device: each step's loss within
1e-5; after the first step every updated parameter above the float64
gradient-noise floor within 1e-6, the frozen ones bit for bit (after both
steps), the running statistics within 1e-4. Where the port's own
one-process step on the global batch lies farther than that from JAX (the
weighted cross-entropy's loss, 1.8e-5 on 1.07; the running statistics
after the second step, 2.4e-4 on BCEDiceLoss's at lr 1e-5), the 2-rank
step is held to twice that distance: the data-parallel layer adds no error
of its own. Adam's steps are blind to the gradients' scale; (b) holds it.

(b) The port's 2-rank step against its own one-process step on the global
batch, with augmentation on (the plain K1-K3) and, for FPN, dropout: the
losses of both steps within 1e-5 relative; both ranks' states equal bit
for bit; the first step's parameters where its gradient stands 10x clear
of the two runs' difference within 1e-6. For U-Net also the first step's
rank-averaged gradients within 30x the float32 noise of the one-process
ones (their distance from a float64 step, BatchNorm statistics in float64
too), on the tensors, most of them, where 10x that noise is below a tenth
of their largest gradient: a factor 2, the one the collectives leave
before the mean, moves those by more than 100x; and the running
statistics within the larger of 1e-4 and 10x that noise. (E[x^2] - E[x]^2
in float32 over augmented inputs cancels: the split sums of two ranks
moved a gradient by 8x the noise here and by 7-15x on the card; FPN's
GroupNorm runs in float32 whatever its input, so it has no float64
step.)

The learning rate is 1e-5, as `test_torch_train_step.py` takes it for
steps in a row: there the steps stay linear."""


from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

import torch_parallel_cases as cases
from volume_segmantics_tpu.data.losses import get_loss_fn as jax_get_loss_fn
from volume_segmantics_tpu.data.losses import (
    weighted_cross_entropy_loss as jax_weighted_cross_entropy_loss,
)
from volume_segmantics_tpu.model.model_2d import (
    create_model_on_device as jax_create_model_on_device,
)
from volume_segmantics_tpu.model.operations.vol_seg_2d_trainer import _freeze_mask
from volume_segmantics_tpu.models.torch_export import (
    smp_state_dict_from_variables as jax_smp_state_dict,
)
from volume_segmantics_tpu.parallel.mesh import get_mesh as jax_get_mesh
from volume_segmantics_tpu.parallel.train import build_dp_train_step
from volume_segmantics_tpu.parallel.train import (
    make_base_optimizer as jax_make_base_optimizer,
)
from volume_segmantics_tpu.utils.base_data_utils import ModelType as JaxModelType
from volume_segmantics_tpu_torch.models.registry import create_model
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
)
from volume_segmantics_tpu_torch.parallel.mesh import Mesh, spawn_ranks

torch.set_num_threads(cases.THREADS)

S, GLOBAL, RANKS, LR, STEPS = 64, 4, 2, 1e-5, 2
STRUC = {"type": "U_NET", "encoder_name": "resnet34", "encoder_weights": None,
         "in_channels": 1, "classes": 2}
FPN = dict(STRUC, type="FPN")
SELF_CASES = {"unet_augment": STRUC, "fpn_augment_dropout": FPN}


def jax_loss_fn(name):
    if name == "WeightedCrossEntropy":
        return lambda logits, tgt: jax_weighted_cross_entropy_loss(
            logits, tgt.argmax(axis=1))
    return jax_get_loss_fn(SimpleNamespace(loss_criterion=name, alpha=0.75,
                                           beta=0.25))


def numpy_tree(variables):
    return jax.tree_util.tree_map(np.array, serialization.to_state_dict(variables))


def make_runs(tmp, jax_losses, self_cases):
    """Both ranks' runs of each case: `jax_losses` frozen and unfrozen
    (augmentation off), then `self_cases` (augmentation on), with the
    cases and the JAX model."""
    bundle = jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(0),
        dtype=jnp.float32)
    state = smp_state_dict_from_variables(numpy_tree(bundle.variables), STRUC)
    torch.manual_seed(3)
    fpn_state = create_model(FPN).state_dict()
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (GLOBAL, S, S), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    all_cases = [dict(struc=STRUC, state=state, loss=loss, frozen=frozen,
                      augment=False, lr=LR, steps=STEPS, seed=0)
                 for loss in jax_losses for frozen in (True, False)]
    all_cases += [dict(struc=SELF_CASES[name],
                       state=fpn_state if SELF_CASES[name] is FPN else state,
                       loss="DiceLoss", frozen=False, augment=True, lr=LR,
                       steps=STEPS, seed=11, name=name)
                  for name in self_cases]
    torch.save({"images": images, "masks": masks, "cases": all_cases},
               tmp / "in.pt")
    spawn_ranks(cases.train_cases_rank, RANKS, args=(str(tmp / "in.pt"), str(tmp)),
                timeout=cases.TIMEOUT_S)
    ranks = []
    for r in range(RANKS):
        ranks.append(torch.load(tmp / f"rank{r}.pt", weights_only=False))
        (tmp / f"rank{r}.pt").unlink()
    (tmp / "in.pt").unlink()
    return SimpleNamespace(bundle=bundle, images=images, masks=masks,
                           cases=all_cases, ranks=ranks)


def jax_steps(bundle, images, masks, loss, frozen, n_devices=RANKS):
    """JAX's DP step on the mesh of its first `n_devices` devices (2 by
    default), STEPS times: the losses and the state_dict after each
    step."""
    tx = jax_make_base_optimizer(0.01)
    params = jax.tree_util.tree_map(jnp.array, bundle.params)
    batch_stats = jax.tree_util.tree_map(jnp.array, bundle.batch_stats)
    opt_state = tx.init(params)
    step = build_dp_train_step(
        bundle.module, jax_loss_fn(loss), tx, _freeze_mask(params, frozen),
        num_labels=2, image_size=S, mesh=jax_get_mesh(n_devices),
        compute_dtype=jnp.float32, augment=False)
    losses, states = [], []
    for _ in range(STEPS):
        params, batch_stats, opt_state, value = step(
            params, batch_stats, opt_state, jnp.asarray(images),
            jnp.asarray(masks), LR, jax.random.PRNGKey(1))
        losses.append(float(value))
        states.append(jax_smp_state_dict(
            {"params": params, "batch_stats": batch_stats},
            dict(STRUC, type=JaxModelType.U_NET)))
    return losses, states


def float64_grads(struc, state, images, masks, loss):
    """The gradients of the global batch's loss in float64, train mode."""
    model = create_model(struc)
    model.load_state_dict(state)
    model = model.double().train()
    x = torch.from_numpy(images).double() / 255.0
    x = ((x - 0.449) / 0.226)[:, None]
    targets = torch.nn.functional.one_hot(
        torch.from_numpy(masks).long(), 2).permute(0, 3, 1, 2).double()
    cases.loss_fn(loss)(model(x), targets).backward()
    return {n: p.grad for n, p in model.named_parameters()}



def assert_matches_jax(runs, loss, frozen):
    """(a) of the module doc for one case."""
    i = next(k for k, c in enumerate(runs.cases)
             if c["loss"] == loss and c["frozen"] == frozen and not c["augment"])
    case, got = runs.cases[i], runs.ranks[0][i]
    assert runs.ranks[1][i]["digest"] == got["digest"]
    assert got["frozen_kept"]
    initial = case["state"]
    ref_losses, ref_states = jax_steps(runs.bundle, runs.images, runs.masks,
                                       loss, frozen)
    one = cases.train_run(case, runs.images, runs.masks, Mesh())
    one_err = np.abs(np.subtract(one["losses"], ref_losses))
    np.testing.assert_array_less(np.abs(np.subtract(got["losses"], ref_losses)),
                                 np.maximum(1e-5, 2 * one_err))
    grads64 = float64_grads(STRUC, initial, runs.images, runs.masks, loss)
    n_updated = n_trainable = 0
    for name in initial:
        if name not in grads64:
            continue  # a buffer
        if name not in got["params1"]:
            assert frozen, name
            for k in range(STEPS):  # JAX's frozen leaves keep their bits too
                np.testing.assert_array_equal(ref_states[k][name],
                                              initial[name].numpy(), name)
            continue
        # The floor from the one-process float32 gradients, as the
        # one-device test measures it.
        g = one["grads"][0][name].abs()
        noise = (one["grads"][0][name].double() - grads64[name]).abs().max().item()
        moved = g >= max(1e-6, 10 * noise)
        np.testing.assert_allclose(got["params1"][name][moved].numpy(),
                                   ref_states[0][name][moved.numpy()],
                                   atol=1e-6, rtol=0, err_msg=name)
        n_updated += int(moved.sum())
        n_trainable += g.numel()
    assert n_updated > 0.25 * n_trainable, (n_updated, n_trainable)
    for k in range(STEPS):
        for name, value in got["stats"][k].items():
            one_err = np.abs(one["stats"][k][name].numpy()
                             - ref_states[k][name]).max()
            np.testing.assert_allclose(value.numpy(), ref_states[k][name],
                                       atol=max(1e-4, 2 * one_err), rtol=0,
                                       err_msg=name)


def assert_matches_one_process(runs, name):
    """(b) of the module doc for one case (compared in rank 0's process:
    `torch_parallel_cases.against_one_process`)."""
    i = next(k for k, c in enumerate(runs.cases) if c.get("name") == name)
    got, other = runs.ranks[0][i], runs.ranks[1][i]
    np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=1e-5)
    assert other["losses"] == got["losses"]
    assert other["digest"] == got["digest"]
    if name != "fpn_augment_dropout":  # no float64 FPN (its GroupNorm)
        assert got["grad_ratio"] <= 3.0, got
        assert got["n_quiet"] > 0.5 * got["n_tensors"], got
        assert got["stats_ratio"] <= 1.0, got
    assert got["param_err"] <= 1e-6, got
    assert got["n_clear"] > 0.25 * got["n_trainable"], (got["n_clear"],
                                                        got["n_trainable"])
