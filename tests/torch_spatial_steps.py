"""Shared parts of the spatial train step tests
(`test_torch_spatial_step*.py`): the ranks' runs of the port
(`torch_parallel_cases.train_cases_rank` over a (data, space) mesh), the
JAX package's step on `get_mesh(n_devices, space)` and the checks.

Against JAX (augmentation off: the port draws its augmentation from torch
generators, not JAX keys): held to the tolerances the data-parallel tests
take from the one-device test (`torch_parallel_steps.py`, (a)): the loss
within 1e-5 or twice the port's own one-process distance from JAX; after
the step every updated parameter above the float64 gradient-noise floor
within 1e-6 or twice the one-process step's distance from JAX there, the
frozen ones bit for bit; the running statistics within the larger of 1e-4
and twice the one-process distance. Both ranks' (all four ranks') states
equal bit for bit. (At 96x96 JAX's own float32 gradients, on the XLA
CPU backend, lie far from its float64 ones: 1.6e-3 in
`encoder.layer3.4.conv1.weight`, whose largest is 2.0e-3; at 64x64 they
are within 5x the port's float32 noise. So at 96x96 the port's
one-process step already takes 56 Adam updates of that tensor with the
other sign than JAX, and the spatial step is held to it there. The
spatial step against the one-process step and float64 is the augmented
case.)

Against the port's one-process step with augmentation on: as
`torch_parallel_steps.assert_matches_one_process`."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parallel_cases as cases
from torch_parallel_steps import (
    STRUC,
    float64_grads,
    jax_loss_fn,
    numpy_tree,
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
from volume_segmantics_tpu_torch.models.torch_export import (
    smp_state_dict_from_variables,
)
from volume_segmantics_tpu_torch.parallel.mesh import Mesh, spawn_ranks

LR = 1e-5


def jax_bundle():
    return jax_create_model_on_device(
        0, dict(STRUC, type=JaxModelType.U_NET), rng=jax.random.PRNGKey(0),
        dtype=jnp.float32)


def batch(n, size, seed=7):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size), dtype=np.uint8)
    return images, (images > 128).astype(np.uint8)


def run_ranks(tmp, world, space, cases_list, images, masks):
    """`cases_list` over `world` gloo ranks split into `space` partitions:
    each rank's results (`torch_parallel_cases.train_cases_rank`)."""
    torch.save({"images": images, "masks": masks, "cases": cases_list,
                "space": space}, tmp / "in.pt")
    spawn_ranks(cases.train_cases_rank, world,
                args=(str(tmp / "in.pt"), str(tmp)), timeout=cases.TIMEOUT_S)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def jax_case(bundle, frozen, steps=1):
    """A case of `train_cases_rank` against JAX: DiceLoss, augmentation
    off, from the JAX model's weights."""
    state = smp_state_dict_from_variables(numpy_tree(bundle.variables), STRUC)
    return dict(struc=STRUC, state=state, loss="DiceLoss", frozen=frozen,
                augment=False, lr=LR, steps=steps, seed=0)


def jax_step(bundle, images, masks, frozen, n_devices, space):
    """JAX's step on `get_mesh(n_devices, space)`: its loss and state_dict."""
    tx = jax_make_base_optimizer(0.01)
    params = jax.tree_util.tree_map(jnp.array, bundle.params)
    batch_stats = jax.tree_util.tree_map(jnp.array, bundle.batch_stats)
    step = build_dp_train_step(
        bundle.module, jax_loss_fn("DiceLoss"), tx, _freeze_mask(params, frozen),
        num_labels=2, image_size=images.shape[-1],
        mesh=jax_get_mesh(n_devices, space=space), compute_dtype=jnp.float32,
        augment=False)
    params, batch_stats, _, loss = step(
        params, batch_stats, tx.init(params), jnp.asarray(images),
        jnp.asarray(masks), LR, jax.random.PRNGKey(1))
    return float(loss), jax_smp_state_dict(
        {"params": params, "batch_stats": batch_stats},
        dict(STRUC, type=JaxModelType.U_NET))


def assert_step_matches_jax(ranks, i, case, images, masks, ref_loss, ref_state,
                            covered=0.25):
    """The check of the module doc for case `i` of the ranks' runs; more
    than `covered` of the trainable elements must stand above the noise
    floor and be compared."""
    got = ranks[0][i]
    assert all(r[i]["digest"] == got["digest"] for r in ranks)
    assert got["frozen_kept"]
    one = cases.train_run(case, images, masks, Mesh())
    one_err = abs(one["losses"][0] - ref_loss)
    assert abs(got["losses"][0] - ref_loss) <= max(1e-5, 2 * one_err), (
        got["losses"], ref_loss, one["losses"])
    grads64 = float64_grads(STRUC, case["state"], images, masks, "DiceLoss")
    n_updated = n_trainable = 0
    for name in case["state"]:
        if name not in grads64:
            continue  # a buffer
        if name not in got["params1"]:
            assert case["frozen"], name
            np.testing.assert_array_equal(ref_state[name],
                                          case["state"][name].numpy(), name)
            continue
        g = one["grads"][0][name].abs()
        noise = (one["grads"][0][name].double() - grads64[name]).abs().max().item()
        moved = (g >= max(1e-6, 10 * noise)).numpy()
        one_err = np.abs(one["params1"][name].numpy() - ref_state[name])[moved]
        err = np.abs(got["params1"][name].numpy() - ref_state[name])[moved]
        np.testing.assert_array_less(err, np.maximum(1e-6, 2 * one_err),
                                     err_msg=name)
        n_updated += int(moved.sum())
        n_trainable += g.numel()
    assert n_updated > covered * n_trainable, (n_updated, n_trainable)
    for name, value in got["stats"][0].items():
        one_err = np.abs(one["stats"][0][name].numpy() - ref_state[name]).max()
        np.testing.assert_allclose(value.numpy(), ref_state[name],
                                   atol=max(1e-4, 2 * one_err), rtol=0,
                                   err_msg=name)


def self_case(struc, seed=11, steps=2):
    """A case of `train_cases_rank` against the port's one-process step:
    augmentation on, DiceLoss, seeded random weights."""
    from volume_segmantics_tpu_torch.models.registry import create_model

    torch.manual_seed(seed)
    return dict(struc=struc, state=create_model(struc).state_dict(),
                loss="DiceLoss", frozen=False, augment=True, lr=LR,
                steps=steps, seed=seed, name=f"{struc['type']}-"
                f"{struc['encoder_name']}")


def assert_matches_one_process(ranks, i, float64=True):
    """`torch_parallel_steps.assert_matches_one_process` for case `i`, over
    every rank; without `float64` the gradients and statistics are held
    only through the parameters and losses."""
    got = ranks[0][i]
    np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=1e-5)
    for r in ranks[1:]:
        assert r[i]["losses"] == got["losses"]
        assert r[i]["digest"] == got["digest"]
    if float64:
        assert got["grad_ratio"] <= 3.0, got
        assert got["n_quiet"] > 0.5 * got["n_tensors"], got
        assert got["stats_ratio"] <= 1.0, got
    assert got["param_err"] <= 1e-6, got
    assert got["n_clear"] > 0.25 * got["n_trainable"], (got["n_clear"],
                                                        got["n_trainable"])


def eval_blob(bundle, images, masks, n_valid, space):
    return {"struc": STRUC, "images": images, "masks": masks,
            "n_valid": n_valid, "space": space,
            "state": smp_state_dict_from_variables(
                numpy_tree(bundle.variables), STRUC)}

