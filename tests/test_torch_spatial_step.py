"""The port's spatial train and eval steps over 1 data x 2 space gloo
ranks on the CPU (`parallel/train.py` over `parallel/spatial.py`), U-Net/
ResNet-34 at 64x64, float32, global batch 2: one step, unfrozen and
frozen, against the JAX package's `build_dp_train_step` on
`get_mesh(n_devices=2, space=2)`; the eval step with a padded tail against
JAX's on the same mesh (loss and MeanIoU within 1e-5, the one-device
test's tolerance); and, augmentation on (the plain K1-K3), two steps
against the port's one-process step from the same weights and seeds. The
checks and tolerances are `torch_spatial_steps.py`'s."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_steps as steps
from torch_parallel_steps import STRUC
from volume_segmantics_tpu.data.losses import get_loss_fn as jax_get_loss_fn
from volume_segmantics_tpu.data.metrics import mean_iou as jax_mean_iou
from volume_segmantics_tpu.parallel.mesh import get_mesh as jax_get_mesh
from volume_segmantics_tpu.parallel.train import build_dp_eval_step
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(cases.THREADS)

S, GLOBAL = 64, 2


@pytest.fixture(scope="module")
def bundle():
    return steps.jax_bundle()


@pytest.fixture(scope="module")
def runs(bundle, tmp_path_factory):
    images, masks = steps.batch(GLOBAL, S)
    all_cases = [steps.jax_case(bundle, frozen) for frozen in (False, True)]
    all_cases.append(steps.self_case(STRUC))
    ranks = steps.run_ranks(tmp_path_factory.mktemp("spatial_step"), 2, 2,
                            all_cases, images, masks)
    return SimpleNamespace(cases=all_cases, ranks=ranks, images=images,
                           masks=masks)


@pytest.mark.parametrize("frozen", [False, True], ids=["unfrozen", "frozen"])
def test_one_by_two_step_matches_jax_spatial_step(bundle, runs, frozen):
    i = int(frozen)
    ref_loss, ref_state = steps.jax_step(bundle, runs.images, runs.masks,
                                         frozen, n_devices=2, space=2)
    steps.assert_step_matches_jax(runs.ranks, i, runs.cases[i], runs.images,
                                  runs.masks, ref_loss, ref_state)


def test_one_by_two_step_with_augmentation_matches_one_process(runs):
    steps.assert_matches_one_process(runs.ranks, 2)


def test_one_by_two_eval_step_matches_jax_spatial_eval_step(bundle, tmp_path):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (4, S, S), dtype=np.uint8)
    masks = (images > 128).astype(np.uint8)
    ref_loss, ref_score = build_dp_eval_step(
        bundle.module, jax_get_loss_fn(SimpleNamespace(loss_criterion="DiceLoss")),
        jax_mean_iou, num_labels=2, mesh=jax_get_mesh(2, space=2),
        compute_dtype=jnp.float32,
    )(bundle.params, bundle.batch_stats, jnp.asarray(images), jnp.asarray(masks), 3)
    torch.save(steps.eval_blob(bundle, images, masks, 3, space=2),
               tmp_path / "in.pt")
    spawn_ranks(cases.eval_rank, 2, args=(str(tmp_path / "in.pt"), str(tmp_path)),
                timeout=cases.TIMEOUT_S)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0]["loss"], float(ref_loss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["score"], float(ref_score), atol=1e-5,
                               rtol=0)
    assert jax.device_count() == 8
