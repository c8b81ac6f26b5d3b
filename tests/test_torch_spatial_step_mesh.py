"""The port's spatial train step against the JAX package's on two more
meshes (`torch_spatial_steps.py` holds the checks): 2 data x 2 space gloo
ranks against `get_mesh(n_devices=4, space=2)` (global batch 4, 64x64),
and 1 data x 2 space at 96x96, whose deepest level is 3 rows, 2 and 1 a
rank, against `get_mesh(n_devices=2, space=2)`. U-Net/ResNet-34, float32,
augmentation off, one unfrozen step. At 96x96 also two steps with
augmentation on against the port's one-process step, the first step's
gradients against float64."""

import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_steps as steps
from torch_parallel_steps import STRUC

torch.set_num_threads(cases.THREADS)

# name: (data, space, image side, global batch, share of the parameters
# compared: at 96x96 the float32 noise floor leaves 24% above it, 64x64
# more than 25% as in the other step tests)
MESHES = {"2x2_64": (2, 2, 64, 4, 0.25), "1x2_96": (1, 2, 96, 2, 0.2)}


@pytest.fixture(scope="module")
def bundle():
    return steps.jax_bundle()


@pytest.fixture(scope="module")
def runs(bundle, tmp_path_factory):
    out = {}
    for name, (data, space, side, n, _) in MESHES.items():
        images, masks = steps.batch(n, side)
        run_cases = [steps.jax_case(bundle, frozen=False)]
        if side == 96:
            run_cases.append(steps.self_case(STRUC))
        out[name] = (run_cases, images, masks, steps.run_ranks(
            tmp_path_factory.mktemp(name), data * space, space, run_cases,
            images, masks))
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_spatial_step_matches_jax_spatial_step(bundle, runs, name):
    data, space, _, _, covered = MESHES[name]
    run_cases, images, masks, ranks = runs[name]
    ref_loss, ref_state = steps.jax_step(bundle, images, masks, False,
                                         n_devices=data * space, space=space)
    steps.assert_step_matches_jax(ranks, 0, run_cases[0], images, masks,
                                  ref_loss, ref_state, covered)


def test_uneven_deepest_level_with_augmentation_matches_one_process(runs):
    steps.assert_matches_one_process(runs["1x2_96"][3], 1)
