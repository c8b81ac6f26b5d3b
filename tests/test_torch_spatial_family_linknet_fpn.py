"""LinkNet and FPN under spatial partitioning over 1 data x 2 space gloo
ranks on the CPU (`torch_spatial_families.py` holds the checks and
tolerances): the eval step of every pair with each of the seven encoders
against one process; one train step of LinkNet/ResNet-34 and of
FPN/ResNet-34 (channelwise dropout, GroupNorm over the space group)
against one process, and FPN/ResNet-34's train and eval steps at 62x62,
whose x4 head leaves 64x64 logits that it resizes back with half-pixel
centres, row-sharded; FPN/ResNet-34's eval step against the JAX
package's own on `get_mesh(n_devices=2, space=2)`."""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_families as families

torch.set_num_threads(cases.THREADS)

TRAIN = [("LINKNET", "resnet34"), ("FPN", "resnet34"),
         ("FPN", "resnet34", 62)]
EVAL = families.built_pairs("LINKNET", "FPN") + [("FPN", "resnet34", 62)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return families.run_family(tmp_path_factory.mktemp("family"), TRAIN, EVAL)


@pytest.mark.parametrize("i", range(len(TRAIN)),
                         ids=[families.pair_id(p) for p in TRAIN])
def test_spatial_train_step_matches_one_process(ranks, i):
    families.assert_train_matches(ranks, i)


@pytest.mark.parametrize("i", range(len(EVAL)),
                         ids=[families.pair_id(p) for p in EVAL])
def test_spatial_eval_step_matches_one_process(ranks, i):
    families.assert_eval_matches(ranks, i)


def test_fpn_spatial_eval_step_matches_jax_spatial_eval_step(tmp_path):
    ours, ref = families.jax_eval("FPN", tmp_path)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=families.JAX_TOL)
