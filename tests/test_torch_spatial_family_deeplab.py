"""DeepLabV3 and DeepLabV3+ under spatial partitioning over 1 data x 2
space gloo ranks on the CPU (`torch_spatial_families.py` holds the
checks and tolerances): the eval step of every pair with each of the
seven encoders (output stride 8 and 16: dilated stages) against one
process; one train step of each on ResNet-34 (ASPP's dilations 12-36
past every band, the image pool's BatchNorm on a value every rank holds,
elementwise dropout drawn for the global image) against one process;
DeepLabV3/ResNet-34's train (augmented, on 4 samples) and eval steps at
60x60, whose x8 head leaves 64x64 logits that it resizes back with
half-pixel centres, row-sharded, against one process;
DeepLabV3+/ResNet-34's eval step at 64x64, and DeepLabV3/ResNet-34's at
60x60, against the JAX package's own on `get_mesh(n_devices=2,
space=2)`."""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_families as families

torch.set_num_threads(cases.THREADS)

TRAIN = [("DEEPLABV3", "resnet34"), ("DEEPLABV3_PLUS", "resnet34"),
         ("DEEPLABV3", "resnet34", 60)]
# DeepLabV3 at 60x60 trains augmented on a global batch of 4: on 2 samples
# the image pool's BatchNorm (one pooled value a sample) put the one
# process's own float32 gradients up to 7e-3 from float64 (30x their
# distance at 64x64), and 0.2% of the elements stood clear of the two
# runs' difference; on 4 samples 24% do.
BATCHES = {("DEEPLABV3", "resnet34", 60): 4}
EVAL = (families.built_pairs("DEEPLABV3", "DEEPLABV3_PLUS")
        + [("DEEPLABV3", "resnet34", 60)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return families.run_family(tmp_path_factory.mktemp("family"), TRAIN, EVAL,
                               batches=BATCHES)


@pytest.mark.parametrize("i", range(len(TRAIN)),
                         ids=[families.pair_id(p) for p in TRAIN])
def test_spatial_train_step_matches_one_process(ranks, i):
    families.assert_train_matches(ranks, i)


@pytest.mark.parametrize("i", range(len(EVAL)),
                         ids=[families.pair_id(p) for p in EVAL])
def test_spatial_eval_step_matches_one_process(ranks, i):
    families.assert_eval_matches(ranks, i)


def test_deeplabv3_plus_spatial_eval_step_matches_jax_spatial_eval_step(
        tmp_path):
    ours, ref = families.jax_eval("DEEPLABV3_PLUS", tmp_path)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=families.JAX_TOL)


def test_deeplabv3_head_resize_spatial_eval_step_matches_jax_spatial_eval_step(
        tmp_path):
    ours, ref = families.jax_eval("DEEPLABV3", tmp_path, side=60)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=families.JAX_TOL)
