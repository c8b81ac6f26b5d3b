"""PAN and MA-Net under spatial partitioning over 1 data x 2 space gloo
ranks on the CPU (`torch_spatial_families.py` holds the checks and
tolerances): the eval step of every pair that `create_model` builds (PAN
on five encoders: not on a ResNeSt; MA-Net on seven) against one process;
one train step of each on ResNet-34 (PAN's global branches and resizes
to the global h // 4 and h // 2, its 2x2 pool kept at a 1-row map; MA-Net's
position attention on the deepest map gathered whole) against one
process; PAN/ResNet-34's train and eval steps at 62x62, whose x4 head
leaves 64x64 logits that it resizes back with half-pixel centres,
row-sharded, against one process."""

import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_families as families

torch.set_num_threads(cases.THREADS)

TRAIN = [("PAN", "resnet34"), ("MA_NET", "resnet34"),
         ("PAN", "resnet34", 62)]
EVAL = families.built_pairs("PAN", "MA_NET") + [("PAN", "resnet34", 62)]


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
