"""U-Net and U-Net++ on every encoder under spatial partitioning over 1
data x 2 space gloo ranks on the CPU (`torch_spatial_families.py` holds
the checks and tolerances): the eval step of all fourteen pairs against
one process; one train step of U-Net on EfficientNet-B3 and -B4 (TF-SAME
convolutions padded at the global edges, squeeze-excite on the global
mean) and on ResNeSt-50d and -101e (split attention on the global mean,
the average pools) against one process. The global batch is 4 here: on
2 samples ResNeSt's split-attention BatchNorm, over the batch's pooled
values, amplifies float32 rounding until its one-process loss lies
~1e-3 from the float64 one and its gradients are noise."""

import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_families as families

torch.set_num_threads(cases.THREADS)

TRAIN = [("U_NET", "efficientnet-b3"), ("U_NET", "efficientnet-b4"),
         ("U_NET", "timm-resnest50d"), ("U_NET", "timm-resnest101e")]
EVAL = families.built_pairs("U_NET", "U_NET_PLUS_PLUS")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return families.run_family(tmp_path_factory.mktemp("family"), TRAIN, EVAL,
                               n=4)


@pytest.mark.parametrize("i", range(len(TRAIN)),
                         ids=[f"{d}-{e}" for d, e in TRAIN])
def test_spatial_train_step_matches_one_process(ranks, i):
    resnest = "resnest" in TRAIN[i][1]
    families.assert_train_matches(
        ranks, i, families.COVERED_RESNEST if resnest else families.COVERED)


@pytest.mark.parametrize("i", range(len(EVAL)),
                         ids=[f"{d}-{e}" for d, e in EVAL])
def test_spatial_eval_step_matches_one_process(ranks, i):
    families.assert_eval_matches(ranks, i)
