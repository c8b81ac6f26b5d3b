"""The port's data-parallel train step over 2 gloo ranks on the CPU
(`parallel/train.py:build_dp_train_step`, each rank a process of its own
taking its 2 rows of a global batch of 4; S=64, U-Net/ResNet-34, float32):
(a) with DiceLoss against the JAX package's `build_dp_train_step` on a
2-device mesh, frozen and unfrozen; (b) against the port's one-process
step with augmentation and FPN dropout on. The checks and tolerances are
`torch_parallel_steps.py`'s."""

import pytest

from torch_parallel_steps import (
    assert_matches_jax,
    assert_matches_one_process,
    make_runs,
)

LOSSES = ('DiceLoss',)
SELF = ('unet_augment', 'fpn_augment_dropout')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory.mktemp("dp_step"), LOSSES, SELF)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("loss", LOSSES)
def test_two_rank_step_matches_jax_dp_step(runs, loss, frozen):
    assert_matches_jax(runs, loss, frozen)


@pytest.mark.parametrize("name", SELF)
def test_two_rank_step_matches_one_process(runs, name):
    assert_matches_one_process(runs, name)
