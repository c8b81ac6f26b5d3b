"""(a) of `torch_parallel_steps.py` with the weighted cross-entropy (class
weights from the global batch's sums): the port's 2-rank data-parallel
train step against the JAX package's on a 2-device mesh, frozen and
unfrozen."""

import pytest

from torch_parallel_steps import assert_matches_jax, make_runs

LOSSES = ('WeightedCrossEntropy',)
SELF = ()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory.mktemp("dp_step"), LOSSES, SELF)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("loss", LOSSES)
def test_two_rank_step_matches_jax_dp_step(runs, loss, frozen):
    assert_matches_jax(runs, loss, frozen)
