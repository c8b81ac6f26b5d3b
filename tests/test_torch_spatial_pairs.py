"""The other five (decoder, encoder) pairs that spatial partitioning takes
(U-Net on ResNet-50 and ResNeXt-50 32x4d, U-Net++ on ResNet-34, ResNet-50
and ResNeXt-50 32x4d) over 1 data x 2 space gloo ranks on the CPU (64x64,
float32, global batch 2, seeded random weights), against the port's
one-process steps on the global batch:

- the eval step (DiceLoss, MeanIoU; running statistics, so the forward is
  the whole op's up to summation order): loss and score within 1e-6;
- one train step with augmentation on: the loss within 1e-5 relative,
  both ranks' states equal, and the parameters whose gradient stands 10x
  clear of the two runs' difference within 1e-6 of the one-process
  step's, those being at least 5% of the trainable elements (most
  gradients of these random deep encoders at 64x64 are below 1e-6).

Their gradients are not held to a float64 step as U-Net/ResNet-34's are
(`test_torch_spatial_step.py`): in float32 the training statistics
E[x^2] - E[x]^2 cancel, and a one-process step whose BatchNorm sums are
split into the two bands' sums, as the ranks split them, moves U-Net/
ResNeXt-50's gradients by 30-300x the one-process distance from float64
(4e-5 in `decoder.blocks.4.conv2.1.bias`, whose largest is 0.2); the
float64 checks of every row-sharded op are
`test_torch_spatial_primitives.py`'s."""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
import torch_spatial_cases as spatial_cases
import torch_spatial_steps as steps
from volume_segmantics_tpu_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(cases.THREADS)

S, GLOBAL = 64, 2
PAIRS = [("U_NET", "resnet50"), ("U_NET", "resnext50_32x4d"),
         ("U_NET_PLUS_PLUS", "resnet34"), ("U_NET_PLUS_PLUS", "resnet50"),
         ("U_NET_PLUS_PLUS", "resnext50_32x4d")]


def struc(model_type, encoder):
    return {"type": model_type, "encoder_name": encoder,
            "encoder_weights": None, "in_channels": 1, "classes": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    images, masks = steps.batch(GLOBAL, S, seed=8)
    pair_cases = [steps.self_case(struc(*pair), steps=1) for pair in PAIRS]
    tmp = tmp_path_factory.mktemp("pairs")
    torch.save({"images": images, "masks": masks, "cases": pair_cases},
               tmp / "in.pt")
    spawn_ranks(spatial_cases.pairs_rank, 2, args=(str(tmp / "in.pt"), str(tmp)),
                timeout=cases.TIMEOUT_S)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("i", range(len(PAIRS)),
                         ids=[f"{d}-{e}" for d, e in PAIRS])
def test_spatial_step_of_pair_matches_one_process(runs, i):
    got = runs[0][i]
    np.testing.assert_allclose(got["eval"], got["ref_eval"], rtol=0, atol=1e-6)
    assert runs[1][i]["eval"] == got["eval"]
    np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=1e-5)
    assert runs[1][i]["losses"] == got["losses"]
    assert runs[1][i]["digest"] == got["digest"]
    assert got["param_err"] <= 1e-6, got
    assert got["n_clear"] > 0.05 * got["n_trainable"], got
