"""ResNet-50 and ResNeXt-50 32x4d (Bottleneck blocks, a grouped 3x3) in
the port against the JAX package, the smp oracle and torchvision's key set
(the cases are in tests/torch_encoder_cases.py); DeepLabV3+ on ResNet-50;
and every decoder on both, by shape."""

import pytest

from torch_encoder_cases import *  # noqa: F401,F403
from torch_encoder_cases import DECODERS, check_deeplabv3plus_logits, check_pair

NAMES = ("resnet50", "resnext50_32x4d")


@pytest.fixture(scope="module", params=NAMES)
def encoder(request):
    return request.param


@pytest.mark.parametrize("encoder_name,mtype",
                         [(e, d) for e in NAMES for d in DECODERS])
def test_pair_matches_jax_shapes(encoder_name, mtype):
    check_pair(encoder_name, mtype)


def test_deeplabv3plus_logits_match_jax_and_oracle():
    check_deeplabv3plus_logits("resnet50")
