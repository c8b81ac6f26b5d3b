"""EfficientNet-B3 and -B4 (TF-"SAME" depthwise convs, squeeze-excite,
SiLU, BatchNorm eps 1e-3) in the port against the JAX package, the smp
oracle and lukemelas' key set, inert tail included (the cases are in
tests/torch_encoder_cases.py); DeepLabV3+ on B3; every decoder on both, by
shape; and the TF-"SAME" convolution against its rule."""

import math

import pytest
import torch
import torch.nn.functional as F

from torch_encoder_cases import *  # noqa: F401,F403
from torch_encoder_cases import DECODERS, check_deeplabv3plus_logits, check_pair
from volume_segmantics_tpu_torch.models.layers import SameConv2d

NAMES = ("efficientnet-b3", "efficientnet-b4")


@pytest.fixture(scope="module", params=NAMES)
def encoder(request):
    return request.param


@pytest.mark.parametrize("encoder_name,mtype",
                         [(e, d) for e in NAMES for d in DECODERS])
def test_pair_matches_jax_shapes(encoder_name, mtype):
    check_pair(encoder_name, mtype)


def test_deeplabv3plus_logits_match_jax_and_oracle():
    check_deeplabv3plus_logits("efficientnet-b3")


@pytest.mark.parametrize("size,k,stride,dilation", [
    (64, 3, 2, 1), (33, 3, 2, 1), (64, 5, 2, 1), (31, 5, 1, 2), (16, 3, 1, 4),
])
def test_same_conv_pads_as_tf(size, k, stride, dilation):
    """Total padding (ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, its
    smaller half first: equal to an explicit pad and an unpadded conv."""
    torch.manual_seed(0)
    conv = SameConv2d(3, 4, k, stride, dilation)
    x = torch.randn(1, 3, size, size + 1)
    pads = []
    for n in (size + 1, size):  # F.pad order: W, then H
        total = max((math.ceil(n / stride) - 1) * stride
                    + (k - 1) * dilation + 1 - n, 0)
        pads += [total // 2, total - total // 2]
    ref = F.conv2d(F.pad(x, pads), conv.weight, None, stride, 0, dilation)
    got = conv(x)
    assert got.shape[2:] == (math.ceil(size / stride),
                             math.ceil((size + 1) / stride))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
