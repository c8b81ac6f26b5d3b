"""Building blocks of the segmentation models, NCHW (port of the JAX
package's `models/layers.py`: ConvBnAct, BnAct, upsample, max_pool).

The TPU re-expressions of a plain convolution there (space-to-depth stem,
phase-decomposed upsample+conv) are not ported: a plain conv computes the
same function.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator = None):
    """flax's `lecun_normal` initialiser: truncated normal at +-2 std with
    variance 1/fan_in (the std is corrected for the truncation)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


class BnAct(nn.Module):
    """BatchNorm followed by an optional activation, reproducing the JAX
    package's BnAct: batch statistics in float32 with the *biased* variance
    max(0, E[x^2] - E[x]^2), running statistics updated as
    0.9 * old + 0.1 * batch, the normalize in affine form
    x * mul + (bias - mean * mul), and the result cast back to the input's
    dtype. (`nn.BatchNorm2d` keeps the unbiased variance in its running
    statistics, which would drift from the reference.)

    Parameter and buffer names are BatchNorm2d's, so `state_dict()` keys
    are the reference checkpoint's."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, features: int, act: Optional[str] = "relu"):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer(
            "num_batches_tracked", torch.tensor(0, dtype=torch.long)
        )

    def forward(self, x):
        if self.training:
            xf = x.float()
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            mu2 = (xf * xf).mean(dims)
            var = torch.clamp(mu2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(
                    self.momentum * self.running_mean
                    + (1 - self.momentum) * mean
                )
                self.running_var.copy_(
                    self.momentum * self.running_var
                    + (1 - self.momentum) * var
                )
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * mul
        y = x.float() * mul[:, None, None] + shift[:, None, None]
        y = y.to(x.dtype)
        return F.relu(y) if self.act == "relu" else y


class ConvBnAct(nn.Sequential):
    """conv3x3 (no bias) -> BatchNorm -> ReLU, smp's Conv2dReLU: the
    submodules are named `0` (conv) and `1` (BN) as in smp."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, 3, 1, 1, bias=False), BnAct(out_ch),
        )


def upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour integer-factor upsampling, NCHW."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """Max pooling with symmetric padding (torch MaxPool2d(3, 2, 1))."""
    return F.max_pool2d(x, window, stride, padding)


def init_like_flax(module: nn.Module, generator: torch.Generator = None):
    """Initialise every conv as flax does: lecun_normal kernels, zero
    biases; BnAct keeps its ones/zeros. Convs are visited in module order,
    so a seeded generator gives the same weights every time."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    return module
