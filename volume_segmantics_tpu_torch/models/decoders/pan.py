"""PAN decoder with smp submodule names, NCHW (port of the JAX package's
`models/decoders/pan.py`).

A feature pyramid attention block (`decoder.fpa`) on the deepest feature
(output stride 16): a global-pool branch, a 1x1 mid branch and a
7x7/5x5/3x3 max-pool pyramid of single-channel attention convs, merged as
mid * attention + global. Then three global attention upsample blocks
(`decoder.gau3/2/1`) against the stride-16, 8 and 4 features, all at 32
channels. Every conv is smp PAN's ConvBnRelu (`conv` with bias, `bn`, ReLU
unless the block says not) and every resize is bilinear with
align_corners=True. The output sits at stride 4; the head upsamples x4.

The JAX decoder's pooling quirk is kept: a 2x2 max-pool leaves its input as
it is once a side is below 2 (where torch would make an empty tensor), so
64-pixel inputs, 4x4 at stride 16, run.
"""

from typing import Sequence

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.layers import (
    BnAct,
    Conv2d,
    Pooled,
    image_size,
    max_pool,
    resize_align_corners,
)

DECODER_CHANNELS = 32


class ConvBnRelu(nn.Module):
    """smp PAN ConvBnRelu: conv (with bias, padding k // 2), BN, ReLU
    unless `add_relu` is False."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 add_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size,
                           padding=kernel_size // 2)
        self.bn = BnAct(out_ch, "relu" if add_relu else None)

    def forward(self, x):
        return self.bn(self.conv(x))


class Pool2(nn.Module):
    """MaxPool2d(2, 2), or x itself once a side of the (global) image is
    below 2 (the JAX decoder's `_pool2`)."""

    def forward(self, x):
        if min(image_size(x)) < 2:
            return x
        return max_pool(x, 2, 2, 0)


class FPABlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.branch1 = Pooled(ConvBnRelu(in_ch, out_ch, 1))
        self.mid = nn.Sequential(ConvBnRelu(in_ch, out_ch, 1))
        self.down1 = nn.Sequential(Pool2(), ConvBnRelu(in_ch, 1, 7))
        self.down2 = nn.Sequential(Pool2(), ConvBnRelu(1, 1, 5))
        self.down3 = nn.Sequential(Pool2(), ConvBnRelu(1, 1, 3),
                                   ConvBnRelu(1, 1, 3))
        self.conv2 = ConvBnRelu(1, 1, 5)
        self.conv1 = ConvBnRelu(1, 1, 7)

    def forward(self, x):
        h, w = image_size(x)
        glob = self.branch1(x)
        mid = self.mid(x)
        x1 = self.down1(x)
        x2 = self.down2(x1)
        x3 = self.down3(x2)
        x3 = resize_align_corners(x3, max(h // 4, 1), max(w // 4, 1))
        att = self.conv2(x2) + x3
        att = resize_align_corners(att, max(h // 2, 1), max(w // 2, 1))
        att = att + self.conv1(x1)
        att = resize_align_corners(att, h, w)
        return mid * att + glob.to(mid.dtype)


class GAUBlock(nn.Module):
    """Low-level features gated by the sigmoid of the high-level
    features' global context, added to the high level resized up."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = Pooled(ConvBnRelu(out_ch, out_ch, 1, add_relu=False))
        self.conv2 = ConvBnRelu(in_ch, out_ch, 3)

    def forward(self, x_low, y_high):
        y_up = resize_align_corners(y_high, *image_size(x_low))
        x = self.conv2(x_low)
        g = torch.sigmoid(self.conv1(y_high)).to(x.dtype)
        return y_up + x * g


class PANDecoder(nn.Module):
    out_channels = DECODER_CHANNELS

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        c2, c3, c4, c5 = encoder_channels[-4:]
        self.fpa = FPABlock(c5, DECODER_CHANNELS)
        self.gau3 = GAUBlock(c4, DECODER_CHANNELS)
        self.gau2 = GAUBlock(c3, DECODER_CHANNELS)
        self.gau1 = GAUBlock(c2, DECODER_CHANNELS)

    def forward(self, features):
        c2, c3, c4, c5 = features[-4:]
        x = self.fpa(c5)
        x = self.gau3(c4, x)
        x = self.gau2(c3, x)
        return self.gau1(c2, x)
