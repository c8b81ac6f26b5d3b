"""DeepLabV3 and DeepLabV3+ decoders with smp submodule names, NCHW (port
of the JAX package's `models/decoders/deeplab.py`).

- ASPP (`convs`, `project`): a 1x1 branch, three 3x3 branches at rates
  12/24/36 (depthwise-separable for V3+), and an image-pool branch (global
  mean, 1x1 conv + BN + ReLU over N x 1 x 1 values, broadcast back); the
  five concatenated, projected by a 1x1 conv + BN + ReLU, then dropout 0.5.
- DeepLabV3 (`decoder.{0,1,2}`): ASPP on the output-stride-8 feature, then
  conv3x3 + BN + ReLU; the head upsamples x8.
- DeepLabV3+ (`decoder.aspp`, `block1`, `block2`): separable ASPP on the
  output-stride-16 feature and a separable conv3x3, an align-corners
  bilinear resize to stride 4, concatenated with a 48-channel 1x1 of the
  stride-4 feature, fused by a separable conv3x3; the head upsamples x4.
"""

from typing import Sequence

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.layers import (
    BnAct,
    Conv2d,
    ConvBnAct,
    Dropout,
    Pooled,
    image_size,
    resize_align_corners,
)


OUT_CHANNELS = 256
ATROUS_RATES = (12, 24, 36)
HIGHRES_CHANNELS = 48
ASPP_DROPOUT = 0.5


def separable_conv(in_ch: int, out_ch: int, dilation: int = 1):
    """smp SeparableConv2d: depthwise 3x3 (padding = dilation), then a
    pointwise 1x1, both without bias."""
    return nn.Sequential(
        Conv2d(in_ch, in_ch, 3, padding=dilation, dilation=dilation,
               groups=in_ch, bias=False),
        Conv2d(in_ch, out_ch, 1, bias=False),
    )


class ASPP(nn.Module):
    def __init__(self, in_ch: int, separable: bool = False):
        super().__init__()
        out_ch = OUT_CHANNELS
        branches = [ConvBnAct(in_ch, out_ch, 1)]
        for rate in ATROUS_RATES:
            if separable:
                branches.append(nn.Sequential(
                    separable_conv(in_ch, out_ch, rate), BnAct(out_ch)))
            else:
                branches.append(ConvBnAct(in_ch, out_ch, 3, dilation=rate))
        branches.append(Pooled(Conv2d(in_ch, out_ch, 1, bias=False),
                               BnAct(out_ch)))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(
            Conv2d(len(branches) * out_ch, out_ch, 1, bias=False),
            BnAct(out_ch), Dropout(ASPP_DROPOUT))

    def forward(self, x):
        res = [branch(x) for branch in self.convs[:-1]]
        pooled = self.convs[-1](x)
        res.append(pooled.expand(-1, -1, x.shape[2], x.shape[3])
                   .to(res[0].dtype))
        return self.project(torch.cat(res, dim=1))


class DeepLabV3Decoder(nn.Sequential):
    out_channels = OUT_CHANNELS

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__(
            ASPP(encoder_channels[-1]),
            Conv2d(OUT_CHANNELS, OUT_CHANNELS, 3, padding=1, bias=False),
            BnAct(OUT_CHANNELS),
        )

    def forward(self, features):
        return super().forward(features[-1])


class DeepLabV3PlusDecoder(nn.Module):
    out_channels = OUT_CHANNELS

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        self.aspp = nn.Sequential(
            ASPP(encoder_channels[-1], separable=True),
            separable_conv(OUT_CHANNELS, OUT_CHANNELS),
            BnAct(OUT_CHANNELS),
        )
        self.block1 = ConvBnAct(encoder_channels[-4], HIGHRES_CHANNELS, 1)
        self.block2 = nn.Sequential(
            separable_conv(OUT_CHANNELS + HIGHRES_CHANNELS, OUT_CHANNELS),
            BnAct(OUT_CHANNELS))

    def forward(self, features):
        x = self.aspp(features[-1])
        high = features[-4]  # stride 4
        x = resize_align_corners(x, *image_size(high))
        high = self.block1(high)
        return self.block2(torch.cat([x, high.to(x.dtype)], dim=1))
