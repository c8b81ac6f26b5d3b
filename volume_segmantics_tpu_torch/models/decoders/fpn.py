"""FPN decoder with smp submodule names, NCHW (port of the JAX package's
`models/decoders/fpn.py`).

1x1 laterals with bias (`decoder.p5`, `decoder.p{4,3,2}.skip_conv`) and a
nearest x2 top-down path at 256 channels; per level a segmentation block
(`decoder.seg_blocks.{i}.block.{j}.block`: conv3x3, GroupNorm(32, eps
1e-5) in float32, ReLU, cast back to the conv's dtype where the JAX
decoder casts, then a nearest x2 upsample while the level is above stride
4) at 128 channels; the four levels summed, then channel-wise dropout 0.2.
The output sits at stride 4; the head upsamples x4.
"""

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from volume_segmantics_tpu_torch.models.layers import (
    Conv2d,
    Dropout,
    GroupNorm,
    upsample,
)

PYRAMID_CHANNELS = 256
SEGMENTATION_CHANNELS = 128
DROPOUT = 0.2


class Conv3x3GNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, do_upsample: bool):
        super().__init__()
        self.do_upsample = do_upsample
        self.block = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            GroupNorm(32, out_ch, eps=1e-5),
        )

    def forward(self, x):
        conv, gn = self.block
        x = conv(x)
        x = F.relu(gn(x.float())).to(x.dtype)
        return upsample(x, 2) if self.do_upsample else x


class SegmentationBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_upsamples: int):
        super().__init__()
        self.block = nn.Sequential(
            Conv3x3GNReLU(in_ch, out_ch, bool(n_upsamples)),
            *(Conv3x3GNReLU(out_ch, out_ch, True)
              for _ in range(1, n_upsamples)),
        )

    def forward(self, x):
        return self.block(x)


class FPNBlock(nn.Module):
    def __init__(self, pyramid_ch: int, skip_ch: int):
        super().__init__()
        self.skip_conv = Conv2d(skip_ch, pyramid_ch, 1)

    def forward(self, x, skip):
        return upsample(x, 2) + self.skip_conv(skip)


class FPNDecoder(nn.Module):
    out_channels = SEGMENTATION_CHANNELS

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        c2, c3, c4, c5 = encoder_channels[-4:]
        self.p5 = Conv2d(c5, PYRAMID_CHANNELS, 1)
        self.p4 = FPNBlock(PYRAMID_CHANNELS, c4)
        self.p3 = FPNBlock(PYRAMID_CHANNELS, c3)
        self.p2 = FPNBlock(PYRAMID_CHANNELS, c2)
        self.seg_blocks = nn.ModuleList(
            SegmentationBlock(PYRAMID_CHANNELS, SEGMENTATION_CHANNELS, n)
            for n in (3, 2, 1, 0)
        )
        self.dropout = Dropout(DROPOUT, channelwise=True)

    def forward(self, features):
        c2, c3, c4, c5 = features[-4:]
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        out = None
        for block, p in zip(self.seg_blocks, (p5, p4, p3, p2)):
            s = block(p)
            out = s if out is None else out + s
        return self.dropout(out)
