"""LinkNet decoder with smp submodule names, NCHW (port of the JAX
package's `models/decoders/linknet.py`).

Each block `decoder.blocks.{i}.block` is a 1x1 conv + BN + ReLU to a
quarter of its input channels (`0`), a x2 transposed conv (k4, s2, p1, no
bias) + BN + ReLU (`1`), and a 1x1 conv + BN + ReLU to the block's width
(`2`); the encoder skip is ADDED. Widths: the encoder's, reversed, ending
at 32 before the head.

A flax ConvTranspose kernel is not flipped spatially, torch's is: the
weights are carried with the flip (models/torch_export.py).
"""

from typing import Sequence

import torch.nn as nn

from volume_segmantics_tpu_torch.models.layers import (
    BnAct,
    ConvBnAct,
    ConvTranspose2d,
)

PREFINAL_CHANNELS = 32


class LinknetDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        mid = in_ch // 4
        self.block = nn.Sequential(
            ConvBnAct(in_ch, mid, 1),
            nn.Sequential(
                ConvTranspose2d(mid, mid, 4, stride=2, padding=1, bias=False),
                BnAct(mid),
            ),
            ConvBnAct(mid, out_ch, 1),
        )

    def forward(self, x, skip=None):
        x = self.block(x)
        return x if skip is None else x + skip


class LinknetDecoder(nn.Module):
    out_channels = PREFINAL_CHANNELS

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first
        widths = enc[1:] + [PREFINAL_CHANNELS]
        self.blocks = nn.ModuleList(
            LinknetDecoderBlock(i, o) for i, o in zip(enc[:1] + widths, widths)
        )

    def forward(self, features):
        feats = features[1:][::-1]
        x = feats[0]
        skips = feats[1:] + [None]
        for block, skip in zip(self.blocks, skips):
            x = block(x, skip)
        return x
