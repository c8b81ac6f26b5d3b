"""U-Net decoder with smp submodule names, NCHW (port of the JAX
package's `models/decoders/unet.py`).

5 decoder blocks with channels (256, 128, 64, 32, 16); each block is a
nearest x2 upsample -> concat skip -> 2x (conv3x3 + BN + ReLU). Skips are
the encoder pyramid levels in reverse depth order.
"""

from typing import Sequence

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.layers import ConvBnAct, upsample

DECODER_CHANNELS = (256, 128, 64, 32, 16)


class UnetDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = ConvBnAct(in_ch + skip_ch, out_ch)
        self.conv2 = ConvBnAct(out_ch, out_ch)

    def forward(self, x, skip=None):
        x = upsample(x, 2)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    out_channels = DECODER_CHANNELS[-1]

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first
        in_chs = [enc[0]] + list(DECODER_CHANNELS[:-1])
        skip_chs = enc[1:] + [0]
        self.blocks = nn.ModuleList(
            UnetDecoderBlock(i, s, o)
            for i, s, o in zip(in_chs, skip_chs, DECODER_CHANNELS)
        )

    def forward(self, features):
        # features: [C0(identity), C1(s2), C2(s4), C3(s8), C4(s16), C5(s32)]
        feats = features[1:][::-1]
        x = feats[0]
        skips = feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
