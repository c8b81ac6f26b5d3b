"""U-Net++ decoder with smp submodule names, NCHW (port of the JAX
package's `models/decoders/unetpp.py`).

The dense grid of blocks `x_{a}_{b}` (b the dense level, b - a the column)
sits in `decoder.blocks`. Each block is U-Net's: nearest x2 upsample ->
concat -> 2x (conv3x3 + BN + ReLU). Nodes with a == 0 emit
`decoder_channels[b]`; interior nodes keep their level's encoder-skip
width. The concat order is smp's: up2(x), the same-level nodes newest
first, then the encoder skip; the last node `x_0_4` has no skip.
"""

from typing import Sequence

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.decoders.unet import (
    DECODER_CHANNELS,
    UnetDecoderBlock,
)


class UnetPlusPlusDecoder(nn.Module):
    out_channels = DECODER_CHANNELS[-1]

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first
        self.depth = depth = len(enc) - 1
        skip_ch = enc[1:] + [0]
        out_ch, blocks = {}, {}
        for layer in range(depth):
            for a in range(depth - layer):
                b = a + layer
                if layer == 0:
                    in_ch, skips = enc[a], enc[a + 1]
                else:
                    in_ch = out_ch[(a, b - 1)]
                    skips = sum(out_ch[(i, b)] for i in range(a + 1, b + 1))
                    skips += enc[b + 1]
                out_ch[(a, b)] = DECODER_CHANNELS[b] if a == 0 else skip_ch[b]
                blocks[f"x_{a}_{b}"] = UnetDecoderBlock(in_ch, skips,
                                                        out_ch[(a, b)])
        blocks[f"x_0_{depth}"] = UnetDecoderBlock(
            out_ch[(0, depth - 1)], 0, DECODER_CHANNELS[-1])
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, features):
        feats = features[1:][::-1]  # deepest first
        depth = self.depth
        dense = {}
        for layer in range(depth):
            for a in range(depth - layer):
                b = a + layer
                if layer == 0:
                    x, skips = feats[a], [feats[a + 1]]
                else:
                    x = dense[(a, b - 1)]
                    skips = [dense[(i, b)] for i in range(a + 1, b + 1)]
                    skips.append(feats[b + 1])
                dense[(a, b)] = self.blocks[f"x_{a}_{b}"](
                    x, torch.cat(skips, dim=1))
        return self.blocks[f"x_0_{depth}"](dense[(0, depth - 1)])
