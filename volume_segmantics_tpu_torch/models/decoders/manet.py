"""MA-Net decoder with smp submodule names, NCHW (port of the JAX
package's `models/decoders/manet.py`).

A position-wise attention block (`decoder.center`) on the deepest feature,
then a multi-scale fusion attention block per skip (`decoder.blocks.0-3`)
and a plain U-Net block last (`decoder.blocks.4`); widths (256, 128, 64,
32, 16), channel-attention reduction 16.

The attention keeps smp's two quirks, as the JAX decoder does: the softmax
runs over all hw * hw logits of a sample at once, and the (N, HW, C)
product is read row-major as (N, C, H, W), not transposed. Its two
products and the softmax run in float32 with autocast off, as JAX computes
them; the result is cast back to the feature's dtype.
"""

from typing import Sequence

import torch
import torch.nn as nn

from volume_segmantics_tpu_torch.models.decoders.unet import (
    DECODER_CHANNELS,
    UnetDecoderBlock,
)
from volume_segmantics_tpu_torch.models.layers import (
    Conv2d,
    ConvBnAct,
    Pooled,
    upsample,
)
from volume_segmantics_tpu_torch.parallel import spatial

PAB_CHANNELS = 64
REDUCTION = 16


class PAB(nn.Module):
    """Position-wise attention over the deepest feature map."""

    def __init__(self, channels: int):
        super().__init__()
        self.top_conv = Conv2d(channels, PAB_CHANNELS, 1)
        self.center_conv = Conv2d(channels, PAB_CHANNELS, 1)
        self.bottom_conv = Conv2d(channels, channels, 3, padding=1)
        self.out_conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        mesh = spatial.active_mesh()
        if mesh is None:
            return self._attend(x)
        # The softmax spans every position of a sample: gather the map
        # whole on each rank of the space group (8x8 at 256x256), attend,
        # keep this rank's band.
        with spatial.replicated():
            out = self._attend(spatial.gather_rows(x, mesh))
        return out[:, :, mesh.band(x.shape[3])]

    def _attend(self, x):
        n, c, h, w = x.shape
        top = self.top_conv(x).flatten(2)  # (N, P, HW)
        center = self.center_conv(x).flatten(2).transpose(1, 2)  # (N, HW, P)
        bottom = self.bottom_conv(x).flatten(2).transpose(1, 2)  # (N, HW, C)
        with torch.autocast(x.device.type, enabled=False):
            att = torch.matmul(center.float(), top.float())
            att = torch.softmax(att.reshape(n, -1), dim=1).reshape(n, h * w,
                                                                  h * w)
            out = torch.matmul(att, bottom.float())
        out = out.reshape(n, c, h, w).to(x.dtype)
        return self.out_conv(x + out)


def channel_se(channels: int) -> nn.Sequential:
    """smp MFAB's channel attention: pool, 1x1 squeeze (bias), ReLU, 1x1
    excite (bias), sigmoid; the convs at `1` and `3`."""
    squeezed = max(channels // REDUCTION, 1)
    return Pooled(
        Conv2d(channels, squeezed, 1),
        nn.ReLU(),
        Conv2d(squeezed, channels, 1),
        nn.Sigmoid(),
    )


class MFAB(nn.Module):
    """Multi-scale fusion attention: the high-level feature is projected
    to the skip's width and upsampled, both get channel attention, then
    concat and 2x (conv3x3 + BN + ReLU)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.hl_conv = nn.Sequential(
            ConvBnAct(in_ch, in_ch, 3), ConvBnAct(in_ch, skip_ch, 1))
        self.SE_hl = channel_se(skip_ch)
        self.SE_ll = channel_se(skip_ch)
        self.conv1 = ConvBnAct(skip_ch + skip_ch, out_ch)
        self.conv2 = ConvBnAct(out_ch, out_ch)

    def forward(self, x, skip):
        x = upsample(self.hl_conv(x), 2)
        x = x * (self.SE_hl(x) + self.SE_ll(skip))
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.conv2(self.conv1(x))


class MAnetDecoder(nn.Module):
    out_channels = DECODER_CHANNELS[-1]

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first
        self.center = PAB(enc[0])
        in_chs = [enc[0]] + list(DECODER_CHANNELS[:-1])
        blocks = [MFAB(i, s, o)
                  for i, s, o in zip(in_chs, enc[1:], DECODER_CHANNELS)]
        blocks.append(UnetDecoderBlock(in_chs[-1], 0, DECODER_CHANNELS[-1]))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, features):
        feats = features[1:][::-1]
        x = self.center(feats[0])
        for block, skip in zip(self.blocks, feats[1:]):
            x = block(x, skip)
        return self.blocks[-1](x)
