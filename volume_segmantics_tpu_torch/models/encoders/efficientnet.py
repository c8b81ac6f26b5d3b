"""EfficientNet-B3/-B4 encoders, NCHW (port of the JAX package's
`models/encoders/efficientnet.py`), with the flat names of lukemelas'
`efficientnet_pytorch`, which smp 0.2 loads for "efficientnet-bX": stem
`_conv_stem`/`_bn0`, blocks `_blocks.{i}` with `_expand_conv`/`_bn0`
(absent at expand 1), `_depthwise_conv`/`_bn1`, `_se_reduce`/`_se_expand`
and `_project_conv`/`_bn2`.

Calling the encoder returns 6 feature maps, at the input, the stem and
after stages 2, 3, 5 and 7 (strides 1, 2, 4, 8, 16, 32), with channels
(C_in, 40, 32, 48, 136, 384) for B3 and (C_in, 48, 32, 56, 160, 448) for
B4. Convolutions pad TF-"SAME"; BatchNorm has eps 1e-3 and, as every
encoder here, momentum 0.9; activations are SiLU. There is no
drop-connect: the JAX package has none. `output_stride` 16 or 8 turns the
stride of each stage that would pass it into dilation, and that stage's
first block already takes the new dilation (the JAX rule, not
torchvision's).

smp's module also carries lukemelas' classification tail, `_conv_head`
and `_bn1`, which the segmentation forward never runs, so reference
files hold it. The encoder holds it as buffers (never parameters, never
trained or counted), so `state_dict()` has the reference's keys and a
reference file loads strictly; a new model's tail is the JAX exporter's
zero conv and identity BatchNorm.
"""

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from volume_segmantics_tpu_torch.models.layers import (
    BnAct,
    Conv2d,
    SameConv2d,
    global_avg_pool,
)
from volume_segmantics_tpu_torch.parallel import spatial

# Base (B0) stages: (expand, kernel, stride, channels, repeats)
B0_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)
TAP_STAGES = (2, 3, 5, 7)
# encoder name -> (width, depth) multipliers
VARIANTS = {"efficientnet-b3": (1.2, 1.4), "efficientnet-b4": (1.4, 1.8)}
BN_EPS = 1e-3
SE_RATIO = 0.25


def round_channels(channels: float, divisor: int = 8) -> int:
    """EfficientNet's channel rounding."""
    new_c = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * channels:
        new_c += divisor
    return new_c


def stage_repeats(depth_mult: float) -> List[int]:
    """Blocks in each of the seven stages."""
    return [int(math.ceil(depth_mult * r)) for *_, r in B0_STAGES]


def tail_channels(width_mult: float):
    """(in, out) channels of the inert `_conv_head`."""
    return round_channels(320 * width_mult), round_channels(1280 * width_mult)


class Buffers(nn.Module):
    """Tensors carried in `state_dict()` that are neither parameters nor
    ever run (the reference's classification tail)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, tensor in tensors.items():
            self.register_buffer(name, tensor)


class MBConvBlock(nn.Module):
    """Optional 1x1 expand, depthwise k x k SAME conv, squeeze-excite on
    the expanded channels (SiLU, sigmoid gate), 1x1 project with BN and
    no activation; a residual where stride is 1 and in == out."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int,
                 stride: int, dilation: int):
        super().__init__()
        mid = in_ch * expand
        self.expand = expand != 1
        if self.expand:
            self._expand_conv = Conv2d(in_ch, mid, 1, bias=False)
            self._bn0 = BnAct(mid, "silu", BN_EPS)
        self._depthwise_conv = SameConv2d(mid, mid, kernel, stride, dilation,
                                          groups=mid)
        self._bn1 = BnAct(mid, "silu", BN_EPS)
        se_ch = max(1, int(in_ch * SE_RATIO))
        self._se_reduce = Conv2d(mid, se_ch, 1)
        self._se_expand = Conv2d(se_ch, mid, 1)
        self._project_conv = Conv2d(mid, out_ch, 1, bias=False)
        self._bn2 = BnAct(out_ch, None, BN_EPS)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self._bn0(self._expand_conv(x)) if self.expand else x
        h = self._bn1(self._depthwise_conv(h))
        pooled = global_avg_pool(h)
        with spatial.replicated():  # whole on every rank of a space group
            s = self._se_expand(F.silu(self._se_reduce(pooled)))
        h = h * torch.sigmoid(s)
        h = self._bn2(self._project_conv(h))
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    def __init__(self, width_mult: float, depth_mult: float,
                 in_channels: int = 1, output_stride: int = 32):
        super().__init__()
        if output_stride not in (8, 16, 32):
            raise ValueError(f"output_stride {output_stride} is not one of "
                             "[8, 16, 32]")
        stem_ch = round_channels(32 * width_mult)
        self._conv_stem = SameConv2d(in_channels, stem_ch, 3, 2)
        self._bn0 = BnAct(stem_ch, "silu", BN_EPS)
        blocks, self.taps = [], []
        in_ch, current_stride, dilation = stem_ch, 2, 1
        for stage, ((expand, kernel, s, c, _), reps) in enumerate(
            zip(B0_STAGES, stage_repeats(depth_mult)), start=1
        ):
            out_ch = round_channels(c * width_mult)
            for b in range(reps):
                stride = s if b == 0 else 1
                if stride > 1 and current_stride * stride > output_stride:
                    dilation *= stride
                    stride = 1
                elif stride > 1:
                    current_stride *= stride
                blocks.append(MBConvBlock(in_ch, out_ch, expand, kernel,
                                          stride, dilation))
                in_ch = out_ch
            if stage in TAP_STAGES:
                self.taps.append(len(blocks) - 1)
        self._blocks = nn.ModuleList(blocks)
        last_ch, head_ch = tail_channels(width_mult)
        self._conv_head = Buffers(weight=torch.zeros(head_ch, last_ch, 1, 1))
        self._bn1 = Buffers(
            weight=torch.ones(head_ch), bias=torch.zeros(head_ch),
            running_mean=torch.zeros(head_ch), running_var=torch.ones(head_ch),
            num_batches_tracked=torch.tensor(0, dtype=torch.long))

    def forward(self, x) -> List[torch.Tensor]:
        h = self._bn0(self._conv_stem(x))
        features = [x, h]
        for i, block in enumerate(self._blocks):
            h = block(h)
            if i in self.taps:
                features.append(h)
        return features


def efficientnet_b3(in_channels: int = 1, output_stride: int = 32):
    return EfficientNetEncoder(*VARIANTS["efficientnet-b3"], in_channels,
                               output_stride), (in_channels, 40, 32, 48, 136, 384)


def efficientnet_b4(in_channels: int = 1, output_stride: int = 32):
    return EfficientNetEncoder(*VARIANTS["efficientnet-b4"], in_channels,
                               output_stride), (in_channels, 48, 32, 56, 160, 448)
