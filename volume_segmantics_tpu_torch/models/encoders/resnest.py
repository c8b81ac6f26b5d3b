"""ResNeSt-50d and -101e encoders, NCHW, with timm's submodule names (port
of the JAX package's `models/encoders/resnest.py`).

A deep stem (three 3x3 ConvBnReLU, `conv1.0/1/3/4/6` and `bn1`, widths
w, w, 2w with w 32 for 50d and 64 for 101e), a max-pool, then four stages
of bottlenecks whose 3x3 is a radix-2 split-attention conv (`conv2`:
`conv`, `bn0`, `fc1`, `bn1`, `fc2`), with average-pool downsampling in the
residual path (avd, after `conv2`) and in the shortcut (`downsample.0`, a
pool of stride s with no padding and a floor, as the JAX encoder; timm's
ceil mode agrees at every even size). Calling the encoder returns 6
feature maps at strides [1, 2, 4, 8, 16, 32], channels (C_in, 2w, 256,
512, 1024, 2048).

`output_stride` 16 or 8 runs the deepest stages at stride 1 throughout,
with dilation 2 (and 4), as the JAX encoder does, so their pools drop out.
smp's `make_dilated` keeps them downsampling: the dilated ResNeSt is held
against the JAX package alone.
"""

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from volume_segmantics_tpu_torch.models.encoders.resnet import (
    DILATION_PLANS,
    STAGE_PLANES,
)
from volume_segmantics_tpu_torch.models.layers import (
    AvgPool2d,
    BnAct,
    Conv2d,
    avg_pool,
    global_avg_pool,
    max_pool,
)
from volume_segmantics_tpu_torch.parallel import spatial

RADIX = 2
REDUCTION = 4


def _conv(in_ch, out_ch, k, stride=1, dilation=1, groups=1):
    return Conv2d(in_ch, out_ch, k, stride, (k // 2) * dilation, dilation,
                  groups, bias=False)


class SplitAttn(nn.Module):
    """A 3x3 conv to c * r channels in r groups, BN, ReLU; attention over
    the r splits from their summed map's mean (fc1, BN, ReLU, fc2, a
    softmax over the radix in float32, cast back); the splits' weighted
    sum. Channels are radix-major, as the JAX encoder's NHWC (n, h, w, r,
    c)."""

    def __init__(self, in_ch: int, channels: int, dilation: int = 1):
        super().__init__()
        inter = max(channels * RADIX // REDUCTION, 32)
        self.conv = _conv(in_ch, channels * RADIX, 3, 1, dilation, RADIX)
        self.bn0 = BnAct(channels * RADIX)
        self.fc1 = Conv2d(channels, inter, 1)
        self.bn1 = BnAct(inter)
        self.fc2 = Conv2d(inter, channels * RADIX, 1)

    def forward(self, x):
        h = self.bn0(self.conv(x))
        n = h.shape[0]
        splits = h.unflatten(1, (RADIX, -1))
        gap = global_avg_pool(splits.sum(dim=1))
        with spatial.replicated():  # whole on every rank of a space group
            a = self.fc2(self.bn1(self.fc1(gap)))
        att = torch.softmax(a.view(n, RADIX, -1).float(), dim=1).to(h.dtype)
        return (splits * att[..., None, None]).sum(dim=1)


class ResNestBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(in_ch, planes, 1)
        self.bn1 = BnAct(planes)
        self.conv2 = SplitAttn(planes, planes, dilation)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = BnAct(out_ch, act=None)
        self.downsample = None
        if downsample:
            pool = (AvgPool2d(stride, stride) if stride > 1
                    else nn.Identity())
            self.downsample = nn.Sequential(pool, _conv(in_ch, out_ch, 1),
                                            BnAct(out_ch, act=None))

    def forward(self, x):
        h = self.conv2(self.bn1(self.conv1(x)))
        if self.stride > 1:
            h = avg_pool(h, 3, self.stride, 1)  # avd, padding counted
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNestEncoder(nn.Module):
    def __init__(self, layers, stem_width: int, in_channels: int = 1,
                 output_stride: int = 32):
        super().__init__()
        if output_stride not in DILATION_PLANS:
            raise ValueError(f"output_stride {output_stride} is not one of "
                             f"{sorted(DILATION_PLANS)}")
        strides, dilations = DILATION_PLANS[output_stride]
        w = stem_width
        self.conv1 = nn.Sequential(
            _conv(in_channels, w, 3, 2), BnAct(w), nn.Identity(),
            _conv(w, w, 3), BnAct(w), nn.Identity(),
            _conv(w, 2 * w, 3),
        )
        self.bn1 = BnAct(2 * w)
        in_ch = 2 * w
        for stage, (planes, n_blocks, stride, dilation) in enumerate(
            zip(STAGE_PLANES, layers, strides, dilations), start=1
        ):
            out_ch = planes * ResNestBottleneck.expansion
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or in_ch != out_ch)
                blocks.append(ResNestBottleneck(in_ch, planes, s, dilation,
                                                down))
                in_ch = out_ch
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        features = [x]
        out = self.bn1(self.conv1(x))
        features.append(out)
        out = max_pool(out, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            out = stage(out)
            features.append(out)
        return features


def resnest50d(in_channels: int = 1, output_stride: int = 32):
    return ResNestEncoder((3, 4, 6, 3), 32, in_channels, output_stride), (
        in_channels, 64, 256, 512, 1024, 2048)


def resnest101e(in_channels: int = 1, output_stride: int = 32):
    return ResNestEncoder((3, 4, 23, 3), 64, in_channels, output_stride), (
        in_channels, 128, 256, 512, 1024, 2048)
