"""ResNet-family encoders (ResNet-34/50, ResNeXt-50 32x4d), NCHW, with
torchvision/smp submodule names (port of the JAX package's
`models/encoders/resnet.py`).

Calling the encoder returns 6 feature maps at strides [1, 2, 4, 8, 16, 32]
with channels (C_in, 64, 64, 128, 256, 512) for ResNet-34 and (C_in, 64,
256, 512, 1024, 2048) for the Bottleneck encoders. `output_stride` 16 or 8
swaps stride for dilation in the deepest stages, as the JAX encoder does
for the DeepLab and PAN decoders: at 16 stage 4 runs at stride 1, dilation
2; at 8 stages 3 and 4 at stride 1, dilations 2 and 4. Every 3x3 conv of a
dilated stage, its first block's included, pads by its dilation, and a
first block keeps its 1x1 `downsample` wherever the channel count changes.
"""

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from volume_segmantics_tpu_torch.models.layers import BnAct, Conv2d, max_pool

STAGE_PLANES = (64, 128, 256, 512)
# output stride -> (strides, dilations) of stages 1-4
DILATION_PLANS = {
    32: ((1, 2, 2, 2), (1, 1, 1, 1)),
    16: ((1, 2, 2, 1), (1, 1, 1, 2)),
    8: ((1, 2, 1, 1), (1, 1, 2, 4)),
}


def _conv(in_ch, out_ch, k, stride=1, dilation=1, groups=1):
    return Conv2d(in_ch, out_ch, k, stride, (k // 2) * dilation, dilation,
                  groups, bias=False)


def _downsample(in_ch, out_ch, stride):
    return nn.Sequential(_conv(in_ch, out_ch, 1, stride),
                         BnAct(out_ch, act=None))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride, dilation)
        self.bn1 = BnAct(planes, act="relu")
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BnAct(planes, act=None)
        self.downsample = (_downsample(in_ch, planes, stride) if downsample
                           else None)

    def forward(self, x):
        out = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation, groups) -> 1x1 to planes * 4, at
    width int(planes * base_width / 64) * groups."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = _conv(in_ch, width, 1)
        self.bn1 = BnAct(width, act="relu")
        self.conv2 = _conv(width, width, 3, stride, dilation, groups)
        self.bn2 = BnAct(width, act="relu")
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = BnAct(out_ch, act=None)
        self.downsample = (_downsample(in_ch, out_ch, stride) if downsample
                           else None)

    def forward(self, x):
        out = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """torchvision-style ResNet trunk emitting a 6-level feature pyramid."""

    def __init__(self, block=BasicBlock, layers=(3, 4, 6, 3),
                 in_channels: int = 1, output_stride: int = 32,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        if output_stride not in DILATION_PLANS:
            raise ValueError(f"output_stride {output_stride} is not one of "
                             f"{sorted(DILATION_PLANS)}")
        strides, dilations = DILATION_PLANS[output_stride]
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BnAct(64, act="relu")
        in_ch = 64
        for stage, (planes, n_blocks, stride, dilation) in enumerate(
            zip(STAGE_PLANES, layers, strides, dilations), start=1
        ):
            out_ch = planes * block.expansion
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or in_ch != out_ch)
                blocks.append(block(in_ch, planes, s, dilation, down, groups,
                                    base_width))
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


def resnet34(in_channels: int = 1, output_stride: int = 32):
    return ResNetEncoder(BasicBlock, (3, 4, 6, 3), in_channels,
                         output_stride), (in_channels, 64, 64, 128, 256, 512)


def resnet50(in_channels: int = 1, output_stride: int = 32):
    return ResNetEncoder(Bottleneck, (3, 4, 6, 3), in_channels,
                         output_stride), (in_channels, 64, 256, 512, 1024, 2048)


def resnext50_32x4d(in_channels: int = 1, output_stride: int = 32):
    return ResNetEncoder(Bottleneck, (3, 4, 6, 3), in_channels, output_stride,
                         groups=32, base_width=4), (
        in_channels, 64, 256, 512, 1024, 2048)
