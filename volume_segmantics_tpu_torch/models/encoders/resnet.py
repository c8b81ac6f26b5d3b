"""ResNet-34 encoder, NCHW, with torchvision/smp submodule names (port of
the JAX package's `models/encoders/resnet.py`, output stride 32).

Calling the encoder returns 6 feature maps at strides [1, 2, 4, 8, 16, 32]
with channels (1, 64, 64, 128, 256, 512).
"""

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from volume_segmantics_tpu_torch.models.layers import BnAct, max_pool


def _conv(in_ch, out_ch, k, stride=1):
    return nn.Conv2d(in_ch, out_ch, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride)
        self.bn1 = BnAct(planes, act="relu")
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BnAct(planes, act=None)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                _conv(in_ch, planes, 1, stride), BnAct(planes, act=None)
            )

    def forward(self, x):
        out = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """torchvision-style ResNet trunk emitting a 6-level feature pyramid."""

    def __init__(self, layers=(3, 4, 6, 3), in_channels: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BnAct(64, act="relu")
        in_ch = 64
        for stage, (planes, n_blocks) in enumerate(
            zip((64, 128, 256, 512), layers), start=1
        ):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 1) else 1
                blocks.append(BasicBlock(in_ch, planes, stride))
                in_ch = planes
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


def resnet34(in_channels: int = 1):
    return ResNetEncoder((3, 4, 6, 3), in_channels), (
        in_channels, 64, 64, 128, 256, 512
    )
