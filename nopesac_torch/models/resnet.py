"""ResNet-50 backbone in the detectron2 layout (counterpart of the JAX
package's `models/resnet.py`): STRIDE_IN_1X1=False (stride on the 3x3 conv),
FrozenBN, projection shortcut on the first block of each stage, and the
reference checkpoint's names `stem.conv1`, `res{2..5}.{i}.conv{1,2,3}`,
`res{2..5}.0.shortcut`, each conv with a `.norm` child.

`fuse_tail=True` runs each identity block's conv1 and conv3 (with their
FrozenBN, the residual and the ReLU) as kernel B4 (`ops/bottleneck.py`) in
eval mode; it adds no parameters. Off by default, as in the JAX package."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bottleneck import conv1x1_bn_act
from .layers import ConvNorm, FrozenBatchNorm2d

STAGE_BLOCKS = (3, 4, 6, 3)  # bottleneck blocks of res2..res5


def _conv_fbn(in_ch, out_ch, k, stride=1, relu=False):
    return ConvNorm(in_ch, out_ch, k, stride=stride, norm=FrozenBatchNorm2d(out_ch), relu=relu)


class BasicStem(nn.Module):
    """7x7/2 conv + FrozenBN + relu, then a 3x3/2 max pool."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = _conv_fbn(3, out_channels, 7, stride=2, relu=True)

    def forward(self, x):
        return F.max_pool2d(self.conv1(x), kernel_size=3, stride=2, padding=1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 with FrozenBN and an optional projection
    shortcut. With `fuse_tail`, an identity block in eval mode runs conv1 and
    conv3 through kernel B4 (conv2 stays a cuDNN conv)."""

    def __init__(self, in_ch: int, bottleneck_ch: int, out_ch: int, stride: int,
                 shortcut: bool, fuse_tail: bool = False):
        super().__init__()
        self.fuse_tail = fuse_tail
        self.shortcut = _conv_fbn(in_ch, out_ch, 1, stride=stride) if shortcut else None
        self.conv1 = _conv_fbn(in_ch, bottleneck_ch, 1, relu=True)
        self.conv2 = _conv_fbn(bottleneck_ch, bottleneck_ch, 3, stride=stride, relu=True)
        self.conv3 = _conv_fbn(bottleneck_ch, out_ch, 1)

    def forward(self, x):
        if self.fuse_tail and not self.training and self.shortcut is None:
            out = conv1x1_bn_act(x, self.conv1.weight, *self.conv1.norm.folded(), relu=True)
            return conv1x1_bn_act(self.conv2(out), self.conv3.weight, *self.conv3.norm.folded(),
                                  residual=x, relu=True)
        out = self.conv3(self.conv2(self.conv1(x)))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + sc)


class ResNet(nn.Module):
    """ResNet-50; returns the {res2, res3, res4, res5} NCHW feature maps."""

    def __init__(self, fuse_tail: bool = False):
        super().__init__()
        self.stem = BasicStem(64)
        in_ch, out_ch, bott = 64, 256, 64
        self.stage_names = []
        for s, n_blocks in enumerate(STAGE_BLOCKS):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (i == 0 and s > 0) else 1
                blocks.append(Bottleneck(in_ch, bott, out_ch, stride, shortcut=(i == 0),
                                         fuse_tail=fuse_tail))
                in_ch = out_ch
            name = f"res{s + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        feats = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            feats[name] = x
        return feats
