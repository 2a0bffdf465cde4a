"""ResNet-50 backbone in the detectron2 layout (counterpart of the JAX
package's `models/resnet.py`): STRIDE_IN_1X1=False (stride on the 3x3 conv),
FrozenBN, projection shortcut on the first block of each stage, and the
reference checkpoint's names `stem.conv1`, `res{2..5}.{i}.conv{1,2,3}`,
`res{2..5}.0.shortcut`, each conv with a `.norm` child.

`fuse_tail=True` (MODEL.RESNETS.FUSE_TAIL) runs each identity block's conv1
and conv3 (with their FrozenBN, the residual and the ReLU) as kernel B4
(`ops/bottleneck.py`) in eval mode; it adds no parameters. Off by default, as
in the JAX package. Each such call counts `model.fused_tail_calls`
(`utils/trace.py`) where the card runs it: at each replay of the backbone's
CUDA graph, or now where no graph is being captured.

Compute dtypes, as the JAX package's `ResNet(dtype, train_block_dtype)`:
in eval mode everything runs in `dtype` (MODEL.COMPUTE_DTYPE). In train
mode the stem and the block interiors (conv1, conv2, conv3 and their BN
but BN3) run in `train_dtype` (MODEL.BACKBONE_TRAIN_DTYPE), while the
residual trunk (block inputs and outputs, BN3's affine, the shortcut's BN,
the add and the ReLU) stays f32. `remat` (MODEL.REMAT) checkpoints each
block in train mode: only block boundaries are kept for the backward, which
re-runs each block's forward once. The blocks hold FrozenBN and draw no
random numbers, so the replay gives the same values. Inside an open eval
step the forward is one segment of `utils/graphs.py` (a CUDA graph)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.bottleneck import conv1x1_bn_act
from ..utils import graphs, trace
from .layers import Cast, ConvNorm, FrozenBatchNorm2d, conv2d, set_compute_dtype

STAGE_BLOCKS = (3, 4, 6, 3)  # bottleneck blocks of res2..res5


def _conv_fbn(in_ch, out_ch, k, stride=1, relu=False):
    return ConvNorm(in_ch, out_ch, k, stride=stride, norm=FrozenBatchNorm2d(out_ch), relu=relu)


def _count_tail() -> None:
    trace.count("model.fused_tail_calls")


def _fused(x, conv: ConvNorm, residual=None):
    """One 1x1 conv of an identity block with its FrozenBN (+ residual) and
    the ReLU, as kernel B4."""
    graphs.on_replay(_count_tail)
    return conv1x1_bn_act(x, conv.weight, *conv.norm.folded(), residual=residual, relu=True)


class BasicStem(nn.Module):
    """7x7/2 conv + FrozenBN + relu, then a 3x3/2 max pool, in the conv's
    compute dtype."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = _conv_fbn(3, out_channels, 7, stride=2, relu=True)

    def forward(self, x):
        return F.max_pool2d(self.conv1(x), kernel_size=3, stride=2, padding=1)


class Bottleneck(Cast, nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 with FrozenBN and an optional projection
    shortcut. Its compute dtype is the interior's; the trunk's is f32 in
    train mode and the interior's in eval mode. With `fuse_tail`, an identity
    block in eval mode runs conv1 and conv3 through kernel B4 (conv2 stays a
    cuDNN conv)."""

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
            return _fused(self.conv2(_fused(x, self.conv1)), self.conv3, residual=x)
        bdt = self.compute_dtype()
        odt = torch.float32 if self.training else bdt
        xb = x.to(bdt)  # one copy in the interior's dtype for conv1 and the shortcut
        out = self.conv2(self.conv1(xb))
        # conv3 in the interior's dtype; its BN affine, the shortcut's BN,
        # the add and the ReLU in the trunk's
        out = self.conv3.norm.affine(conv2d(out, self.conv3.weight.to(bdt)).to(odt), odt)
        if self.shortcut is None:
            return F.relu(out + x.to(odt))
        sc = conv2d(xb, self.shortcut.weight.to(bdt), stride=self.shortcut.stride)
        return F.relu(out + self.shortcut.norm.affine(sc.to(odt), odt))


class ResNet(Cast, nn.Module):
    """ResNet-50; returns the {res2, res3, res4, res5} NCHW feature maps, in
    `dtype` in eval mode and f32 in train mode. Its own `eval_dtype` (set
    with its layers' by `set_compute_dtype`) is the trunk's in eval mode."""

    def __init__(self, fuse_tail: bool = False, dtype: torch.dtype = torch.float32,
                 train_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
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
        set_compute_dtype(self, dtype, train_dtype)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return graphs.segment("backbone", self._stages, x)

    def _stages(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem(x).to(torch.float32 if self.training else self.eval_dtype)
        remat = self.remat and self.training and torch.is_grad_enabled()
        feats = {}
        for name in self.stage_names:
            for block in getattr(self, name):
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            feats[name] = x
        return feats
