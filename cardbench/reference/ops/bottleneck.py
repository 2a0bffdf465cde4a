"""B4's operation in plain PyTorch (the port's `ops/bottleneck.py:conv1x1_bn_act_plain`):
1x1 conv + FrozenBN (+ residual) (+ ReLU), the tail of a ResNet identity
block at inference. No cell runs it (the fused tail is off on every
benchmarked path); the reference's ResNet keeps the import of the port."""
from __future__ import annotations

from typing import Optional

import torch




def conv1x1_bn_act_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                         relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: an f32 product over pixels, then the epilogue,
    rounded once to x's dtype. The weight is cast to x's dtype first, as the
    TPU kernel does."""
    b, cin = x.shape[:2]
    w2 = w.reshape(w.shape[0], -1).to(x.dtype).to(torch.float32)
    acc = torch.matmul(w2, x.reshape(b, cin, -1).to(torch.float32))  # [B, Cout, P]
    acc = acc * scale.to(torch.float32)[:, None] + shift.to(torch.float32)[:, None]
    if residual is not None:
        acc = acc + residual.reshape(acc.shape).to(torch.float32)
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype).reshape(b, w2.shape[0], *x.shape[2:])


def conv1x1_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """relu((W . x) * scale + shift [+ residual]) per pixel, in x's dtype."""
    return conv1x1_bn_act_plain(x, w, scale, shift, residual, relu)
