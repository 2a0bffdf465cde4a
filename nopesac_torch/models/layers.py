"""Shared NN building blocks, NCHW (counterpart of the JAX package's
`models/layers.py`).

Parameter names follow the reference torch checkpoint: d2 `Conv2d` with a
`.norm` child, `Sequential(conv, bn, act)` conv-BN blocks (`.0`, `.1`), and
`MLP.layers.{i}`. Norm epsilons follow the JAX package, not torch's
defaults: FrozenBN and ConvBN's BN 1e-5 (momentum 0.9), the camera
ConvStack's BN 1e-3 (momentum 0.99), LayerNorm and GroupNorm 1e-6 (the Flax
defaults).

Compute dtypes follow Flax's per-module `dtype=`: parameters stay f32 and a
`Cast` layer casts its input and its weights to its compute dtype at call
time, one for eval mode and one for train mode (`set_compute_dtype`). The
norms compute their statistics and their affine in f32 and return the
module's dtype, as Flax's norms promote. Nothing here uses torch.autocast,
whose op lists put other ops in f32 than the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.dist import sum_over_ranks, world_size

FLAX_NORM_EPS = 1e-6


class Cast:
    """Mixin of the layers with a compute dtype: `eval_dtype` in eval mode,
    `train_dtype` in train mode (both f32 unless `set_compute_dtype` says
    otherwise)."""

    eval_dtype: torch.dtype = torch.float32
    train_dtype: torch.dtype = torch.float32

    def compute_dtype(self) -> torch.dtype:
        return self.train_dtype if self.training else self.eval_dtype


def set_compute_dtype(module: nn.Module, dtype: torch.dtype,
                      train_dtype: torch.dtype | None = None) -> nn.Module:
    """Give every `Cast` layer under `module` (itself included) the compute
    dtype `dtype` in eval mode and `train_dtype` (default: `dtype`) in train
    mode."""
    train_dtype = dtype if train_dtype is None else train_dtype
    for m in module.modules():
        if isinstance(m, Cast):
            m.eval_dtype, m.train_dtype = dtype, train_dtype
    return module


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """F.conv2d of operands of one dtype, the output in that dtype. On the
    CPU a bf16 conv runs as an f32 conv of the bf16 values rounded once to
    bf16, the arithmetic of a bf16 conv kernel (bf16 operands, f32 sums):
    oneDNN's bf16 backward returns wrong weight gradients where a stride-2
    3x3 conv reads a 1x1 map, as the camera head's pose stacks do at small
    image sizes."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv2d(x.float(), weight.float(), _cast(bias, torch.float32), stride, padding,
                        dilation, groups).to(torch.bfloat16)
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


class Conv2d(Cast, nn.Conv2d):
    """nn.Conv2d computing in its compute dtype (input, weight and bias cast)."""

    def forward(self, x):
        dt = self.compute_dtype()
        return conv2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride,
                      self.padding, self.dilation, self.groups)


class Linear(Cast, nn.Linear):
    """nn.Linear computing in its compute dtype (input, weight and bias cast)."""

    def forward(self, x):
        dt = self.compute_dtype()
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class GroupNorm(Cast, nn.GroupNorm):
    """nn.GroupNorm with f32 statistics and affine, output in its compute
    dtype (Flax's GroupNorm promotes a bf16 input to f32)."""

    def forward(self, x):
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype())


class FrozenBatchNorm2d(Cast, nn.Module):
    """BatchNorm with frozen statistics folded to a per-channel affine
    (detectron2 FrozenBatchNorm2d: weight, bias, running_mean, running_var
    buffers). The fold is f32; its (mul, add) are cast to the compute dtype
    before x * mul + add, so a bf16 input stays bf16."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def folded(self):
        """The per-channel (mul, add) of the affine."""
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - self.running_mean * mul

    def forward(self, x):
        return self.affine(x, self.compute_dtype())

    def affine(self, x, dtype: torch.dtype):
        """x * mul + add with the folded affine cast to `dtype`."""
        mul, add = (t.to(dtype)[None, :, None, None] for t in self.folded())
        return x * mul + add


class BatchNorm2d(Cast, nn.Module):
    """Trainable-BN layer of the reference with Flax's `nn.BatchNorm`
    semantics, not torch's.

    In train mode it normalises with the batch statistics of x, whose
    variance is the biased E[x^2] - E[x]^2 clipped at 0 (Flax's
    `use_fast_variance`), and updates the running statistics as
    ra = momentum * ra + (1 - momentum) * batch stat with that same variance
    (torch's BatchNorm2d keeps the unbiased variance there). In eval mode it
    uses the running statistics. Statistics and affine are computed in f32
    (a bf16 input is widened first, as Flax promotes), the running
    statistics stay f32 and the output is in the compute dtype. The
    state_dict is the reference's (weight, bias, running_mean,
    running_var); a checkpoint's `num_batches_tracked` is read and dropped,
    so the reference's state_dict loads strictly.

    With a process group of more than one rank, the train-mode statistics
    are those of the global batch, as in the JAX package's one global
    program: one all-reduce (SUM) of every rank's per-channel sums of x and
    x^2 and its count per layer and forward, which carries the gradient
    (its backward all-reduces it), so the running statistics stay equal on
    every rank. Eval mode calls no collective."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        dt = self.compute_dtype()
        x = x.to(torch.float32)
        if self.training:
            if world_size() > 1:
                mean, sq = _global_moments(x)
            else:
                mean, sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None]).to(dt)


def _global_moments(x: torch.Tensor):
    """E[x] and E[x^2] per channel of NCHW x over every rank's batch,
    differentiable: the all-reduce's backward sums the incoming gradients
    over the ranks."""
    count = torch.full((1,), float(x.numel() // x.shape[1]), device=x.device)
    sums = sum_over_ranks(torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]))
    c = x.shape[1]
    return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]


class ConvNorm(Conv2d):
    """d2 `Conv2d` with a `norm` child and an optional ReLU, the conv in its
    compute dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 bias: bool = False, norm: nn.Module | None = None, relu: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias)
        self.norm = norm
        self.relu = relu

    def forward(self, x):
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.relu else x


def conv_gn(in_ch: int, out_ch: int, kernel_size: int, relu: bool = True) -> ConvNorm:
    """Conv2D + GroupNorm(32) + optional relu (d2 Conv2d norm='GN')."""
    return ConvNorm(in_ch, out_ch, kernel_size,
                    norm=GroupNorm(32, out_ch, eps=FLAX_NORM_EPS), relu=relu)


def conv_bn(in_ch: int, out_ch: int, kernel_size: int = 1, stride: int = 1,
            eps: float = 1e-5, momentum: float = 0.9, leaky: bool = False) -> nn.Sequential:
    """Sequential(Conv2d(bias=False), BatchNorm2d, ReLU | LeakyReLU(0.01))."""
    act = nn.LeakyReLU(0.01) if leaky else nn.ReLU()
    return nn.Sequential(
        Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=kernel_size // 2, bias=False),
        BatchNorm2d(out_ch, eps=eps, momentum=momentum),
        act,
    )


def dropout(x: torch.Tensor, p: float, gen) -> torch.Tensor:
    """Flax `nn.Dropout`: keep each element with probability 1 - p and scale
    the kept ones by 1 / (1 - p). The mask is drawn with `torch.bernoulli`
    from `gen` (F.dropout takes no generator). The identity when `gen` is
    None (eval) or p == 0."""
    if gen is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full_like(x, keep), generator=gen)
    return torch.where(mask > 0, x / keep, torch.zeros_like(x))


class MLP(nn.Module):
    """num_layers Linear layers with ReLU between (not after the last)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = F.relu(x)
        return x


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> torch.Tensor:
    """DETR sine positional embedding (normalize=True, scale=2*pi) for an
    h x w map -> [h*w, 2*num_pos_feats], flattened row-major (y, x)."""
    y_embed = np.tile(np.arange(1, h + 1, dtype=np.float32)[:, None], (1, w))
    x_embed = np.tile(np.arange(1, w + 1, dtype=np.float32)[None, :], (h, 1))
    eps = 1e-6
    scale = 2 * np.pi
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2).reshape(h * w, 2 * num_pos_feats)
    return torch.from_numpy(pos.astype(np.float32))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NCHW nearest-neighbour upsample by an integer factor."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def upsample_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
