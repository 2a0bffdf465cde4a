"""Kernel B4: fused 1x1 conv + FrozenBN (+ residual) (+ ReLU), the tail of a
ResNet identity block at inference.

Counterpart of the JAX package's `ops/bottleneck_pallas.py:conv1x1_bn_add_relu`.
The port is NCHW, so for each image the kernel computes
Y_b[Cout, P] = W[Cout, Cin] . X_b[Cin, P] over the P = H * W pixels, with
FrozenBN folded into an f32 epilogue: y = act(acc * scale + shift [+ res]).
On a CUDA tensor the wrapper launches `csrc/bottleneck.cu`; on a CPU tensor it
runs `conv1x1_bn_act_plain`. There is no backward: the block takes this path
only in eval mode.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.device import LAUNCHES, refuse_autograd
from . import _build

KERNEL = "bottleneck_tail"
_DTYPES = (torch.float32, torch.bfloat16)


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


def conv1x1_bn_act_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = True) -> torch.Tensor:
    """Launch `csrc/bottleneck.cu` on x [B, Cin, *spatial] and the conv weight
    [Cout, Cin(, 1, 1)]; residual [B, Cout, *spatial] or None."""
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bottleneck kernel takes f32 or bf16 inputs, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"bottleneck kernel takes x [B, Cin, *spatial], got {tuple(x.shape)}")
    b, cin = x.shape[:2]
    cout = w.shape[0]
    if w.numel() != cout * cin:
        raise ValueError(f"weight {tuple(w.shape)} is not a 1x1 conv from {cin} channels")
    out_shape = (b, cout, *x.shape[2:])
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale/shift must be [{cout}], got {tuple(scale.shape)}, "
                         f"{tuple(shift.shape)}")
    if residual is not None and (tuple(residual.shape) != out_shape or residual.dtype != x.dtype):
        raise ValueError(f"residual must be {x.dtype} {out_shape}, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    tensors = [t for t in (x, w, scale, shift, residual) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("bottleneck inputs must lie on one device")
    refuse_autograd(KERNEL, *tensors)
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    scale = scale.to(torch.float32).contiguous()
    shift = shift.to(torch.float32).contiguous()
    res_ptr = None if residual is None else residual.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    p = x[0, 0].numel()
    fn = _build.load("bottleneck").nopesac_conv1x1_bn_act
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 None if res_ptr is None else res_ptr.data_ptr(), out.data_ptr(),
                 b, cin, cout, p, int(relu), int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "nopesac_conv1x1_bn_act")
    LAUNCHES.bump(KERNEL)
    return out


def conv1x1_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """relu((W . x) * scale + shift [+ residual]) per pixel, in x's dtype."""
    if x.device.type == "cpu":
        return conv1x1_bn_act_plain(x, w, scale, shift, residual, relu)
    return conv1x1_bn_act_cuda(x, w, scale, shift, residual, relu)
