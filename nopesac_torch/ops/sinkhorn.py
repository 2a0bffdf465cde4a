"""Kernel B2: masked log-domain Sinkhorn.

Counterpart of the JAX package's `ops/sinkhorn_pallas.py`. Both paths share
the prologue of `core/sinkhorn.py` (dustbin padding, -1e5 masking, log
marginals). On a CUDA tensor the iterations run in one launch of
`csrc/sinkhorn.cu`; on a CPU tensor they run as the plain PyTorch loop.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.sinkhorn import log_sinkhorn_iterations, masked_ot_prologue
from ..utils.device import LAUNCHES, refuse_autograd
from . import _build

KERNEL = "sinkhorn"


def sinkhorn_plain(z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                   norm: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: z + u + v - norm after `iters`
    rounds on the prologue's outputs."""
    return log_sinkhorn_iterations(z, log_mu, log_nu, iters) - norm[:, None, None]


def sinkhorn_cuda(z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                  norm: torch.Tensor, iters: int) -> torch.Tensor:
    """Launch `csrc/sinkhorn.cu`: one block per batch element."""
    b, rows, cols = z.shape
    tensors = (z, log_mu, log_nu, norm)
    if z.device.type != "cuda":
        raise ValueError(f"sinkhorn kernel takes CUDA tensors, got {z.device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sinkhorn kernel takes f32 inputs")
    if log_mu.shape != (b, rows) or log_nu.shape != (b, cols) or norm.shape != (b,):
        raise ValueError(f"bad marginal shapes {tuple(log_mu.shape)}, {tuple(log_nu.shape)}, "
                         f"{tuple(norm.shape)} for z {tuple(z.shape)}")
    if any(t.device != z.device for t in tensors):
        raise ValueError("sinkhorn inputs must lie on one device")
    refuse_autograd(KERNEL, *tensors)
    z, log_mu, log_nu, norm = (t.contiguous() for t in tensors)
    out = torch.empty_like(z)
    fn = _build.load("sinkhorn").nopesac_sinkhorn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), norm.data_ptr(),
                 out.data_ptr(), b, rows, cols, int(iters), stream)
    _build.check(err, "nopesac_sinkhorn")
    LAUNCHES.bump(KERNEL)
    return out


def log_optimal_transport_masked(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
                                 row_masks: Optional[torch.Tensor] = None,
                                 col_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores [B, M, N] -> [B, M+1, N+1] log matching scores (f32)."""
    z, log_mu, log_nu, norm = masked_ot_prologue(
        scores.to(torch.float32), alpha, row_masks, col_masks)
    if z.device.type == "cpu":
        return sinkhorn_plain(z, log_mu, log_nu, norm, iters)
    return sinkhorn_cuda(z, log_mu, log_nu, norm, iters)
