"""Kernel B2: masked log-domain Sinkhorn optimal transport.

Counterpart of the JAX package's `ops/sinkhorn_pallas.py`. On a CUDA tensor
the whole function, from the scores to the log coupling (dustbin padding,
-1e5 masking, log marginals, the iterations and the final `- norm`), is one
launch of `csrc/sinkhorn.cu`; on a CPU tensor it is the plain PyTorch
function of `core/sinkhorn.py`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import sinkhorn as plain
from ..utils.device import LAUNCHES, refuse_autograd
from . import _build

KERNEL = "sinkhorn"
# lanes per row or column of the register variant: 16 ran 16% slower at the
# main-path shape on an H100 (PERF.md)
GROUP = 8
MAX_VALUES = 8  # the most values per lane compiled: rows and columns up to 64
GENERAL_THREADS = 512
MAX_SMEM = 232448  # bytes of shared memory a block can use on the H100


def sinkhorn_config(rows: int, cols: int) -> dict:
    """The compiled variant of `csrc/sinkhorn.cu` for a [rows, cols] coupling
    (rows = M + 1, cols = N + 1). Where max(rows, cols) <= 64 the register
    variant: a group of GROUP lanes per row and per column, `values` =
    ceil(max(rows, cols) / GROUP) entries of each in every lane's registers.
    Else the general variant, z in shared memory."""
    n = max(rows, cols)
    values = -(-n // GROUP)
    if values <= MAX_VALUES:
        return {"variant": "register", "values": values, "threads": -(-GROUP * n // 32) * 32}
    return {"variant": "general", "values": 0, "threads": GENERAL_THREADS,
            "smem": 4 * (rows * cols + rows + cols)}


last_config: dict = {}  # the config of the latest CUDA launch


def sinkhorn_plain(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
                   row_masks: Optional[torch.Tensor] = None,
                   col_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the masked OT of `core/sinkhorn.py`."""
    return plain.log_optimal_transport_masked(scores, alpha, iters, row_masks, col_masks)


def _mask(mask: Optional[torch.Tensor], shape, dev, what: str) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"sinkhorn {what} mask must be bool or uint8, got {mask.dtype}")
    if tuple(mask.shape) != shape or mask.device != dev:
        raise ValueError(f"sinkhorn {what} mask must be {list(shape)} on {dev}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    return mask.contiguous()


def sinkhorn_cuda(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
                  row_masks: Optional[torch.Tensor] = None,
                  col_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch `csrc/sinkhorn.cu`: one block per batch element. scores f32
    [B, M, N]; masks bool or uint8 (True = valid), None = all valid; alpha
    one value."""
    if scores.dtype != torch.float32 or scores.dim() != 3:
        raise TypeError(f"sinkhorn kernel takes f32 scores [B, M, N], got {scores.dtype} "
                        f"{tuple(scores.shape)}")
    if iters < 0:
        raise ValueError(f"sinkhorn iterations must be >= 0, got {iters}")
    dev = scores.device
    b, m, n = scores.shape
    rows = _mask(row_masks, (b, m), dev, "row")
    cols = _mask(col_masks, (b, n), dev, "column")
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    if alpha.numel() != 1:
        raise ValueError(f"sinkhorn bin score must be one value, got {tuple(alpha.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"sinkhorn kernel takes CUDA tensors, got {dev}")
    refuse_autograd(KERNEL, scores, alpha)
    cfg = sinkhorn_config(m + 1, n + 1)
    if cfg["variant"] == "general" and cfg["smem"] > MAX_SMEM:
        raise ValueError(f"sinkhorn coupling [{m + 1}, {n + 1}] does not fit in shared memory")
    scores, alpha = scores.contiguous(), alpha.contiguous()
    out = torch.empty((b, m + 1, n + 1), dtype=torch.float32, device=dev)
    fn = _build.load("sinkhorn").nopesac_sinkhorn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(scores.data_ptr(), None if rows is None else rows.data_ptr(),
                 None if cols is None else cols.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                 b, m, n, int(iters), cfg["values"], stream)
    _build.check(err, "nopesac_sinkhorn")
    LAUNCHES.bump(KERNEL)
    last_config.clear()
    last_config.update(cfg)
    return out


def log_optimal_transport_masked(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
                                 row_masks: Optional[torch.Tensor] = None,
                                 col_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores [B, M, N] -> [B, M+1, N+1] log matching scores (f32)."""
    scores = scores.to(torch.float32)
    if scores.device.type == "cpu":
        return sinkhorn_plain(scores, alpha, iters, row_masks, col_masks)
    return sinkhorn_cuda(scores, alpha, iters, row_masks, col_masks)
