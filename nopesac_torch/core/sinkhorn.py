"""Masked log-domain Sinkhorn optimal transport: the shared prologue and the
plain loop (counterpart of the JAX package's `core/sinkhorn.py`).

The masking algebra follows the reference exactly: invalid rows/cols get a
finite -1e5 score and a -1e5 log-marginal (never -inf), which makes their
u/v updates inert while keeping every logsumexp finite. The CUDA kernel
(`ops/sinkhorn.py`) computes the whole function in one launch, prologue
included; this module is its plain version, and training's differentiable
path.
"""
from __future__ import annotations

from typing import Optional

import torch

_INF = 1e5


def log_sinkhorn_iterations(z: torch.Tensor, log_mu: torch.Tensor,
                            log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """Sinkhorn normalisation in log space, one eager op chain per half
    iteration. z: [B, M, N]; log_mu: [B, M]; log_nu: [B, N]."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
    return z + u[:, :, None] + v[:, None, :]


def masked_ot_prologue(scores: torch.Tensor, alpha: torch.Tensor,
                       row_masks: Optional[torch.Tensor],
                       col_masks: Optional[torch.Tensor]):
    """Dustbin padding + invalid masking + log marginals.

    Returns (padded_scores [B,M+1,N+1], log_mu [B,M+1], log_nu [B,N+1],
    norm [B])."""
    b, m, n = scores.shape
    dtype, dev = scores.dtype, scores.device
    if row_masks is None:
        row_masks = torch.ones((b, m), dtype=torch.bool, device=dev)
    if col_masks is None:
        col_masks = torch.ones((b, n), dtype=torch.bool, device=dev)

    # padded masks: the dustbin row/col is always valid
    false_col = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    row_invalid = torch.cat([~row_masks, false_col], dim=1)  # [B, M+1]
    col_invalid = torch.cat([~col_masks, false_col], dim=1)  # [B, N+1]
    score_invalid = row_invalid[:, :, None] | col_invalid[:, None, :]

    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    padded = torch.cat(
        [torch.cat([scores, alpha.expand(b, m, 1)], dim=-1), alpha.expand(b, 1, n + 1)],
        dim=1)
    padded = torch.where(score_invalid, -_INF, padded)

    num_valid_row = row_masks.to(dtype).sum(dim=1)  # [B]
    num_valid_col = col_masks.to(dtype).sum(dim=1)  # [B]
    norm = -torch.log(num_valid_row + num_valid_col)  # [B]

    log_mu = torch.cat([norm[:, None].expand(b, m), (torch.log(num_valid_col) + norm)[:, None]],
                       dim=1)
    log_mu = torch.where(row_invalid, -_INF, log_mu)
    log_nu = torch.cat([norm[:, None].expand(b, n), (torch.log(num_valid_row) + norm)[:, None]],
                       dim=1)
    log_nu = torch.where(col_invalid, -_INF, log_nu)
    return padded, log_mu, log_nu, norm


def log_optimal_transport_masked(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
                                 row_masks: Optional[torch.Tensor] = None,
                                 col_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked OT with a learnable dustbin row/col, plain PyTorch loop.

    scores [B, M, N]; row_masks [B, M] / col_masks [B, N] bool (True = valid,
    None = all valid). Returns [B, M+1, N+1] log matching scores (scaled by
    the number of valid rows+cols, exactly as the reference does)."""
    padded, log_mu, log_nu, norm = masked_ot_prologue(scores, alpha, row_masks, col_masks)
    out = log_sinkhorn_iterations(padded, log_mu, log_nu, iters)
    return out - norm[:, None, None]
