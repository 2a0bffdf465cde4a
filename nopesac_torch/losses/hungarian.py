"""Exact linear sum assignment of the DETR matcher, on the host.

The reference calls `scipy.optimize.linear_sum_assignment` per image and
decoder level (matcher.py:164-166); the JAX package runs a Jonker-Volgenant
solver on the device instead (`losses/hungarian.py:hungarian_device`). The
port goes back to scipy on the host, on each [NQ, num_gt] submatrix, and
solves every image of every supervision level after one device-to-host copy.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def sanitize_costs(cost: np.ndarray) -> np.ndarray:
    """Replace non-finite entries of each [N, M] matrix of cost [B, N, M] by
    a large finite value, as `hungarian_device` does: scipy raises on NaN
    and inf, and a diverged step must reach the non-finite skip guard
    instead of crashing here."""
    finite = np.isfinite(cost)
    if finite.all():
        return cost
    finite_max = np.where(finite, cost, -np.inf).max(axis=(1, 2))
    finite_max = np.where(np.isfinite(finite_max), finite_max, 0.0)
    big = (np.abs(finite_max) + 1.0) * 2.0 + 1e3
    return np.where(finite, cost, big[:, None, None]).astype(cost.dtype)


def hungarian(cost: torch.Tensor, num_gt: torch.Tensor) -> torch.Tensor:
    """cost [B, NQ, NG] (device), num_gt [B] (columns past num_gt[b] are
    padding) -> match [B, NQ] int64 on the cost's device: the GT index
    assigned to each query, or -1."""
    cost_np = sanitize_costs(cost.detach().to("cpu", torch.float64).numpy())
    ngt = num_gt.detach().cpu().numpy()
    b, nq, _ = cost_np.shape
    match = np.full((b, nq), -1, np.int64)
    for i in range(b):
        n = int(ngt[i])
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost_np[i, :, :n])
        match[i, rows] = cols
    return torch.from_numpy(match).to(cost.device)
