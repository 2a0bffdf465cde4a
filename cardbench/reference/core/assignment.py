"""Mutual-nearest-neighbour assignment from OT log-scores (counterpart of the
JAX package's `core/assignment.py`; SuperGlue-style mutual max + threshold)."""
from __future__ import annotations

import torch


def mutual_max_assignment(log_scores_padded: torch.Tensor,
                          match_threshold: float) -> torch.Tensor:
    """[B, M+1, N+1] padded log scores -> [B, M, N] hard assignment (float).

    A pair (i, j) is assigned iff j = argmax_j s[i, :], i = argmax_i s[:, j]
    (mutual max over the non-dustbin block) and exp(s[i, j]) > threshold.
    """
    s = log_scores_padded[:, :-1, :-1]
    b, m, n = s.shape
    idx0 = torch.argmax(s, dim=2)  # [B, M] best col per row
    idx1 = torch.argmax(s, dim=1)  # [B, N] best row per col
    max0 = torch.amax(s, dim=2)  # [B, M]

    rows = torch.arange(m, device=s.device)[None, :]
    mutual0 = rows == torch.gather(idx1, 1, idx0)  # [B, M]
    mscores0 = torch.where(mutual0, torch.exp(max0), torch.zeros_like(max0))
    valid0 = mutual0 & (mscores0 > match_threshold)

    one_hot = torch.nn.functional.one_hot(idx0, n).to(s.dtype)
    return one_hot * valid0[..., None].to(s.dtype)


def assignment_to_sequence(assignment: torch.Tensor, max_matches: int):
    """Matched index pairs in row-major order, padded to max_matches.

    assignment: [B, M, N] 0/1. Returns (idx1 [B, K], idx2 [B, K] int32,
    valid [B, K] bool, num [B] int32) with K = max_matches; padding entries
    have idx 0 and valid False.
    """
    b, m, n = assignment.shape
    flat = assignment.reshape(b, -1) > 0
    flat_idx = torch.arange(m * n, dtype=torch.int64, device=assignment.device)
    key = torch.where(flat, flat_idx[None, :], torch.full_like(flat_idx, m * n)[None, :])
    order = torch.sort(key, dim=1, stable=True).indices[:, :max_matches]
    valid = torch.gather(flat, 1, order)
    zero = torch.zeros_like(order)
    idx1 = torch.where(valid, order // n, zero).to(torch.int32)
    idx2 = torch.where(valid, order % n, zero).to(torch.int32)
    num = torch.clamp_max(flat.sum(dim=1), max_matches).to(torch.int32)
    return idx1, idx2, valid, num
