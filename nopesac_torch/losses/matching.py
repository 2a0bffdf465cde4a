"""Supervision of the plane matching (counterpart of the JAX package's
`losses/matching.py`): the GT correspondence matrix over predicted plane
indices, with dustbin row and column, and the NLL over it."""
from __future__ import annotations

import torch


def matching_nll_loss(log_scores_padded: torch.Tensor, gt_corr_matrix: torch.Tensor) -> torch.Tensor:
    """-2 x the mean (clamped <= 0) log-score over the GT correspondences;
    gt_corr_matrix [B, N1+1, N2+1] bool."""
    clamped = torch.clamp_max(log_scores_padded, 0.0)
    total = torch.where(gt_corr_matrix, -clamped, torch.zeros_like(clamped)).sum()
    count = torch.clamp_min(gt_corr_matrix.to(torch.float32).sum(), 1.0)
    return total / count * 2.0


def invert_match(match: torch.Tensor, num_queries: int) -> torch.Tensor:
    """[B, NQ] query -> GT (or -1) into [B, NQ] GT -> query (or NQ)."""
    b = match.shape[0]
    idx = torch.where(match >= 0, match, num_queries).to(torch.int64)
    out = torch.full((b, num_queries + 1), num_queries, dtype=torch.int64, device=match.device)
    q = torch.arange(num_queries, device=match.device).expand(b, -1)
    return out.scatter(1, idx, q)[:, :num_queries]


def build_pred_corr_matrix(match1, match2, corr_idx1, corr_idx2, corr_valid,
                           num_queries: int) -> torch.Tensor:
    """GT correspondence matrix over predicted plane indices,
    [B, NQ+1, NQ+1] bool: a GT pair (a, b) marks (query of a, query of b);
    unmatched rows and columns go to the dustbin."""
    nq = num_queries
    b = match1.shape[0]
    gt2pred1, gt2pred2 = invert_match(match1, nq), invert_match(match2, nq)
    p1 = torch.gather(gt2pred1, 1, torch.clamp_max(corr_idx1.to(torch.int64), nq - 1))
    p2 = torch.gather(gt2pred2, 1, torch.clamp_max(corr_idx2.to(torch.int64), nq - 1))
    p1 = torch.where(corr_valid, p1, nq)
    p2 = torch.where(corr_valid, p2, nq)
    corr = torch.zeros((b, (nq + 1) * (nq + 1)), dtype=torch.float32, device=match1.device)
    corr = corr.scatter(1, p1 * (nq + 1) + p2, 1.0).reshape(b, nq + 1, nq + 1)
    sum_row = 1.0 - corr[:, :-1, :].sum(dim=1, keepdim=True)  # [B, 1, NQ+1]
    sum_col = 1.0 - corr[:, :, :-1].sum(dim=2, keepdim=True)  # [B, NQ+1, 1]
    corr[:, -1:, :] = sum_row
    corr[:, :, -1:] = sum_col
    corr[:, -1, -1] = 0.0
    return corr > 0


def intersect_with_valid(gt_corr_matrix, row_masks, col_masks):
    """Restrict the correspondence matrix to the matched rows and columns
    (the dustbin row and column stay)."""
    b = row_masks.shape[0]
    ones = torch.ones((b, 1), dtype=torch.bool, device=row_masks.device)
    rows = torch.cat([row_masks, ones], dim=1)
    cols = torch.cat([col_masks, ones], dim=1)
    return gt_corr_matrix & rows[:, :, None] & cols[:, None, :]
