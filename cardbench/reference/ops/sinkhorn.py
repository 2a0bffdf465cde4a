"""B2's operation in plain PyTorch: the masked log-domain optimal transport
of `core/sinkhorn.py` (the port's `ops/sinkhorn.py:sinkhorn_plain`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core import sinkhorn as plain


def log_optimal_transport_masked(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
                                 row_masks: Optional[torch.Tensor] = None,
                                 col_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores [B, M, N] -> [B, M+1, N+1] log matching scores (f32)."""
    return plain.log_optimal_transport_masked(scores.to(torch.float32), alpha, iters,
                                              row_masks, col_masks)
