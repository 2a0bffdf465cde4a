"""Plane matching head: attentional GNN + geometry-aware masked Sinkhorn
(counterpart of the JAX package's `models/matching_head.py`; reference
checkpoint names under `matching_head.`).

  * appearance projection (1x1 Conv1d), 9 x (self, cross) LoFTR GNN,
    descriptor projection (1x1 Conv1d)
  * affinity = <d1, d2>/sqrt(256) - offset_dist/OFFSET_MULT - normal_dist/NORMAL_MULT,
    the geometric distances coming from warping view-0 planes by the input camera
  * masked log-domain Sinkhorn with a learnable dustbin score: through kernel
    B2 at inference; in training (`training=True`) through the plain
    differentiable loop of `core/sinkhorn.py`, on every device, since B2 has
    no backward

Returns the padded [B, N+1, N+1] log-score matrix.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.geometry import normalize, warp_planes_identity, warp_planes_to_global
from ..core import sinkhorn as plain_sinkhorn
from ..ops.sinkhorn import log_optimal_transport_masked
from .transformer import LocalFeatureGNN


def geometric_distances(params1, params2, cam_tran, cam_quat):
    """Pairwise normal-angle (deg) and offset distances between warped planes.
    params1/params2: [B, N, 3]; cam_tran: [B, 3]; cam_quat: [B, 4]."""
    p2_w = warp_planes_identity(params2)  # [B, N2, 3]
    offset2 = torch.linalg.vector_norm(p2_w, dim=-1, keepdim=True)  # [B, N2, 1]
    normal2 = normalize(p2_w)

    # rotation-only warp for the normal distance
    p1_r = warp_planes_to_global(params1, cam_quat, torch.zeros_like(cam_tran))
    ntn_r = torch.matmul(normalize(p1_r), normal2.transpose(1, 2))
    normal_dist = torch.rad2deg(torch.arccos(torch.clamp(ntn_r, -1.0, 1.0)))

    # full warp for the offset distance
    p1_rt = warp_planes_to_global(params1, cam_quat, cam_tran)
    offset1 = torch.linalg.vector_norm(p1_rt, dim=-1, keepdim=True)  # [B, N1, 1]
    ntn_rt = torch.matmul(normalize(p1_rt), normal2.transpose(1, 2))
    offset2_t = offset2.transpose(1, 2)
    offset_dist = torch.where(ntn_rt < 0, torch.abs(offset1 + offset2_t),
                              torch.abs(offset1 - offset2_t))
    return normal_dist, torch.clamp(offset_dist, 1e-10, 5.0)


class MatchingHead(nn.Module):
    def __init__(self, offset_multiplier: float = 4.0, normal_multiplier: float = 8.0,
                 sinkhorn_iterations: int = 200, d_model: int = 256, gnn_pairs: int = 9):
        super().__init__()
        self.offset_multiplier = offset_multiplier
        self.normal_multiplier = normal_multiplier
        self.sinkhorn_iterations = sinkhorn_iterations
        self.d_model = d_model
        self.planeApp_proj = nn.Conv1d(d_model, d_model, 1)
        self.gnn = LocalFeatureGNN(d_model, 8, gnn_pairs)
        self.planeDesc_proj = nn.Conv1d(d_model, d_model, 1)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    @staticmethod
    def _proj(conv: nn.Conv1d, x):  # a 1x1 Conv1d on [B, N, C] tokens
        return F.linear(x, conv.weight[:, :, 0], conv.bias)

    def forward(self, plane_app1, plane_app2, matcher_input_cam: Optional[torch.Tensor],
                params1, params2, row_masks=None, col_masks=None, training: bool = False):
        """plane_app1/2 [B, N, 256]; matcher_input_cam [B, 7] = (tran, quat)
        or None; params1/2 [B, N, 3]; row/col masks [B, N] bool."""
        b, n1, _ = plane_app1.shape
        n2 = plane_app2.shape[1]
        if matcher_input_cam is None:
            normal_dist = offset_dist = plane_app1.new_zeros((b, n1, n2))
        else:
            # the geometric prior is a fixed bias, never a gradient path
            with torch.no_grad():
                normal_dist, offset_dist = geometric_distances(
                    params1, params2, matcher_input_cam[:, :3], matcher_input_cam[:, 3:])

        desc1, desc2 = self.gnn(self._proj(self.planeApp_proj, plane_app1),
                                self._proj(self.planeApp_proj, plane_app2),
                                row_masks, col_masks)
        desc1 = self._proj(self.planeDesc_proj, desc1)
        desc2 = self._proj(self.planeDesc_proj, desc2)

        log_scores = torch.matmul(desc1, desc2.transpose(1, 2)) / math.sqrt(self.d_model)
        log_scores = log_scores - offset_dist / self.offset_multiplier
        log_scores = log_scores - normal_dist / self.normal_multiplier
        solve = (plain_sinkhorn.log_optimal_transport_masked if training
                 else log_optimal_transport_masked)
        return solve(log_scores, self.bin_score, self.sinkhorn_iterations,
                     row_masks=row_masks, col_masks=col_masks)
