"""Cross-view geometric consistency of plane parameters (the port's copy of
the repo's `tools/sparseplane_planeloss.py`, after the reference's
SparsePlanes `GeoConsistencyLoss`; host numpy, the same float64 arithmetic).

View 0's plane parameters go to the global frame through the relative
camera, view 1's are axis-flipped (SUNCG to habitat), and their pairwise
distances are measured: L2, or normal angle and offset. `forward` is the
mean L2 distance over the GT correspondences, 0.0 without any.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils.np_geometry import SUNCG_TO_HABITAT, plane_params_to_global


class GeoConsistencyLoss:
    def __init__(self, device: str = "cpu", max_num_planes: int = 20):
        self.max_num_planes = max_num_planes

    # ------------------------------------------------------------------
    def pack_data(self, pred_instances1: List, pred_instances2: List,
                  cam_poses: List[dict], batched_inputs=None):
        """Pad per-pair plane lists to a batch; view-0 warped by the camera,
        view-1 axis-flipped (reference pack_data)."""
        p1_list, p2_list, n1, n2 = [], [], [], []
        for x, cam in zip(pred_instances1, cam_poses):
            params = np.asarray(x["pred_plane"] if isinstance(x, dict) else x, np.float64)
            p1_list.append(plane_params_to_global(params, cam["position"], cam["rotation"]))
            n1.append(len(params))
        for x in pred_instances2:
            params = np.asarray(x["pred_plane"] if isinstance(x, dict) else x, np.float64)
            p2_list.append(params * SUNCG_TO_HABITAT)
            n2.append(len(params))

        m1 = max(n1) if n1 else 0
        m2 = max(n2) if n2 else 0
        b = len(p1_list)
        planes1 = np.zeros((b, m1, 3))
        planes2 = np.zeros((b, m2, 3))
        for i, (p1, p2) in enumerate(zip(p1_list, p2_list)):
            planes1[i, : len(p1)] = p1
            planes2[i, : len(p2)] = p2

        gt_corr_ms = None
        if batched_inputs is not None:
            gt_corr_ms = np.zeros((b, m1, m2), bool)
            for i, x in enumerate(batched_inputs):
                for a, c in x["gt_corrs"]:
                    if a < m1 and c < m2:
                        gt_corr_ms[i, a, c] = True
        return planes1, planes2, gt_corr_ms, n1, n2

    # ------------------------------------------------------------------
    def forward(self, batched_inputs, pred_instances1, pred_instances2,
                cam_poses, loss_weight: float = 1.0) -> Dict[str, float]:
        p1, p2, corr, _, _ = self.pack_data(
            pred_instances1, pred_instances2, cam_poses, batched_inputs)
        dist = np.linalg.norm(p1[:, :, None] - p2[:, None], axis=-1)
        sel = dist[corr]
        loss = float(sel.mean()) if sel.size else 0.0
        if np.isnan(loss):
            loss = 0.0
        return {"geo_consistency_loss": loss_weight * loss}

    __call__ = forward

    # ------------------------------------------------------------------
    def inference(self, pred_instances1, pred_instances2, cam_poses,
                  distance: str = "l2"):
        p1, p2, _, n1, n2 = self.pack_data(pred_instances1, pred_instances2, cam_poses)
        out = {}
        if distance == "l2":
            out["l2"] = np.linalg.norm(p1[:, :, None] - p2[:, None], axis=-1)
        elif distance == "normal":
            o1 = np.linalg.norm(p1, axis=2)[:, :, None]
            o2 = np.linalg.norm(p2, axis=2)[:, :, None]
            nrm1 = p1 / np.maximum(o1, 1e-12)
            nrm2 = p2 / np.maximum(o2, 1e-12)
            ntn = nrm1 @ np.swapaxes(nrm2, 1, 2)
            off = np.abs(o1 - np.swapaxes(o2, 1, 2))
            off_sum = np.abs(o1 + np.swapaxes(o2, 1, 2))
            out["offset"] = np.where(ntn < 0, off_sum, off)
            out["normal"] = np.arccos(np.clip(np.abs(ntn), -1, 1))
        else:
            raise NotImplementedError(distance)
        return out, n1, n2
