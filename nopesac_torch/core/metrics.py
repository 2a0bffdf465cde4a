"""Plane / camera / AP metric primitives (numpy host-side, jnp-free).

These run in the evaluation pipeline on host CPU (they operate on ragged
per-image prediction lists), so they are written in plain numpy.

Specs:
  * compute_ap / voc_ap: utils/VOCap.py:5-44
  * compare_planes: utils/metrics.py:6-24 (chord-angle normals, L1 offsets)
  * camera errors: evaluation/mp3d_evaluation.py:382-465
"""
from __future__ import annotations

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC-style interpolated AP (utils/VOCap.py:30-44)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def compute_ap(scores: np.ndarray, labels: np.ndarray, npos: float) -> float:
    """AP from per-detection scores and 0/1 labels (utils/VOCap.py:5-27)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum((labels[order] == 1).astype(np.float64))
    fp = np.cumsum((labels[order] == 0).astype(np.float64))
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, 1e-12)
    return voc_ap(rec, prec)


def compare_planes(pred_planes, gt_planes) -> dict:
    """Pairwise normal-angle (deg) and offset-L1 matrices (utils/metrics.py:6-24)."""
    pred = np.asarray(pred_planes, dtype=np.float32).reshape(-1, 3)
    gt = np.asarray(gt_planes, dtype=np.float32).reshape(-1, 3)
    pred_off = np.linalg.norm(pred, axis=1) + 1e-5
    gt_off = np.linalg.norm(gt, axis=1) + 1e-5
    pred_n = pred / pred_off[:, None]
    gt_n = gt / gt_off[:, None]
    # chordal distance -> angle via 2*asin(d/2)
    d = np.linalg.norm(pred_n[:, None, :] - gt_n[None, :, :], axis=-1)
    d = np.clip(d, 0.0, 2.0)
    norm_angle = 2.0 * np.arcsin(d / 2.0) / np.pi * 180.0
    offset_dist = np.abs(pred_off[:, None] - gt_off[None, :])
    return {"norm": norm_angle, "offset": offset_dist}


def compare_planes_one_to_one(pred_planes, gt_planes) -> dict:
    """Mean l2/normal-angle(rad)/offset errors for aligned plane lists
    (utils/metrics.py:27-45)."""
    pred = np.asarray(pred_planes, dtype=np.float32).reshape(-1, 3)
    gt = np.asarray(gt_planes, dtype=np.float32).reshape(-1, 3)
    pred_off = np.clip(np.linalg.norm(pred, axis=1), 1e-5, None)
    gt_off = np.clip(np.linalg.norm(gt, axis=1), 1e-5, None)
    pred_n = pred / pred_off[:, None]
    gt_n = gt / gt_off[:, None]
    l2 = float(np.linalg.norm(pred - gt, axis=1).mean())
    norm = float(np.arccos(np.clip(np.sum(pred_n * gt_n, axis=1), -1.0, 1.0)).mean())
    offset = float(np.abs(pred_off - gt_off).mean())
    return {"l2": l2, "norm": norm, "offset": offset}


def rotation_angle_error_deg(q_pred: np.ndarray, q_gt: np.ndarray) -> np.ndarray:
    """Geodesic angle (deg) between unit quats: 2*acos(|<q1,q2>|)
    (camera_modules.py:50-51 / mp3d_evaluation.py:463-465)."""
    q_pred = np.asarray(q_pred, dtype=np.float64).reshape(-1, 4)
    q_gt = np.asarray(q_gt, dtype=np.float64).reshape(-1, 4)
    q_pred = q_pred / np.linalg.norm(q_pred, axis=1, keepdims=True)
    q_gt = q_gt / np.linalg.norm(q_gt, axis=1, keepdims=True)
    d = np.abs(np.sum(q_pred * q_gt, axis=1))
    return 2.0 * np.arccos(np.clip(d, -1.0, 1.0)) * 180.0 / np.pi


def camera_error_summary(tran_errs, rot_errs) -> dict:
    """Median/mean/acc table (mp3d_evaluation.py:382-425; eval.py adds 0.1m/5deg)."""
    tran_errs = np.asarray(tran_errs, dtype=np.float64)
    rot_errs = np.asarray(rot_errs, dtype=np.float64)
    out = {
        "T median err": float(np.median(tran_errs)),
        "T mean err": float(np.mean(tran_errs)),
        "R median err": float(np.median(rot_errs)),
        "R mean err": float(np.mean(rot_errs)),
    }
    # key names match mp3d_evaluation.py:407-417 ("T err < 1.0", "R err < 30")
    for thr, name in ((1.0, "1.0"), (0.5, "0.5"), (0.2, "0.2"), (0.1, "0.1")):
        out[f"T err < {name}"] = float(np.mean(tran_errs < thr) * 100.0)
    for thr, name in ((30.0, "30"), (15.0, "15"), (10.0, "10"), (5.0, "5")):
        out[f"R err < {name}"] = float(np.mean(rot_errs < thr) * 100.0)
    return out
