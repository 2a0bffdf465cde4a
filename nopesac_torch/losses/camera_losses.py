"""Camera pose losses, the AIM auto-encoder losses with their random poses,
and the NOPE-SAC refinement losses (counterpart of the JAX package's
`losses/camera_losses.py`)."""
from __future__ import annotations

from typing import Dict

import torch

from ..core.geometry import canonicalize_quat_sign, normalize, quat_from_rotvec, safe_norm


def camera_pose_loss(est_tran, est_rot, gt_pose):
    """(mean |dt|, mean |normalize(q) - normalize(q_gt)|). The estimate's
    normalisation uses eps 1e-3, as the JAX package's, which bounds its
    gradient where a raw regressor output sits near zero."""
    l_x = safe_norm(gt_pose[:, 0:3] - est_tran, dim=1).mean()
    l_q = safe_norm(normalize(gt_pose[:, 3:]) - normalize(est_rot, eps=1e-3), dim=1).mean()
    return l_x, l_q


def rand_aim_rot(gen: torch.Generator, batch_size: int, device=None) -> torch.Tensor:
    """Random sign-canonical unit quaternions from rotation vectors uniform
    in [-2.5, 2.5]^3."""
    u = torch.rand((batch_size, 3), generator=gen, device=device)
    return rot_from_uniform(u)


def rot_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The quaternions of `rand_aim_rot` from its uniform draws u [N, 3]."""
    return canonicalize_quat_sign(normalize(quat_from_rotvec((u * 2.0 - 1.0) * 2.5)))


def rand_aim_trans(gen: torch.Generator, batch_size: int, device=None) -> torch.Tensor:
    """Random translations uniform in [-2.5, 2.5]^3."""
    return trans_from_uniform(torch.rand((batch_size, 3), generator=gen, device=device))


def trans_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The translations of `rand_aim_trans` from its uniform draws u [N, 3]."""
    return (u - 0.5) * 5.0


def rot_rec_loss(input_rot, pred_rot):
    """AIM rotation reconstruction."""
    return safe_norm(normalize(input_rot) - pred_rot, dim=1).mean()


def trans_rec_loss(input_trans, pred_trans):
    """AIM translation reconstruction."""
    return safe_norm(input_trans - pred_trans, dim=1).mean()


def refine_losses(ref: Dict, gt_pose, seq_valid, num_matches, suffix: str,
                  weight: float) -> Dict[str, torch.Tensor]:
    """The losses of one refinement branch; `ref` is the output of
    `PlaneCameraHead.refine(..., clamp_scores=True)`."""
    losses = {}
    lt_avg, lr_avg = camera_pose_loss(ref["tran_avg_excl"], ref["rot_avg_excl"], gt_pose)
    lt_soft, lr_soft = camera_pose_loss(ref["tran_soft"], ref["rot_soft"], gt_pose)
    losses[f"loss_tran_planeAvgReg_{suffix}"] = lt_avg * weight
    losses[f"loss_rot_planeAvgReg_{suffix}"] = lr_avg * weight
    losses[f"loss_tran_planeSoftReg_{suffix}"] = lt_soft * weight
    losses[f"loss_rot_planeSoftReg_{suffix}"] = lr_soft * weight

    hyp_valid = ref["hyp_valid"]  # [B, M+1]
    big = ref["rots_all"].new_tensor(1e10)

    # the score of the hypothesis closest to the GT pose is pushed to 1
    rot_err = safe_norm(normalize(gt_pose[:, None, 3:]) - normalize(ref["rots_all"]), dim=-1)
    best_rot = torch.argmin(torch.where(hyp_valid, rot_err, big).detach(), dim=-1)
    score_at = torch.gather(ref["score_rot"], 1, best_rot[:, None])[:, 0]
    losses[f"loss_rotIdx_{suffix}"] = torch.abs(1.0 - score_at).mean() * 0.01 * weight

    trans_err = safe_norm(gt_pose[:, None, :3] - ref["trans_all"], dim=-1)
    best_tr = torch.argmin(torch.where(hyp_valid, trans_err, big).detach(), dim=-1)
    score_at_t = torch.gather(ref["score_trans"], 1, best_tr[:, None])[:, 0]
    losses[f"loss_transIdx_{suffix}"] = torch.abs(1.0 - score_at_t).mean() * 0.02 * weight

    # l2 of hypothesis i against match i, over the matched pairs
    l2 = ref["l2_dist"]  # [B, M+1, M]
    diag = torch.diagonal(l2[:, 1:, :], dim1=1, dim2=2)  # [B, M]
    per_img = (diag * seq_valid.to(l2.dtype)).sum(dim=-1) / torch.clamp_min(
        num_matches.to(l2.dtype), 1.0)
    losses[f"loss_paramL2_dist_{suffix}"] = per_img.mean() * 0.1 * weight
    return losses
