"""Set-prediction criterion of the plane detector: matching costs, the
Hungarian match of every supervision level, and the detection losses
(counterpart of the JAX package's `losses/criterion.py`).

`match[b, q]` is the GT index matched to query q, or -1. Targets, per view
or with both views stacked (view 0 first):
  gt_valid [B, NG] bool, gt_masks [B, NG, H, W] uint8 0/1 (disjoint),
  gt_params [B, NG, 3], gt_centers [B, NG, 2], gt_pixel_centers [B, H, W, 2],
  depth [B, H, W], k_inv_dot_xy1 [B, 3, H, W].
The mask focal + dice terms go through kernel B3 (`ops/mask_loss.py`).
With MODEL.DEPTH_ON, `depth_loss_siamese` adds the masked L1 of the depth
branch.

Across ranks every loss is this rank's share of the global batch's loss:
its own numerators over the normalisers of every rank (`all_reduce_sum`),
its batch means as `share_mean`. The shares sum to the loss of the global
batch, as the JAX package's one global program computes it; at world size
1 they are the losses themselves.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..core.geometry import normalize, safe_norm
from ..ops.mask_loss import fused_focal_dice
from ..parallel.dist import all_reduce_sum, share_mean
from .hungarian import hungarian


def bce_logits(x, target):
    """Elementwise binary cross-entropy with logits."""
    return torch.clamp_min(x, 0.0) - x * target + torch.log1p(torch.exp(-torch.abs(x)))


def batch_sigmoid_focal_cost(inputs, targets, alpha: float = 0.25, gamma: float = 2.0):
    """[B, NQ, HW] x [B, NG, HW] -> [B, NQ, NG] focal cost."""
    hw = inputs.shape[-1]
    prob = torch.sigmoid(inputs)
    focal_pos = ((1 - prob) ** gamma) * bce_logits(inputs, torch.ones_like(inputs)) * alpha
    focal_neg = (prob ** gamma) * bce_logits(inputs, torch.zeros_like(inputs)) * (1 - alpha)
    loss = (torch.einsum("bnc,bmc->bnm", focal_pos, targets)
            + torch.einsum("bnc,bmc->bnm", focal_neg, 1 - targets))
    return loss / hw


def batch_dice_cost(inputs, targets):
    """[B, NQ, HW] x [B, NG, HW] -> [B, NQ, NG] dice cost."""
    inputs = torch.sigmoid(inputs)
    numerator = 2 * torch.einsum("bnc,bmc->bnm", inputs, targets)
    denominator = inputs.sum(-1)[:, :, None] + targets.sum(-1)[:, None, :]
    return 1 - (numerator + 1) / (denominator + 1)


def compute_match_cost(outputs: Dict, targets: Dict, weights: Dict) -> torch.Tensor:
    """DETR matching cost [B, NQ, NG] of one supervision level."""
    logits = outputs["pred_logits"]  # [B, NQ, 2]
    b, nq, _ = logits.shape
    mask_logits = outputs["pred_mask_logits"]  # [B, NQ, h, w]
    h, w = mask_logits.shape[-2:]
    cost_class = -torch.softmax(logits, dim=-1)[..., 0:1]  # every target is class 0

    # GT masks subsampled (nearest) to the prediction's resolution
    gt_masks = targets["gt_masks"]
    gh, gw = gt_masks.shape[-2:]
    dev = gt_masks.device
    ys = (torch.arange(h, device=dev) * (gh / h)).to(torch.int64)
    xs = (torch.arange(w, device=dev) * (gw / w)).to(torch.int64)
    tgt_small = gt_masks[:, :, ys][:, :, :, xs].to(mask_logits.dtype)  # [B, NG, h, w]

    src_flat = mask_logits.reshape(b, nq, h * w)
    tgt_flat = tgt_small.reshape(b, tgt_small.shape[1], h * w)
    cost_mask = batch_sigmoid_focal_cost(src_flat, tgt_flat)
    cost_dice = batch_dice_cost(src_flat, tgt_flat)

    cost_center = torch.linalg.vector_norm(
        outputs["pred_centers"][:, :, None] - targets["gt_centers"][:, None], dim=-1)
    out_param, tgt_param = outputs["pred_params"], targets["gt_params"]
    cost_param = torch.abs(out_param[:, :, None] - tgt_param[:, None]).sum(dim=-1)
    cosv = torch.clamp(torch.einsum("bqc,bgc->bqg", normalize(out_param), normalize(tgt_param)),
                       -0.999999, 0.999999)
    cost_angle = torch.rad2deg(torch.arccos(cosv))
    out_off = torch.linalg.vector_norm(out_param, dim=-1)
    tgt_off = torch.linalg.vector_norm(tgt_param, dim=-1)
    cost_offset = torch.abs(out_off[:, :, None] - tgt_off[:, None])

    return (weights["cost_mask"] * cost_mask
            + weights["cost_class"] * cost_class
            + weights["cost_dice"] * cost_dice
            + weights["cost_center"] * cost_center
            + weights["cost_param"] * cost_param
            + weights["cost_param_offset"] * cost_offset
            + weights["cost_param_normal_angle"] * cost_angle)


def match_planes_multi(outputs_list: List[Dict], targets: Dict, weights: Dict) -> List[torch.Tensor]:
    """Hungarian matches [B, NQ] of several supervision levels, all their
    costs solved by one `hungarian` call on the costs' device (kernel H1 on
    the card): the match never leaves the device."""
    with torch.no_grad():
        cost = torch.cat([compute_match_cost(o, targets, weights) for o in outputs_list])
        num_gt = targets["gt_valid"].to(torch.int64).sum(dim=-1).repeat(len(outputs_list))
        return list(torch.chunk(hungarian(cost, num_gt), len(outputs_list)))


def mask_focal_dice(src, gt_masks, tgt_idx, matched):
    """Per-query focal mean and dice against the matched GT mask, through
    kernel B3: (focal_per [B, NQ], dice [B, NQ]) f32, dice zero where the
    query is unmatched."""
    gh, gw = gt_masks.shape[-2:]
    f_sum, inter, psum, tsum = fused_focal_dice(src, gt_masks, tgt_idx, matched)
    focal_per = f_sum / (gh * gw)
    dice = (1.0 - (2.0 * inter + 1.0) / (psum + tsum + 1.0)) * matched.to(torch.float32)
    return focal_per, dice


def _q_params_new(p):
    """n / d with n = p / |p| and d = |p|."""
    off = torch.clamp_min(safe_norm(p, dim=-1, keepdim=True), 1e-12)
    return p / off / off


def q_loss_segmap(src_p, match, targets):
    """Point-to-plane depth consistency (criterion.py:173-233) through the
    per-pixel GT-index map: GT masks are disjoint, so at most one matched
    plane is active at a pixel and its rescaled params (and the matched
    prediction's) are gathered by one einsum over the one-hot masks.
    src_p [B, NQ, 3]; match [B, NQ]."""
    gt_masks = targets["gt_masks"]  # [B, NG, H, W]
    b, ng = gt_masks.shape[:2]
    nq = src_p.shape[1]
    dev = src_p.device
    pts = targets["k_inv_dot_xy1"] * targets["depth"][:, None]  # [B, 3, H, W]

    # inverse permutation: inv[b, g] = query matched to GT g, or -1
    q_idx = torch.arange(nq, device=dev).expand(b, nq)
    inv = torch.full((b, ng), -1, dtype=torch.int64, device=dev)
    inv = inv.scatter_reduce(1, match.clamp_min(0), torch.where(match >= 0, q_idx, -1),
                             reduce="amax")
    active_g = (inv >= 0).to(torch.float32)  # [B, NG]

    gt_new_g = _q_params_new(targets["gt_params"]) * active_g[..., None]
    pr_new_g = torch.gather(_q_params_new(src_p), 1,
                            inv.clamp_min(0)[..., None].expand(-1, -1, 3)) * active_g[..., None]
    stack = torch.cat([gt_new_g, pr_new_g, active_g[..., None]], dim=-1)  # [B, NG, 7]
    px = torch.einsum("bnhw,bnc->bchw", gt_masks.to(torch.float32), stack)  # [B, 7, H, W]
    gt_px, pr_px, act_f = px[:, 0:3], px[:, 3:6], px[:, 6]

    gt_err_map = torch.abs((gt_px * pts).sum(dim=1) - 1.0) * act_f
    valid_region = (gt_err_map < 0.2) & (act_f > 0)
    pr_err_map = torch.abs((pr_px * pts).sum(dim=1) - 1.0) * act_f
    vr_f = valid_region.to(pr_err_map.dtype)
    per_img_sum = (pr_err_map * vr_f).sum(dim=(1, 2))
    per_img_cnt = vr_f.sum(dim=(1, 2))
    ok = (act_f.sum(dim=(1, 2)) >= 1) & (per_img_cnt > 0)
    per_img = torch.where(ok, per_img_sum / torch.clamp_min(per_img_cnt, 1.0),
                          torch.zeros_like(per_img_sum))
    return share_mean(per_img)


def detection_losses_siamese(outputs: Dict, targets: Dict, match: torch.Tensor,
                             eos_coef: float = 0.1, aux: bool = False) -> Dict[str, torch.Tensor]:
    """Detection losses of both views run as one 2B batch (view 0 first):
    each view normalised on its own, then the two averaged, as the
    reference's per-view criterion calls and (l0 + l1) / 2."""
    losses = {}
    logits = outputs["pred_logits"]  # [2B, NQ, C+1]
    b2, nq, nc1 = logits.shape
    b = b2 // 2
    matched = match >= 0
    tgt_idx = match.clamp_min(0)
    matched_f = matched.to(logits.dtype)

    def per_view_sum(x):  # [2B, ...] -> [2]
        return x.reshape(2, b, -1).sum(dim=(1, 2))

    # the normalisers of the global batch; max(., 1) applies to the global sum
    class_w = torch.where(matched, 1.0, eos_coef).to(logits.dtype)
    num_masks_v, num_matched_v, class_w_v = all_reduce_sum([
        per_view_sum(targets["gt_valid"].to(torch.float32)), per_view_sum(matched_f),
        per_view_sum(class_w)])
    num_masks_v = torch.clamp_min(num_masks_v, 1.0)
    num_matched_v = torch.clamp_min(num_matched_v, 1.0)

    # labels: weighted CE with the no-object weight
    target_classes = torch.where(matched, 0, nc1 - 1)
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), 2, target_classes[..., None])[..., 0]
    losses["loss_ce"] = (per_view_sum(nll * class_w) / class_w_v).mean()

    # masks: focal + dice on matched pairs (kernel B3)
    gt_masks = targets["gt_masks"]
    gh, gw = gt_masks.shape[-2:]
    focal_per, dice = mask_focal_dice(outputs["pred_mask_logits"], gt_masks, tgt_idx, matched)
    losses["loss_mask"] = (per_view_sum(focal_per * matched_f) / num_masks_v).mean()
    losses["loss_dice"] = (per_view_sum(dice * matched_f) / num_masks_v).mean()

    # centers
    tgt_c = torch.gather(targets["gt_centers"], 1, tgt_idx[..., None].expand(-1, -1, 2))
    dist = safe_norm(tgt_c - outputs["pred_centers"], dim=-1)
    losses["loss_center_ins"] = (per_view_sum(dist * matched_f) / num_matched_v).mean()
    if not aux:
        pc = F.interpolate(outputs["pixel_centers"], size=(gh, gw), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)  # [2B, H, W, 2]
        losses["loss_center_pixel"] = share_mean(safe_norm(
            torch.abs(targets["gt_pixel_centers"] - pc), dim=-1))

    # params: L1 + cos (+ Q on the final level)
    src_p = outputs["pred_params"]
    tgt_p = torch.gather(targets["gt_params"], 1, tgt_idx[..., None].expand(-1, -1, 3))
    l1 = torch.abs(tgt_p - src_p).sum(dim=-1)
    losses["loss_param_l1"] = (per_view_sum(l1 * matched_f) / num_matched_v).mean()
    na, nb = safe_norm(src_p, dim=-1), safe_norm(tgt_p, dim=-1)
    cos = 1 - (src_p * tgt_p).sum(dim=-1) / torch.clamp_min(na * nb, 1e-8)
    losses["loss_param_cos"] = (per_view_sum(cos * matched_f) / num_matched_v).mean()
    if not aux:
        losses["loss_q"] = q_loss_segmap(src_p, match, targets)
    return losses


def depth_loss_siamese(outputs: Dict, targets: Dict) -> torch.Tensor:
    """Masked L1 depth of both views run as one 2B batch (view 0 first), as
    the JAX package's `depth_loss_siamese`: the prediction
    ([2B, 1, h, w]) resized bilinearly (half-pixel centres, edge taps
    clamped, as the JAX package's bilinear `image.resize` upsamples) to the
    GT size, |pred - gt|
    summed where gt > 1e-4, each view over its own count (at least 1), then
    the two averaged. Across ranks the counts are the global batch's. The
    counts are exact sums rounded to the prediction's dtype, as the JAX
    package sums its mask in that dtype (a bf16 count of 2.4M pixels is off
    by up to 0.4%)."""
    gt = targets["depth"]  # [2B, H, W]
    b = gt.shape[0] // 2
    pred = F.interpolate(outputs["pixel_depth"], size=gt.shape[-2:], mode="bilinear",
                         align_corners=False)[:, 0]
    mask = (gt > 1e-4).to(pred.dtype)
    err = (torch.abs(pred - gt) * mask).reshape(2, b, -1).sum(dim=(1, 2))
    (cnt,) = all_reduce_sum([mask.to(torch.float32).reshape(2, b, -1).sum(dim=(1, 2))])
    return (err / torch.clamp_min(cnt.to(pred.dtype), 1.0)).mean()
