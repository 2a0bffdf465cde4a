"""PlaneTR_NopeSAC meta-architecture (counterpart of the JAX package's
`models/nopesac.py`): `detect`, `select_planes`, `inference`,
`camera_inference` and `train_forward`, fixed-shape and batched.

`inference` takes normalised NCHW images and returns the same dict (keys,
shapes and dtypes) as the JAX `PlaneTRNopeSAC.inference`. `train_forward`
takes a collated training batch (NHWC images, as the JAX package's) and
returns the same dict of weighted losses as the JAX `train_forward`. Left
out: the `gt_geo` / `init_cam` ablations and the depth branch.

`dtype` (MODEL.COMPUTE_DTYPE), `backbone_train_dtype` and `fpn_train_dtype`
place each part in its dtype as the JAX model does (the backbone, the plane
head's pixel path and the camera head follow them; the transformer, the
query-side heads and the matching head stay f32); parameters stay f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.assignment import mutual_max_assignment
from ..core.geometry import canonicalize_quat_sign, normalize
from ..data.packing import unpack_targets
from ..losses import camera_losses as CL
from ..losses.criterion import detection_losses_siamese, match_planes_multi
from ..losses.matching import build_pred_corr_matrix, intersect_with_valid, matching_nll_loss
from ..ops.select import fused_select_maps
from ..parallel.dist import world_size
from .camera_head import (
    PlaneCameraHead,
    build_geo_sequence,
    build_gt_geo_sequence,
    compute_sig_seq,
    warp_geo_sequence,
)
from .matching_head import MatchingHead, geometric_distances
from .plane_head import PlaneTRHead
from .resnet import ResNet

OUT_CAM_TYPES = ("avg-all", "soft", "max-score", "min-cost")
AIM_RAND_POSES = 64  # random poses per step for the AIM auto-encoders (at least one per pair)


def _split(d: Dict[str, torch.Tensor], sl: slice) -> Dict[str, torch.Tensor]:
    return {k: v[sl] for k, v in d.items()}


@dataclass
class TrainSettings:
    """Loss switches and weights of `train_forward` (the JAX model's training
    fields; `build_model_from_cfg` fills them from a config)."""

    loss_detection_on: bool = True
    loss_camera_on: bool = True
    loss_matching_on: bool = True
    matcher_on: bool = True
    rand_on: bool = True
    no_object_weight: float = 0.1
    dice_weight: float = 1.0
    mask_weight: float = 20.0
    param_weight_l1: float = 0.25
    param_weight_cos: float = 1.0
    param_hm_weight_l1: float = 0.25
    param_weight_q: float = 1.0
    center_ins_weight: float = 0.5
    param_weight_angle: float = 0.0028
    param_weight_offset: float = 0.01
    initial_cam_weight: float = 1.0
    plane_cam_weight: float = 1.0
    plane_cam_weight_predplane: float = 0.1

    def match_cost_weights(self) -> Dict[str, float]:
        """The weights of the Hungarian matcher's cost terms."""
        return {"cost_class": 1.0, "cost_mask": self.mask_weight, "cost_dice": self.dice_weight,
                "cost_center": self.center_ins_weight, "cost_param": self.param_hm_weight_l1,
                "cost_param_offset": self.param_weight_offset,
                "cost_param_normal_angle": self.param_weight_angle}


class PlaneTRNopeSAC(nn.Module):
    """Siamese plane detection + matching + NOPE-SAC pose estimation."""

    def __init__(self, image_size=(480, 640), num_queries: int = 50, embedding_on: bool = True,
                 camera_on: bool = True, cam_rec_on: bool = True, cam_ref_on: bool = True,
                 warp_plane_in_cam_ref_on: bool = True, sinkhorn_iterations: int = 200,
                 offset_multiplier: float = 4.0, normal_multiplier: float = 8.0,
                 plane_score_threshold: float = 0.6, mask_prob_threshold: float = 0.5,
                 overlap_threshold: float = 0.6, matching_score_threshold: float = 0.2,
                 inference_out_cam_type: str = "soft", transformer_dropout: float = 0.1,
                 train_settings: Optional[TrainSettings] = None, fuse_tail: bool = False,
                 dtype: torch.dtype = torch.float32,
                 backbone_train_dtype: torch.dtype = torch.float32,
                 fpn_train_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.train_settings = train_settings or TrainSettings()
        if inference_out_cam_type not in OUT_CAM_TYPES:
            raise ValueError(f"INFERENCE_OUT_CAM_TYPE must be one of {OUT_CAM_TYPES}, "
                             f"got {inference_out_cam_type!r}")
        if num_queries > 127:
            raise ValueError(f"seg_gated is int8, so at most 127 queries fit; got {num_queries}")
        self.num_queries = num_queries
        self.embedding_on = embedding_on
        self.camera_on = camera_on
        self.cam_rec_on = cam_rec_on
        self.cam_ref_on = cam_ref_on
        self.plane_score_threshold = plane_score_threshold
        self.mask_prob_threshold = mask_prob_threshold
        self.overlap_threshold = overlap_threshold
        self.matching_score_threshold = matching_score_threshold
        self.inference_out_cam_type = inference_out_cam_type

        self.backbone = ResNet(fuse_tail=fuse_tail, dtype=dtype, train_dtype=backbone_train_dtype,
                               remat=remat)
        self.sem_seg_head = PlaneTRHead(num_queries=num_queries, dropout=transformer_dropout,
                                        dtype=dtype, fpn_train_dtype=fpn_train_dtype)
        if embedding_on:
            self.matching_head = MatchingHead(offset_multiplier, normal_multiplier,
                                              sinkhorn_iterations)
        if camera_on:
            self.camera_head_list = nn.ModuleList([PlaneCameraHead(
                image_size, num_queries, cam_rec_on, cam_ref_on, warp_plane_in_cam_ref_on,
                dtype=dtype)])

    @property
    def camera_head(self) -> PlaneCameraHead:
        return self.camera_head_list[0]

    def detect(self, images, gen: Optional[torch.Generator] = None):
        """Backbone + plane head; images [B, 3, H, W] normalised. `gen`
        drives the transformer's dropout (None: no dropout)."""
        feats = self.backbone(images)
        outputs, query_feat = self.sem_seg_head(feats, gen)
        return feats, outputs, query_feat

    def bn_stats_forward(self, images0, images1, gen: Optional[torch.Generator] = None) -> None:
        """The train-mode forward that reaches every trainable BatchNorm (the
        plane head's top-down decoder, the camera conv stacks) on both views
        concatenated, NHWC as in a training batch: detect, then the
        PixelCameraHead when the camera is on. Each BN layer updates its
        running statistics from this batch; precise-BN reads them."""
        if not self.training:
            raise RuntimeError("bn_stats_forward needs the model in train mode (model.train())")
        images = torch.cat([images0, images1]).permute(0, 3, 1, 2).contiguous()
        feats, _, _ = self.detect(images, gen)
        if self.camera_on:
            self.camera_head.pixel_camera(feats)

    # ------------------------------------------------------------------
    def train_forward(self, batch: Dict, gen: Optional[torch.Generator] = None,
                      aim_rot: Optional[torch.Tensor] = None,
                      aim_trans: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Training forward: detection over every supervision level, matching
        and the NOPE-SAC camera loss zoo; returns the dict of weighted scalar
        losses (across ranks, this rank's shares of the global batch's
        losses, which sum to them). The model must be in train mode (batch-statistics BN).

        batch: image0/image1 [B, H, W, 3] normalised f32, targets0/targets1
        (wire format or unpacked), gt_pose [B, 7], corr_idx1/2 [B, NQ],
        corr_valid [B, NQ]. `gen` (on the model's device) draws the dropout
        masks and the AIM random poses; `aim_rot` [N, 4] / `aim_trans` [N, 3]
        replace the random poses when given (N = B * max(AIM_RAND_POSES // (B * world), 1),
        world the number of ranks).

        Both views run as one 2B batch, so trainable BN pools its statistics
        over both views, as in the JAX package. All refinement branches run
        as one K*B refine call.
        """
        if not self.training:
            raise RuntimeError("train_forward needs the model in train mode (model.train())")
        st = self.train_settings
        losses: Dict[str, torch.Tensor] = {}
        t0, t1 = unpack_targets(batch["targets0"]), unpack_targets(batch["targets1"])
        b = batch["image0"].shape[0]
        loss_weights = {
            "loss_ce": 1.0, "loss_param_l1": st.param_weight_l1,
            "loss_param_cos": st.param_weight_cos, "loss_q": st.param_weight_q,
            "loss_center_ins": st.center_ins_weight, "loss_center_pixel": 1.0,
            "loss_mask": st.mask_weight, "loss_dice": st.dice_weight,
        }
        images = torch.cat([batch["image0"], batch["image1"]]).permute(0, 3, 1, 2).contiguous()
        targets = {k: torch.cat([t0[k], t1[k]]) for k in t0}
        feats, out, qf = self.detect(images, gen)

        # one host solve for the final and every aux supervision level
        aux_list = list(out["aux_outputs"]) if st.loss_detection_on else []
        matches = match_planes_multi([out] + aux_list, targets, st.match_cost_weights())
        match = matches[0]
        if st.loss_detection_on:
            raw = detection_losses_siamese(out, targets, match, eos_coef=st.no_object_weight)
            losses.update({k: v * loss_weights[k] for k, v in raw.items()})
            for i, (aux, match_aux) in enumerate(zip(aux_list, matches[1:])):
                raw = detection_losses_siamese(aux, targets, match_aux,
                                               eos_coef=st.no_object_weight, aux=True)
                losses.update({f"{k}_{i}": v * loss_weights[k] for k, v in raw.items()})

        match0, match1 = match[:b], match[b:]
        qf0, qf1 = qf[:b], qf[b:]
        gt_pose = batch["gt_pose"]
        params0, params1 = out["pred_params"][:b], out["pred_params"][b:]
        corr = (batch["corr_idx1"], batch["corr_idx2"], batch["corr_valid"])

        gt_corr = None
        if self.embedding_on and st.matcher_on:
            gt_corr = build_pred_corr_matrix(match0, match1, *corr, self.num_queries)
            if st.loss_matching_on:
                rows, cols = match0 >= 0, match1 >= 0
                log_scores = self.matching_head(qf0, qf1, gt_pose, params0, params1,
                                                row_masks=rows, col_masks=cols, training=True)
                losses["losses_emb_0"] = matching_nll_loss(
                    log_scores, intersect_with_valid(gt_corr, rows, cols))

        if not (self.camera_on and st.loss_camera_on):
            return losses
        head = self.camera_head
        init = head.pixel_camera(feats)
        lt, lr = CL.camera_pose_loss(init["tran"], init["rot"], gt_pose)
        losses["loss_tran_pixelReg"] = lt * st.initial_cam_weight
        losses["loss_rot_pixelReg"] = lr * st.initial_cam_weight

        # AIM: auto-encoding of the initial pose, then of random poses
        if self.cam_rec_on:
            rec_rot, rec_rot_feat, rot_in = head.rot_rec(init["rot"])
            losses["loss_rot_initCamRec"] = CL.rot_rec_loss(rot_in, rec_rot)
            rec_tran, rec_tran_feat, tran_in = head.trans_rec(init["tran"])
            losses["loss_trans_initCamRec"] = CL.trans_rec_loss(tran_in, rec_tran)
        if self.cam_rec_on and st.rand_on:
            # the JAX step's count on the global batch, split evenly
            n = b * max(AIM_RAND_POSES // (b * world_size()), 1)
            if (aim_rot is None or aim_trans is None) and gen is None:
                raise ValueError("the AIM random poses need a generator or injected poses")
            if aim_rot is None:
                aim_rot = CL.rand_aim_rot(gen, n, images.device)
            if aim_trans is None:
                aim_trans = CL.rand_aim_trans(gen, n, images.device)
            pr_rot, _, rin = head.rot_rec(aim_rot)
            losses["loss_rot_randCamRecLBS_N1"] = CL.rot_rec_loss(rin, pr_rot)
            pr_tr, _, tin = head.trans_rec(aim_trans)
            losses["loss_trans_randCamRecLBS_N1"] = CL.trans_rec_loss(tin, pr_tr)

        if not self.cam_ref_on:
            return losses
        geo_gt, valid_gt, num_gt = build_gt_geo_sequence(t0["gt_params"], t1["gt_params"], *corr)
        branches = [dict(tran=init["tran"], rot=init["rot"], tf=init["tran_feat"],
                         rf=init["rot_feat"], geo=geo_gt, valid=valid_gt, num=num_gt,
                         suffix="initCamRef", weight=st.plane_cam_weight)]
        if self.cam_rec_on:
            branches.append(dict(tran=rec_tran, rot=rec_rot, tf=rec_tran_feat, rf=rec_rot_feat,
                                 geo=geo_gt, valid=valid_gt, num=num_gt,
                                 suffix="initRecCamRef", weight=st.plane_cam_weight))
        if gt_corr is not None:
            geo_pr, valid_pr, num_pr = build_geo_sequence(
                params0, params1, gt_corr[:, :-1, :-1].to(params0.dtype), self.num_queries)
            branches.append(dict(tran=init["tran"], rot=init["rot"], tf=init["tran_feat"],
                                 rf=init["rot_feat"], geo=geo_pr, valid=valid_pr, num=num_pr,
                                 suffix="initCamRef_Aux", weight=st.plane_cam_weight_predplane))
            if self.cam_rec_on:
                branches.append(dict(tran=rec_tran, rot=rec_rot, tf=rec_tran_feat,
                                     rf=rec_rot_feat, geo=geo_pr, valid=valid_pr, num=num_pr,
                                     suffix="initRecCamRef_Aux",
                                     weight=st.plane_cam_weight_predplane))

        def cat(key):
            return torch.cat([br[key] for br in branches])

        tran_c, rot_c, geo_c = cat("tran"), cat("rot"), cat("geo")
        # the base pose is detached for the geo warp and the sign trick
        geo_global = warp_geo_sequence(geo_c, tran_c.detach(), rot_c.detach())
        sig_seq = compute_sig_seq(geo_c, tran_c.detach(), rot_c.detach())
        ref = head.refine(cat("tf"), cat("rf"), tran_c, rot_c, geo_c, cat("valid"), sig_seq,
                          geo_global, clamp_scores=True)
        for k, br in enumerate(branches):
            ref_k = {key: val[k * b:(k + 1) * b] for key, val in ref.items()}
            losses.update(CL.refine_losses(ref_k, gt_pose, br["valid"], br["num"], br["suffix"],
                                           br["weight"]))
        return losses

    # ------------------------------------------------------------------
    def select_planes(self, outputs: Dict[str, torch.Tensor], out_h: int, out_w: int):
        """Device half of the reference's plane postprocess, fixed-shape.

        Returns valid [B, NQ] bool, score [B, NQ], params [B, NQ, 3],
        seg_gated [B, H, W] int8 (query id where the prob gate passes, -1
        elsewhere) and centers [B, NQ, 2]. Three regimes: normal (surviving
        keeps, gated masks); zero-detection (the single most plane-like
        query, no overlap filter, gate kept, pixel (0, 0) forced on when its
        gated mask is empty); all-filtered (the max-overlap valid query with
        the ungated argmax mask, ties to the first index).
        """
        logits = outputs["pred_logits"]  # [B, NQ, 2]
        params = outputs["pred_params"]  # [B, NQ, 3]
        b, nq, _ = logits.shape

        prob = torch.softmax(logits, dim=-1)
        score = prob.amax(dim=-1)  # [B, NQ]
        labels = torch.argmax(prob, dim=-1)
        label_mask = (labels == 0) & (score > self.plane_score_threshold)

        # zero-detection fallback: keep the most plane-like query
        any_valid = label_mask.any(dim=1, keepdim=True)  # [B, 1]
        fallback = F.one_hot(torch.argmax(prob[..., 0], dim=1), nq).bool()
        valid = torch.where(any_valid, label_mask, fallback)
        score = torch.where(valid & ~label_mask, prob[..., 0], score)

        # kernel B1: upsample + argmax over valid queries + per-query stats
        seg_ids, max_scaled, stats = fused_select_maps(
            torch.sigmoid(outputs["pred_mask_logits"]), score, valid,
            float(self.mask_prob_threshold), out_h, out_w)
        (cnt_gate, sumx_gate, sumy_gate,
         cnt_nogate, sumx_nogate, sumy_nogate, orig_cnt) = stats.unbind(dim=1)

        # overlap filter
        mask_area = cnt_gate * valid  # argmax winners are always valid
        overlap = mask_area / torch.clamp_min(orig_cnt, 1)
        nonempty = (mask_area >= 1) & (orig_cnt >= 1)
        keep = nonempty & (overlap >= self.overlap_threshold) & valid

        ov_for_max = torch.where(nonempty, overlap, overlap.new_tensor(-1.0))
        ov_for_max = torch.where(valid, ov_for_max, overlap.new_tensor(-2.0))
        fallback2 = F.one_hot(torch.argmax(ov_for_max, dim=1), nq).bool()
        any_keep = keep.any(dim=1, keepdim=True)
        zero_case = ~any_valid  # [B, 1]
        final_valid = torch.where(any_keep, keep, fallback2 & valid)
        final_valid = torch.where(zero_case, valid, final_valid)
        gated_c = any_keep | zero_case  # [B, 1]
        gate = (max_scaled > self.mask_prob_threshold) | ~gated_c[:, :, None]
        # zero-detection with an empty gated mask: pixel (0, 0) is forced on
        zero_empty = zero_case[:, 0] & (torch.where(valid, cnt_gate, 0.0).sum(dim=1) < 1)
        gate[:, 0, 0] |= zero_empty

        # plane centers from normalised xy over the final mask
        area = torch.where(gated_c, cnt_gate, cnt_nogate)
        cx = torch.where(gated_c, sumx_gate, sumx_nogate) / (area + 1e-10)
        cy = torch.where(gated_c, sumy_gate, sumy_nogate) / (area + 1e-10)
        centers = torch.stack([cx, cy], dim=-1) * final_valid[:, :, None]

        seg_gated = torch.where(gate, seg_ids, torch.full_like(seg_ids, -1)).to(torch.int8)
        return {"valid": final_valid, "score": score, "params": params,
                "seg_gated": seg_gated, "centers": centers}

    def inference(self, images0, images1, out_h: int = 480, out_w: int = 640):
        """Full inference on normalised NCHW images [B, 3, H, W] of each view."""
        feats_cat, out_cat, qf_cat = self.detect(torch.cat([images0, images1], dim=0))
        return self.inference_from_detections(feats_cat, out_cat, qf_cat, out_h, out_w)

    def inference_from_detections(self, feats_cat, out_cat, qf_cat, out_h: int, out_w: int):
        """The rest of `inference` on `detect`'s outputs for both views
        stacked view 0 then view 1: select_planes, then camera_inference."""
        b = qf_cat.shape[0] // 2
        sel_cat = self.select_planes(out_cat, out_h, out_w)
        sel0, sel1 = _split(sel_cat, slice(None, b)), _split(sel_cat, slice(b, None))
        result = {"view0": sel0, "view1": sel1}
        if not self.camera_on:
            return result
        result.update(self.camera_inference(
            feats_cat, qf_cat[:b], qf_cat[b:], sel0["params"], sel1["params"],
            sel0["valid"], sel1["valid"]))
        return result

    def camera_inference(self, feats_cat, qf0, qf1, params0, params1, valid0, valid1):
        """Initial pose, AIM, matching, NOPE-SAC refinement, assignment
        re-gating and the camera dict zoo."""
        b = qf0.shape[0]
        head = self.camera_head
        dt, dev = head.compute_dtype(), qf0.device
        cameras = {"camera_zero": {
            "tran": torch.zeros((b, 3), dtype=dt, device=dev),
            "rot": torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=dt, device=dev).repeat(b, 1),
        }}
        result = {}
        init = head.pixel_camera(feats_cat)
        init_rot = canonicalize_quat_sign(init["rot"])
        init_tran = init["tran"]
        cameras["camera_init"] = {"tran": init_tran, "rot": init_rot}

        if self.cam_rec_on:
            base_rot, base_rot_feat, _ = head.rot_rec(init_rot)
            base_tran, base_tran_feat, _ = head.trans_rec(init_tran)
            cameras["camera_initRec"] = {"tran": base_tran, "rot": base_rot}
        else:
            base_rot, base_rot_feat = init_rot, init["rot_feat"]
            base_tran, base_tran_feat = init_tran, init["tran_feat"]

        if not self.embedding_on:
            cameras["camera"] = cameras["camera_init"]
            result["cameras"] = cameras
            return result

        # ---- plane matching with the reconstructed pose as geometric prior
        matcher_cam = torch.cat([base_tran, base_rot], dim=-1)  # [B, 7]
        log_scores = self.matching_head(qf0, qf1, matcher_cam, params0, params1,
                                        row_masks=valid0, col_masks=valid1)
        assignment = mutual_max_assignment(log_scores, self.matching_score_threshold)
        result["log_scores"] = log_scores
        result["assignment_beforeRef"] = assignment

        if not self.cam_ref_on:
            cameras["camera"] = cameras["camera_init"]
            result["cameras"] = cameras
            result["assignment"] = assignment
            return result

        # ---- NOPE-SAC refinement
        geo_local, seq_valid, num_matches = build_geo_sequence(
            params0, params1, assignment, self.num_queries)
        geo_global = warp_geo_sequence(geo_local, base_tran, base_rot)
        sig_seq = compute_sig_seq(geo_local, base_tran, base_rot)
        ref = head.refine(base_tran_feat, base_rot_feat, base_tran, base_rot,
                          geo_local, seq_valid, sig_seq, geo_global)

        # m <= 1 fallbacks: m == 0 -> initial pose; m == 1 -> avg(excl) pose
        m = num_matches[:, None]
        rot_avg = torch.where(m > 1, ref["rot_avg_incl"], ref["rot_avg_excl"])
        tran_avg = torch.where(m > 1, ref["tran_avg_incl"], ref["tran_avg_excl"])
        rot_avg = torch.where(m == 0, base_rot, rot_avg)
        tran_avg = torch.where(m == 0, base_tran, tran_avg)

        kind = self.inference_out_cam_type
        if kind == "avg-all":
            rot_f, tran_f = rot_avg, tran_avg
        elif kind == "soft":
            rot_f, tran_f = ref["rot_soft"], ref["tran_soft"]
        else:
            hv = ref["hyp_valid"]
            if kind == "max-score":
                ninf = ref["score_rot"].new_tensor(-float("inf"))
                ridx = torch.argmax(torch.where(hv, ref["score_rot"], ninf), dim=1)
                tidx = torch.argmax(torch.where(hv, ref["score_trans"], ninf), dim=1)
            else:  # "min-cost"
                inf = ref["normal_l2_sum"].new_tensor(float("inf"))
                ridx = torch.argmin(torch.where(hv, ref["normal_l2_sum"], inf), dim=1)
                tidx = torch.argmin(torch.where(hv, ref["l2_dist_sum"], inf), dim=1)
            rows = torch.arange(b, device=dev)
            rot_f = ref["rots_all"][rows, ridx]
            tran_f = ref["trans_all"][rows, tidx]

        rot_f = torch.where(m <= 1, rot_avg, rot_f)
        tran_f = torch.where(m <= 1, tran_avg, tran_f)
        # exact unit quaternions at inference (F.normalize semantics, eps 1e-12)
        rot_f = normalize(rot_f)
        rot_avg = normalize(rot_avg)
        cameras["camera_avgRef0"] = {"tran": tran_avg, "rot": rot_avg}
        cameras["camera_softRef0"] = {"tran": tran_f, "rot": rot_f}

        # sign flip before the pose-consistency re-gating of the assignment
        if self.cam_rec_on:
            rot_for_gate = torch.where(rot_f[:, 0:1] < 0, -rot_f, rot_f)
        else:
            rot_for_gate = rot_f
        normal_dist, offset_dist = geometric_distances(params0, params1, tran_f, rot_for_gate)
        gate = (normal_dist < 45.0) & (torch.clamp(offset_dist, 1e-4, 10.0) < 1.0)
        result["assignment"] = assignment * gate.to(assignment.dtype)

        cameras["camera"] = {"tran": tran_f, "rot": rot_f}
        result["cameras"] = cameras
        result["camera_onePP"] = {
            "tran": ref["trans_all"], "rot": ref["rots_all"], "hyp_valid": ref["hyp_valid"],
            "score_rot": ref["score_rot"], "score_trans": ref["score_trans"],
        }
        result["num_matches"] = num_matches
        return result
