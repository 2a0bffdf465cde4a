"""PlaneTR_NopeSAC meta-architecture, inference path (counterpart of the JAX
package's `models/nopesac.py`): `detect`, `select_planes`, `inference` and
`camera_inference`, fixed-shape and batched.

Images come in already normalised, NCHW. `inference` returns the same dict
(keys, shapes and dtypes) as the JAX `PlaneTRNopeSAC.inference`. Left out:
the training forward and the `gt_geo` / `init_cam` ablations.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.assignment import mutual_max_assignment
from ..core.geometry import canonicalize_quat_sign, normalize
from ..ops.select import fused_select_maps
from .camera_head import PlaneCameraHead, build_geo_sequence, compute_sig_seq, warp_geo_sequence
from .matching_head import MatchingHead, geometric_distances
from .plane_head import PlaneTRHead
from .resnet import ResNet

OUT_CAM_TYPES = ("avg-all", "soft", "max-score", "min-cost")


def _split(d: Dict[str, torch.Tensor], sl: slice) -> Dict[str, torch.Tensor]:
    return {k: v[sl] for k, v in d.items()}


class PlaneTRNopeSAC(nn.Module):
    """Siamese plane detection + matching + NOPE-SAC pose estimation."""

    def __init__(self, image_size=(480, 640), num_queries: int = 50, embedding_on: bool = True,
                 camera_on: bool = True, cam_rec_on: bool = True, cam_ref_on: bool = True,
                 warp_plane_in_cam_ref_on: bool = True, sinkhorn_iterations: int = 200,
                 offset_multiplier: float = 4.0, normal_multiplier: float = 8.0,
                 plane_score_threshold: float = 0.6, mask_prob_threshold: float = 0.5,
                 overlap_threshold: float = 0.6, matching_score_threshold: float = 0.2,
                 inference_out_cam_type: str = "soft"):
        super().__init__()
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

        self.backbone = ResNet()
        self.sem_seg_head = PlaneTRHead(num_queries=num_queries)
        if embedding_on:
            self.matching_head = MatchingHead(offset_multiplier, normal_multiplier,
                                              sinkhorn_iterations)
        if camera_on:
            self.camera_head_list = nn.ModuleList([PlaneCameraHead(
                image_size, num_queries, cam_rec_on, cam_ref_on, warp_plane_in_cam_ref_on)])

    @property
    def camera_head(self) -> PlaneCameraHead:
        return self.camera_head_list[0]

    def detect(self, images):
        """Single-view backbone + plane head; images [B, 3, H, W] normalised."""
        feats = self.backbone(images)
        outputs, query_feat = self.sem_seg_head(feats)
        return feats, outputs, query_feat

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
        dt, dev = qf0.dtype, qf0.device
        cameras = {"camera_zero": {
            "tran": torch.zeros((b, 3), dtype=dt, device=dev),
            "rot": torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=dt, device=dev).repeat(b, 1),
        }}
        result = {}
        head = self.camera_head
        init = head.pixel_camera(feats_cat)
        init_rot = canonicalize_quat_sign(init["rot"])
        init_tran = init["tran"]
        cameras["camera_init"] = {"tran": init_tran, "rot": init_rot}

        if self.cam_rec_on:
            base_rot, base_rot_feat = head.rot_rec(init_rot)
            base_tran, base_tran_feat = head.trans_rec(init_tran)
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
