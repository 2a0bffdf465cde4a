"""NOPE-SAC camera head (counterpart of the JAX package's
`models/camera_head.py`; reference checkpoint names under
`camera_head_list.0.`): initial pose regression from a 4D correlation
volume, the pose auto-encoders (AIM) and one-plane pose-hypothesis
refinement with soft/avg fusion, all as fixed-shape masked tensor ops over
[B, NQ(+1), ...] with a `num_matches` vector.

The whole head computes in one dtype, MODEL.COMPUTE_DTYPE, in eval and in
train mode, as the JAX package's `PlaneCameraHead(dtype)`: every layer
casts its input, and the refinement's masks are built in it. Geometry on
f32 plane parameters warped by its poses promotes to f32, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.assignment import assignment_to_sequence
from ..core.geometry import (
    canonicalize_quat_sign,
    normalize,
    safe_norm,
    warp_planes_identity,
    warp_planes_to_global,
)
from .layers import MLP, Cast, Conv2d, Linear, conv_bn, conv_gn, set_compute_dtype, \
    upsample_nearest

CONV_STACK_BN_EPS = 1e-3
CONV_STACK_BN_MOMENTUM = 0.99
POSE_CONV_STRIDES = (1, 2, 1, 2, 1, 2)


def _nquat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion normalisation of regressor outputs (eps 1e-3, as the JAX
    package's `_nquat`)."""
    return normalize(q, eps=1e-3)


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def pose_grid(image_h: int, image_w: int) -> Tuple[int, Tuple[int, int]]:
    """(correlation channels, (h, w) of the pose stacks' output) of the
    PixelCameraHead for an input image size: res3 (stride 8, d2 stem +
    stride-2 3x3) pooled twice gives the correlation grid, whose cell count
    is the conv input width; the stride-2 convs of the pose stacks shrink it
    to the 128-channel grid that the fc layers flatten (NCHW)."""
    dims = []
    for n in (image_h, image_w):
        n = _conv_out(n, 7, 2, 3)          # stem conv
        n = _conv_out(n, 3, 2, 1)          # stem max pool
        n = _conv_out(n, 3, 2, 1)          # res3 stride
        n = (n // 2) // 2                  # convs_backbone's two 2x2 pools
        dims.append(n)
    corr_ch = dims[0] * dims[1]
    for s in POSE_CONV_STRIDES:
        dims = [_conv_out(n, 3, s, 1) for n in dims]
    return corr_ch, (dims[0], dims[1])


# ---------------------------------------------------------------------------
# geo sequence construction (pure functions)
# ---------------------------------------------------------------------------

def build_geo_sequence(params1, params2, assignment, max_matches: int):
    """Assignment [B, N1, N2] 0/1 -> matched plane-pair sequence
    (geo_seq [B, M, 6], valid [B, M] bool, num [B] int32), row-major order."""
    idx1, idx2, valid, num = assignment_to_sequence(assignment, max_matches)
    v = valid[..., None].to(params1.dtype)
    m1 = torch.gather(params1, 1, idx1.long()[..., None].expand(-1, -1, 3)) * v
    m2 = torch.gather(params2, 1, idx2.long()[..., None].expand(-1, -1, 3)) * v
    return torch.cat([m1, m2], dim=-1), valid, num


def build_gt_geo_sequence(gt_planes1, gt_planes2, corr_idx1, corr_idx2, corr_valid):
    """GT correspondences -> matched plane-pair sequence (geo [B, M, 6],
    valid [B, M] bool, num [B] int32). gt_planes1/2 [B, N, 3] zero-padded;
    corr_idx1/2 [B, M] (0 where invalid); corr_valid [B, M] bool."""
    m1 = torch.gather(gt_planes1, 1, corr_idx1.long()[..., None].expand(-1, -1, 3))
    m2 = torch.gather(gt_planes2, 1, corr_idx2.long()[..., None].expand(-1, -1, 3))
    v = corr_valid[..., None].to(gt_planes1.dtype)
    return (torch.cat([m1 * v, m2 * v], dim=-1), corr_valid,
            corr_valid.to(torch.int32).sum(dim=-1, dtype=torch.int32))


def warp_geo_sequence(geo_local, tran, quat):
    """Local matched-pair sequence [B, M, 6] -> global frame (zero padding
    stays zero)."""
    p1 = warp_planes_to_global(geo_local[..., :3], quat, tran)
    p2 = warp_planes_identity(geo_local[..., 3:])
    return torch.cat([p1, p2], dim=-1)


def compute_sig_seq(geo_local, tran, quat):
    """Sign sequence: compare the x component of the view-0 plane warped
    with and without translation -> [B, M, 1] of +-1."""
    with_t = warp_planes_to_global(geo_local[..., :3], quat, tran)
    without_t = warp_planes_to_global(geo_local[..., :3], quat, torch.zeros_like(tran))
    sig = (with_t[..., 0:1] * without_t[..., 0:1]) >= 0
    return (sig.to(geo_local.dtype) - 0.5) * 2.0


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class BasePixelDecoder(nn.Module):
    """MaskFormer FPN decoder over res3..res5, GN norm; output at res3
    resolution. Reference names: layer_3/adapter_2/layer_2/adapter_1/layer_1
    (res5, res4, res4, res3, res3) and mask_features."""

    def __init__(self, conv_dim: int = 256, mask_dim: int = 256):
        super().__init__()
        self.layer_3 = conv_gn(2048, conv_dim, 3)
        self.adapter_2 = conv_gn(1024, conv_dim, 1, relu=False)
        self.layer_2 = conv_gn(conv_dim, conv_dim, 3)
        self.adapter_1 = conv_gn(512, conv_dim, 1, relu=False)
        self.layer_1 = conv_gn(conv_dim, conv_dim, 3)
        self.mask_features = Conv2d(conv_dim, mask_dim, 3, padding=1)

    def forward(self, features: Dict[str, torch.Tensor]):
        y = self.layer_3(features["res5"])
        y = self.layer_2(self.adapter_2(features["res4"]) + upsample_nearest(y, 2))
        y = self.layer_1(self.adapter_1(features["res3"]) + upsample_nearest(y, 2))
        return self.mask_features(y)


def _conv_stack(in_ch, out_ch, strides, pool_after=()):
    """conv3x3 + BN(eps 1e-3, momentum 0.99) + LeakyReLU(0.01) per stride, a
    2x2 max pool after the listed convs (torch Sequential indices skip the
    pools)."""
    mods = []
    for i, s in enumerate(strides):
        mods.append(conv_bn(in_ch, out_ch, 3, stride=s, eps=CONV_STACK_BN_EPS,
                            momentum=CONV_STACK_BN_MOMENTUM, leaky=True))
        in_ch = out_ch
        if i in pool_after:
            mods.append(nn.MaxPool2d(2, 2))
    return nn.Sequential(*mods)


def compute_corr_softmax(f1, f2):
    """4D correlation volume with a softmax over view-2 positions.
    f1/f2: [B, C, H, W] -> [B, W2*H2, H1, W1]; the channel index is
    s = x2 * H2 + y2 (view 2 is transposed before the flatten)."""
    b, c, h2, w2 = f2.shape
    f2_vec = f2.transpose(2, 3).reshape(b, c, w2 * h2)  # [B, C, S]
    corr = torch.einsum("bcs,bchw->bshw", f2_vec, f1)
    return torch.softmax(corr, dim=1)


class PlaneCameraHead(Cast, nn.Module):
    """PixelCameraHead + AIM + PlaneCamRefHead, in `dtype`."""

    def __init__(self, image_size=(480, 640), num_queries: int = 50, cam_rec_on: bool = True,
                 cam_ref_on: bool = True, warp_plane_in_cam_ref_on: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cam_rec_on = cam_rec_on
        self.cam_ref_on = cam_ref_on
        self.warp_plane_in_cam_ref_on = warp_plane_in_cam_ref_on
        corr_ch, (gh, gw) = pose_grid(*image_size)
        fc_in = 128 * gh * gw
        self.pixel_decoder = BasePixelDecoder()
        self.convs_backbone = _conv_stack(256, 256, (1,) * 6, pool_after=(1, 3))
        self.convs_trans = _conv_stack(corr_ch, 128, POSE_CONV_STRIDES)
        self.convs_rots = _conv_stack(corr_ch, 128, POSE_CONV_STRIDES)
        self.fc_trans = Linear(fc_in, 256)
        self.fc_rots = Linear(fc_in, 256)
        self.trans = Linear(256, 3)
        self.rots = Linear(256, 4)
        if cam_rec_on:
            self.rot_emb_proj = MLP(4, 256, 256, 6)
            self.trans_emb_proj = MLP(3, 256, 256, 6)
        if cam_ref_on:
            self.geo_encoder = MLP(8, 1024, 1024, 6)
            self.geo_proj_s1 = MLP(1024, 1024, 1024, 3)
            self.decoder_rot = MLP(1024, 512, 256, 6)
            self.geo_proj_s2 = MLP(1024 + 256, 1024, 1024, 3)
            self.decoder_tran = MLP(1024, 512, 256, 6)
            self.decoder_rot2 = MLP(512, 512, 256, 3)
            self.decoder_tran2 = MLP(512, 512, 256, 3)
            self.normal_score_proj = MLP(num_queries, 128, 64, 3)
            self.rot_score_reg = Linear(64, 1)
            self.param_score_proj = MLP(num_queries, 128, 64, 3)
            self.trans_score_reg = Linear(64, 1)
        set_compute_dtype(self, dtype)

    # -- Pose Regression Network (initial pose) ---------------------------
    def pixel_camera(self, features_cat: Dict[str, torch.Tensor]):
        """Initial pose from the correlation volume. features_cat holds both
        views concatenated along the batch (view 0 first)."""
        x = self.convs_backbone(self.pixel_decoder(features_cat))
        b = x.shape[0] // 2
        aff = compute_corr_softmax(x[:b], x[b:])
        trans_feat = F.relu(self.fc_trans(self.convs_trans(aff).flatten(1)))
        rots_feat = F.relu(self.fc_rots(self.convs_rots(aff).flatten(1)))
        return {"tran": self.trans(trans_feat), "rot": _nquat(self.rots(rots_feat)),
                "tran_feat": trans_feat, "rot_feat": rots_feat}

    # -- Arbitrary Initialization Module (pose auto-encoders) -------------
    def rot_rec(self, input_rot):
        """Rotation auto-encoder on the detached, sign-canonicalised input;
        returns (pred_rot, rot_feat, that input)."""
        input_rot = canonicalize_quat_sign(input_rot).detach()
        rot_feat = F.relu(self.rot_emb_proj(input_rot))
        return _nquat(self.rots(rot_feat)), rot_feat, input_rot

    def trans_rec(self, input_trans):
        """Translation auto-encoder on the detached input (+ 1e-10); returns
        (pred_trans, trans_feat, that input)."""
        input_trans = input_trans.detach() + 1e-10
        trans_feat = F.relu(self.trans_emb_proj(input_trans))
        return self.trans(trans_feat), trans_feat, input_trans

    # -- NOPE-SAC refinement ----------------------------------------------
    def refine(self, initial_trans_feat, initial_rot_feat, initial_trans, initial_rot,
               geo_local, seq_valid, sig_seq, geo_global, clamp_scores: bool = False):
        """One-plane pose hypotheses + scoring + soft/avg fusion.

        initial_*_feat [B, 256]; initial_trans [B, 3]; initial_rot [B, 4];
        geo_local/geo_global [B, M, 6]; seq_valid [B, M] bool; sig_seq [B, M, 1].
        Hypothesis h=0 is the initial pose, h=i+1 comes from match i.
        clamp_scores (training) clips the hypothesis softmax to [0.01, 0.9]
        and renormalises it.
        """
        b, max_n, _ = geo_local.shape
        dt = self.compute_dtype()
        hyp_valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=geo_local.device),
                               seq_valid], dim=1)  # [B, M+1]
        matching_mask = (hyp_valid[:, :, None] & seq_valid[:, None, :]).to(dt)  # [B, M+1, M]
        mask_col0 = matching_mask[:, :, 0:1]  # [B, M+1, 1]

        # ---- geo encoding
        geo_src = geo_global if self.warp_plane_in_cam_ref_on else geo_local
        g0, g1 = geo_src[..., :3], geo_src[..., 3:]
        off0 = safe_norm(g0, dim=-1, keepdim=True)
        nrm0 = g0 / (off0 + 1e-10)
        off1 = safe_norm(g1, dim=-1, keepdim=True)
        nrm1 = g1 / (off1 + 1e-10)
        if self.warp_plane_in_cam_ref_on:
            off0 = off0 * sig_seq
            nrm0 = nrm0 * sig_seq
        geo_fea = self.geo_encoder(torch.cat([nrm0, off0, nrm1, off1], dim=-1))  # [B, M, 8]
        geo_s1 = self.geo_proj_s1(geo_fea)
        geo_rot = self.decoder_rot(geo_s1)  # [B, M, 256]
        geo_tran = self.decoder_tran(self.geo_proj_s2(torch.cat([geo_s1, geo_rot], dim=-1)))

        # ---- per-match pose hypotheses
        init_rf = initial_rot_feat[:, None, :].expand(b, max_n, -1)
        init_tf = initial_trans_feat[:, None, :].expand(b, max_n, -1)
        fused_rot_feat = F.relu(self.decoder_rot2(torch.cat([init_rf, geo_rot], -1)))
        fused_tran_feat = F.relu(self.decoder_tran2(torch.cat([init_tf, geo_tran], -1)))
        rots_all = torch.cat([initial_rot[:, None, :], _nquat(self.rots(fused_rot_feat))], dim=1)
        trans_all = torch.cat([initial_trans[:, None, :], self.trans(fused_tran_feat)], dim=1)

        # ---- consistency distances over [B, M+1, M, 3] warped planes
        plane0 = geo_local[:, None, :, :3]  # [B, 1, M, 3]
        plane1_mid = warp_planes_identity(geo_local[..., 3:])[:, None]  # [B, 1, M, 3]
        plane0_r = warp_planes_to_global(plane0, rots_all, torch.zeros_like(trans_all))
        n1_r = normalize(plane1_mid)
        normal_l2 = safe_norm(normalize(plane0_r) - n1_r, dim=-1) * matching_mask
        score_normal = torch.exp(-normal_l2) * matching_mask  # [B, M+1, M]
        rot_score_logit = self.rot_score_reg(self.normal_score_proj(score_normal))  # [B, M+1, 1]

        plane0_rt = warp_planes_to_global(plane0, rots_all, trans_all)  # [B, M+1, M, 3]
        l2_dist = safe_norm(plane0_rt - plane1_mid, dim=-1)  # [B, M+1, M]
        l2_masked = torch.exp(-l2_dist * matching_mask) * matching_mask
        trans_score_logit = self.trans_score_reg(self.param_score_proj(l2_masked))

        # ---- masked softmax over the valid hypotheses (dim 1)
        def masked_softmax(logit):
            logit = torch.where(hyp_valid[:, :, None], logit, -float("inf"))
            s = torch.softmax(logit, dim=1)
            if not clamp_scores:
                return s * mask_col0
            s = torch.clamp(s, 0.01, 0.9) * mask_col0
            return s / (s.sum(dim=1, keepdim=True) + 1e-10)

        score_rot = masked_softmax(rot_score_logit)  # [B, M+1, 1]
        score_trans = masked_softmax(trans_score_logit)
        score_avg = mask_col0 / (mask_col0.sum(dim=1, keepdim=True) + 1e-10)

        def fuse(feats_all, init_feat, score, include_initial):
            if include_initial:
                stacked = torch.cat([init_feat[:, None, :], feats_all], dim=1)
                return (stacked * score).sum(dim=1)
            s = score[:, 1:]
            s = s / (s.sum(dim=1, keepdim=True) + 1e-10)
            return (feats_all * s).sum(dim=1)

        return {
            "trans_all": trans_all,  # [B, M+1, 3]
            "rots_all": rots_all,  # [B, M+1, 4]
            "score_rot": score_rot[..., 0],  # [B, M+1]
            "score_trans": score_trans[..., 0],
            "hyp_valid": hyp_valid,
            "l2_dist": l2_dist,  # [B, M+1, M]
            "normal_l2_sum": normal_l2.sum(dim=-1),  # [B, M+1]
            "l2_dist_sum": (l2_dist * matching_mask).sum(dim=-1),
            "tran_soft": self.trans(fuse(fused_tran_feat, initial_trans_feat, score_trans, True)),
            "rot_soft": _nquat(self.rots(fuse(fused_rot_feat, initial_rot_feat, score_rot, True))),
            "tran_avg_excl": self.trans(fuse(fused_tran_feat, initial_trans_feat, score_avg, False)),
            "rot_avg_excl": _nquat(self.rots(fuse(fused_rot_feat, initial_rot_feat, score_avg,
                                                  False))),
            "tran_avg_incl": self.trans(fuse(fused_tran_feat, initial_trans_feat, score_avg, True)),
            "rot_avg_incl": _nquat(self.rots(fuse(fused_rot_feat, initial_rot_feat, score_avg,
                                                  True))),
        }
