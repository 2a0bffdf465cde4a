"""The reference model and train step from a configuration's `cfg` tree
(the port's `engine/predict.py:build_model_from_cfg` and
`engine/train.py:TrainStep`, for one process)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .engine.optimizer import apply_freeze, build_optimizer, clip_by_global_norm_, \
    make_lr_schedule, set_lr
from .models.layers import BatchNorm2d
from .models.nopesac import PlaneTRNopeSAC, TrainSettings
from .utils.device import resolve_dtype


class Cfg(dict):
    """A nested dict read by attribute, as the model code reads a config."""

    def __init__(self, tree: dict):
        super().__init__({k: Cfg(v) if isinstance(v, dict) else v for k, v in tree.items()})

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def set_precision(tf32: bool = False) -> None:
    """Full-f32 matmuls and convolutions (TF32 off) and bf16 GEMMs that
    accumulate in f32, as the configurations state; `tf32` turns TF32 on
    (the eval cells' control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_model(cfg: Cfg) -> PlaneTRNopeSAC:
    """The model of `cfg` in eval mode, with the default initialisation of
    its modules (the caller loads the weights)."""
    h = cfg.MODEL.SEM_SEG_HEAD
    cam = cfg.MODEL.CAMERA_HEAD
    settings = TrainSettings(
        loss_detection_on=cfg.MODEL.LOSS_DETECTION_ON, loss_camera_on=cfg.MODEL.LOSS_CAMERA_ON,
        loss_matching_on=cfg.MODEL.LOSS_EMB_ON, matcher_on=cfg.MODEL.HUNGARIAN_MATCHER_ON,
        rand_on=cam.RAND_ON, no_object_weight=h.NO_OBJECT_WEIGHT, dice_weight=h.DICE_WEIGHT,
        mask_weight=h.MASK_WEIGHT, param_weight_l1=h.PARAM_WEIGHT_L1,
        param_weight_cos=h.PARAM_WEIGHT_COS, param_hm_weight_l1=h.PARAM_HM_WEIGHT_L1,
        param_weight_q=h.PARAM_WEIGHT_Q, center_ins_weight=h.PARAM_WEIGHT_CENTER_INS,
        param_weight_angle=h.PARAM_WEIGHT_ANGLE, param_weight_offset=h.PARAM_WEIGHT_OFFSET,
        initial_cam_weight=cam.INITIAL_CAM_WEIGHT, plane_cam_weight=cam.PLANE_CAM_WEIGHT,
        plane_cam_weight_predplane=cam.PLANE_CAM_WEIGHT_PREDPLANE)
    return PlaneTRNopeSAC(
        image_size=tuple(cfg.INPUT.IMAGE_SIZE), num_queries=h.NUM_OBJECT_QUERIES,
        embedding_on=cfg.MODEL.EMBEDDING_ON, camera_on=cfg.MODEL.CAMERA_ON,
        depth_on=bool(cfg.MODEL.DEPTH_ON), cam_rec_on=cam.CAM_REC_ON, cam_ref_on=cam.REFINE_ON,
        warp_plane_in_cam_ref_on=cam.WARP_PLANE_IN_CAM_REF_ON,
        sinkhorn_iterations=cfg.MODEL.MATCHING_HEAD.get("SINKHORN_ITERS", 200),
        offset_multiplier=cfg.MODEL.MATCHING_HEAD.OFFSET_MULTIPLIER,
        normal_multiplier=cfg.MODEL.MATCHING_HEAD.NORMAL_MULTIPLIER,
        plane_score_threshold=cfg.TEST.PLANE_SCORE_THRESHOLD,
        mask_prob_threshold=cfg.TEST.MASK_PROB_THRESHOLD,
        overlap_threshold=cfg.TEST.OVERLAP_THRESHOLD,
        matching_score_threshold=cfg.TEST.MATCHING_SCORE_THRESHOLD,
        inference_out_cam_type=cam.INFERENCE_OUT_CAM_TYPE,
        transformer_dropout=h.get("DROPOUT", 0.1), train_settings=settings,
        dtype=resolve_dtype(cfg.MODEL.COMPUTE_DTYPE, "COMPUTE_DTYPE"),
        backbone_train_dtype=resolve_dtype(cfg.MODEL.BACKBONE_TRAIN_DTYPE, "BACKBONE_TRAIN_DTYPE"),
        fpn_train_dtype=resolve_dtype(cfg.MODEL.FPN_TRAIN_DTYPE, "FPN_TRAIN_DTYPE"),
        remat=bool(cfg.MODEL.REMAT)).eval()


def eval_step(model: PlaneTRNopeSAC, image0: torch.Tensor, image1: torch.Tensor,
              cfg: Cfg) -> Dict:
    """The inference dict of uint8 NHWC images [B, H, W, 3] on the model's
    device: (f32(u8) - mean) * f32(1 / std), NCHW, then `inference`."""
    import numpy as np

    dev = next(model.parameters()).device
    mean = torch.tensor(np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32), device=dev)
    inv_std = torch.tensor((1.0 / np.asarray(cfg.MODEL.PIXEL_STD, np.float32)).astype(np.float32),
                           device=dev)

    def norm(img):
        return ((img.to(dev).to(torch.float32) - mean) * inv_std).permute(0, 3, 1, 2).contiguous()

    h, w = cfg.INPUT.IMAGE_SIZE
    with torch.inference_mode():
        return model.inference(norm(image0), norm(image1), out_h=h, out_w=w)


class TrainStep:
    """One optimisation step per call, as the port's `engine/train.py:TrainStep`
    at world size 1: train_forward, backward, the global gradient norm, the
    non-finite skip guard (BN statistics put back), clipping, the scheduled
    lr and AdamW. `gen` is seeded with `seed` on the model's device."""

    def __init__(self, model: PlaneTRNopeSAC, cfg: Cfg, seed: int = 0):
        s = cfg.SOLVER
        self.model = model
        apply_freeze(model, cfg.MODEL.FREEZE)
        self.optimizer = build_optimizer(cfg, model)
        self.params: List[torch.Tensor] = [p for g in self.optimizer.param_groups
                                           for p in g["params"]]
        self.schedule = make_lr_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_ITERS,
                                         s.WARMUP_FACTOR)
        clip = s.CLIP_GRADIENTS
        self.clip_value = (clip.CLIP_VALUE if clip.ENABLED and clip.CLIP_TYPE == "full_model"
                           else None)
        dev = next(model.parameters()).device
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.bn_buffers = [buf for m in model.modules() if isinstance(m, BatchNorm2d)
                           for buf in (m.running_mean, m.running_var)]
        self.updates = 0

    def __call__(self, batch: Dict) -> Tuple[Dict[str, float], bool]:
        """(the losses and their total as floats, whether the update applied)."""
        self.optimizer.zero_grad(set_to_none=True)
        saved_bn = [buf.clone() for buf in self.bn_buffers]
        losses = self.model.train_forward(batch, self.gen)
        total = torch.stack([v.to(torch.float32) for v in losses.values()]).sum()
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        grad_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        ok = bool(torch.isfinite(grad_norm) & torch.isfinite(total))
        if ok:
            for p, g in zip(self.params, grads):
                p.grad = g
            if self.clip_value is not None:
                clip_by_global_norm_(grads, grad_norm, self.clip_value)
            set_lr(self.optimizer, self.schedule(self.updates))
            self.optimizer.step()
            self.updates += 1
        else:
            with torch.no_grad():
                for buf, old in zip(self.bn_buffers, saved_bn):
                    buf.copy_(old)
        out = {k: float(v.detach()) for k, v in losses.items()}
        out["total_loss"] = float(total.detach())
        return out, ok
