"""Eval-only inference of image pairs: model construction from a config, the
eval step with in-graph uint8 normalisation, and a small CLI.

    python -m nopesac_torch.engine.predict --config-file configs/inference_mp3d.yaml \
        --pairs 8 --seed 0 [--device cpu] [KEY VALUE ...]

The CLI runs seeded synthetic uint8 pairs through seeded random weights (the
reference checkpoint is not in the repository) and prints one JSON summary
line per pair. Counterpart of the JAX package's `engine/trainer.py`
(`build_model_from_cfg`) and `engine/train_step.py` (`make_eval_step`).
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config.config import CfgNode, get_cfg
from ..models.nopesac import PlaneTRNopeSAC, TrainSettings
from ..utils import graphs
from ..utils.device import DeviceLike, resolve_device, resolve_dtype, set_f32_parity
from ..utils.weights import seeded_init


def build_model_from_cfg(cfg: CfgNode, device: DeviceLike = None,
                         seed: Optional[int] = None) -> PlaneTRNopeSAC:
    """The model of a config, in eval mode on `device` (default `cuda`),
    with the config's loss switches and weights for `train_forward`. `seed`
    fills it with seeded random weights; otherwise load a state_dict into it.
    MODEL.RESNETS.FUSE_TAIL runs the backbone's identity-block tails through
    kernel B4 at inference. The compute dtypes come from MODEL.COMPUTE_DTYPE,
    BACKBONE_TRAIN_DTYPE and FPN_TRAIN_DTYPE, train-mode backbone
    checkpointing from MODEL.REMAT, the depth branch from MODEL.DEPTH_ON.
    Sets the precision policy."""
    dev = resolve_device(device)
    set_f32_parity()
    h = cfg.MODEL.SEM_SEG_HEAD
    cam = cfg.MODEL.CAMERA_HEAD
    settings = TrainSettings(
        loss_detection_on=cfg.MODEL.LOSS_DETECTION_ON,
        loss_camera_on=cfg.MODEL.LOSS_CAMERA_ON,
        loss_matching_on=cfg.MODEL.LOSS_EMB_ON,
        matcher_on=cfg.MODEL.HUNGARIAN_MATCHER_ON,
        rand_on=cam.RAND_ON,
        no_object_weight=h.NO_OBJECT_WEIGHT,
        dice_weight=h.DICE_WEIGHT,
        mask_weight=h.MASK_WEIGHT,
        param_weight_l1=h.PARAM_WEIGHT_L1,
        param_weight_cos=h.PARAM_WEIGHT_COS,
        param_hm_weight_l1=h.PARAM_HM_WEIGHT_L1,
        param_weight_q=h.PARAM_WEIGHT_Q,
        center_ins_weight=h.PARAM_WEIGHT_CENTER_INS,
        param_weight_angle=h.PARAM_WEIGHT_ANGLE,
        param_weight_offset=h.PARAM_WEIGHT_OFFSET,
        initial_cam_weight=cam.INITIAL_CAM_WEIGHT,
        plane_cam_weight=cam.PLANE_CAM_WEIGHT,
        plane_cam_weight_predplane=cam.PLANE_CAM_WEIGHT_PREDPLANE,
    )
    model = PlaneTRNopeSAC(
        image_size=tuple(cfg.INPUT.IMAGE_SIZE),
        num_queries=h.NUM_OBJECT_QUERIES,
        embedding_on=cfg.MODEL.EMBEDDING_ON,
        camera_on=cfg.MODEL.CAMERA_ON,
        depth_on=bool(cfg.MODEL.DEPTH_ON),
        cam_rec_on=cam.CAM_REC_ON,
        cam_ref_on=cam.REFINE_ON,
        warp_plane_in_cam_ref_on=cam.WARP_PLANE_IN_CAM_REF_ON,
        sinkhorn_iterations=cfg.MODEL.MATCHING_HEAD.get("SINKHORN_ITERS", 200),
        offset_multiplier=cfg.MODEL.MATCHING_HEAD.OFFSET_MULTIPLIER,
        normal_multiplier=cfg.MODEL.MATCHING_HEAD.NORMAL_MULTIPLIER,
        plane_score_threshold=cfg.TEST.PLANE_SCORE_THRESHOLD,
        mask_prob_threshold=cfg.TEST.MASK_PROB_THRESHOLD,
        overlap_threshold=cfg.TEST.OVERLAP_THRESHOLD,
        matching_score_threshold=cfg.TEST.MATCHING_SCORE_THRESHOLD,
        inference_out_cam_type=cam.INFERENCE_OUT_CAM_TYPE,
        transformer_dropout=h.get("DROPOUT", 0.1),
        train_settings=settings,
        fuse_tail=bool(cfg.MODEL.RESNETS.FUSE_TAIL),
        dtype=resolve_dtype(cfg.MODEL.COMPUTE_DTYPE, "COMPUTE_DTYPE"),
        backbone_train_dtype=resolve_dtype(cfg.MODEL.BACKBONE_TRAIN_DTYPE,
                                           "BACKBONE_TRAIN_DTYPE"),
        fpn_train_dtype=resolve_dtype(cfg.MODEL.FPN_TRAIN_DTYPE, "FPN_TRAIN_DTYPE"),
        remat=bool(cfg.MODEL.REMAT),
    )
    if seed is not None:
        seeded_init(model, seed)
    return model.to(dev).eval()


def make_eval_step(model: PlaneTRNopeSAC, out_h: int = 480, out_w: int = 640,
                   pixel_mean: Sequence[float] = (123.675, 116.280, 103.530),
                   pixel_std: Sequence[float] = (58.395, 57.120, 57.375)) -> Callable:
    """eval_step(image0, image1, gt_geo=None, init_cam=None) on raw uint8
    NHWC images [B, H, W, 3] -> the inference dict. Normalisation is
    (f32(u8) - mean) * f32(1/std), with the inverse std computed in numpy
    f32, the same IEEE ops as the JAX eval step, so normalised inputs are
    bit-equal. `gt_geo` (the GT-matcher ablation,
    TEST.POSE_REFINEMENT_WITH_GT_MATCHERS) and `init_cam` (the SparsePlanes
    top-1 camera, MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON) are dicts of
    arrays or tensors (`PlaneTRNopeSAC.camera_inference`); the step moves
    them and the images to the model's device.

    Host inputs go to a CUDA device through pinned memory by a non-blocking
    copy: a copy from pageable memory waits until the stream has drained,
    so the host would wait for the batch before. `pin_memory` takes its
    buffer from PyTorch's caching host allocator, which does not reuse it
    until the copy out of it has run.

    Each call opens the model's cache of CUDA graphs (`utils/graphs.py`):
    on a card in eval mode the inference's segments run eagerly on the first
    call of an input signature (the images' shape and dtype, which of
    `gt_geo` and `init_cam` are given and theirs, the output size), are
    captured on the second and replayed after that. The cache lives on the
    model, so the graphs outlive this step; `model.train()` drops them. So a returned
    device tensor may be a graph's static buffer: it holds its value until
    the next call of an eval step of this model with the same signature,
    which overwrites it. Fetch (`engine/test.py:_fetch`, enqueued before the
    next call on the same stream) or clone what must outlive that call."""
    dev = next(model.parameters()).device

    def upload(t: torch.Tensor) -> torch.Tensor:
        if dev.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    mean = upload(torch.from_numpy(np.asarray(pixel_mean, np.float32)))
    inv_std = upload(torch.from_numpy((1.0 / np.asarray(pixel_std, np.float32)).astype(np.float32)))

    def norm(img: torch.Tensor) -> torch.Tensor:
        if img.dtype != torch.uint8 or img.dim() != 4 or img.shape[-1] != 3:
            raise ValueError(f"eval step takes uint8 [B, H, W, 3] images, got {img.dtype} "
                             f"{tuple(img.shape)}")
        x = (upload(img).to(torch.float32) - mean) * inv_std
        return x.permute(0, 3, 1, 2).contiguous()

    def to_dev(arrays):
        if arrays is None:
            return None
        return {k: upload(torch.as_tensor(v)) for k, v in arrays.items()}

    def eval_step(image0: torch.Tensor, image1: torch.Tensor, gt_geo=None, init_cam=None):
        with torch.inference_mode():
            x0, x1 = norm(image0), norm(image1)
            gt_geo, init_cam = to_dev(gt_geo), to_dev(init_cam)
            with graphs.opened(model, x0, x1, gt_geo, init_cam, out_h, out_w):
                return model.inference(x0, x1, out_h=out_h, out_w=out_w, gt_geo=gt_geo,
                                       init_cam=init_cam)

    return eval_step


def synthetic_pairs(n: int, h: int, w: int, seed: int, device: DeviceLike = None):
    """Seeded uint8 NHWC image pairs ([n, h, w, 3] each) on `device`."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(2, n, h, w, 3), dtype=np.uint8)
    dev = resolve_device(device)
    return torch.from_numpy(imgs[0]).to(dev), torch.from_numpy(imgs[1]).to(dev)


def summarize(out, i: int) -> dict:
    cam = out["cameras"]["camera"] if "cameras" in out else None
    row = {"planes0": int(out["view0"]["valid"][i].sum()),
           "planes1": int(out["view1"]["valid"][i].sum())}
    if "num_matches" in out:
        row["matches"] = int(out["num_matches"][i])
    if cam is not None:
        row["tran"] = [round(float(x), 6) for x in cam["tran"][i]]
        row["rot"] = [round(float(x), 6) for x in cam["rot"][i]]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device=args.device, seed=args.seed)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    bs = cfg.TEST.IMS_PER_BATCH
    done = 0
    for k in range(math.ceil(args.pairs / bs)):
        n = min(bs, args.pairs - done)
        image0, image1 = synthetic_pairs(n, h, w, seed=args.seed + 1 + k, device=args.device)
        t0 = time.perf_counter()
        out = step(image0, image1)
        if image0.is_cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for i in range(n):
            print(json.dumps({"pair": done + i, **summarize(out, i)}))
        print(json.dumps({"batch": k, "pairs": n, "seconds": round(secs, 4),
                          "device": str(image0.device)}))
        done += n
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
