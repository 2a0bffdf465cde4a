"""Lightweight yacs-style config system (no detectron2 dependency).

The port's own copy of the JAX package's `config/config.py`, so that the
port imports nothing of that package: defaults -> `_BASE_` yaml inheritance
-> file merge -> dotted CLI ``opts`` overrides -> freeze. The same yaml
files under `configs/` drive both packages.
"""
from __future__ import annotations

import copy
import os
from typing import Any, List

import yaml


class CfgNode(dict):
    """A dict with attribute access, freeze support, and yaml merge."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ---------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, key, value) -> None:
        # item assignment is the single mutation path (merge_from_file /
        # merge_from_list / attribute sets all land here), so the frozen
        # guard lives here — yacs semantics, where freeze() catches ANY
        # late mutation, not only attribute-style ones
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freeze -----------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        # default dict-subclass deepcopy restores __frozen__ BEFORE
        # re-inserting items, which would trip the __setitem__ guard
        new = CfgNode()
        memo[id(self)] = new
        for k, v in self.items():
            dict.__setitem__(new, k, copy.deepcopy(v, memo))
        object.__setattr__(new, CfgNode._FROZEN,
                           object.__getattribute__(self, CfgNode._FROZEN))
        return new

    # -- merging ----------------------------------------------------------
    def _merge_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and k in self and isinstance(self[k], CfgNode):
                self[k]._merge_dict(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        base = loaded.pop("_BASE_", None)
        if base is not None:
            base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
            self.merge_from_file(base_path)
        self._merge_dict(_parse_values(loaded))

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"opts must be key value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            old = node.get(parts[-1], None)
            node[parts[-1]] = _coerce(value, old)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)


def _parse_values(obj):
    """yaml may hand back python-ish tuple strings like '("mp3d_train",)'."""
    if isinstance(obj, dict):
        return {k: _parse_values(v) for k, v in obj.items()}
    if isinstance(obj, str) and obj.startswith("(") and obj.endswith(")"):
        try:
            import ast

            return list(ast.literal_eval(obj))
        except (ValueError, SyntaxError):
            return obj
    return obj


def _coerce(value: str, old: Any):
    """Coerce a CLI string override to the type of the existing value."""
    if isinstance(old, bool) or (old is None and value in ("True", "False", "true", "false")):
        return value in ("True", "true", "1")
    if isinstance(old, int) and not isinstance(old, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)):
        import ast

        try:
            return list(ast.literal_eval(value))
        except (ValueError, SyntaxError):
            return value
    # unknown: try literal eval, fall back to str
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def get_cfg() -> CfgNode:
    """Default config tree: the subset of d2 keys the reference consumes plus
    all NOPE-SAC additions (NopeSAC_Net/config/config.py:5-115)."""
    c = CfgNode()
    c.VERSION = 2
    c.OUTPUT_DIR = "./output"
    c.SEED = 42
    # TensorBoard-compatible scalar events (utils/tb_writer.py). The
    # reference's d2 trainer always emits tfevents (SURVEY.md section 5);
    # metrics.json stays the canonical artifact either way.
    c.TENSORBOARD_ON = True
    c.FIX_SEED = True
    # DEBUG_ON is parity-inert by design: the reference stores it on its
    # evaluator (mp3d_evaluation.py:62) and never reads it again.
    # DEBUG_CAMERA_ON prints a per-iteration marker during inference
    # (siamese_planeTR.py:343-344) — wired in engine/trainer.test().
    c.DEBUG_ON = False
    c.DEBUG_CAMERA_ON = False

    # ---------------- MODEL ----------------
    c.MODEL = CfgNode()
    c.MODEL.META_ARCHITECTURE = "PlaneTR_NopeSAC"
    c.MODEL.DEVICE = "cuda"
    # training compute dtype: "float32" (reference parity, default) or
    # "bfloat16" (4x MXU matmul rate on TPU; master weights/optimizer state
    # stay f32 either way - the modules cast activations only)
    c.MODEL.COMPUTE_DTYPE = "float32"
    # train-mode backbone block-interior dtype: "float32" (homogeneous,
    # reference-parity default) or "bfloat16" (AMP-style: bottleneck-block
    # interiors compute/store bf16, the residual trunk and every residual
    # accumulation stay f32 — the trunk is where the DETR query-
    # distinguishing signal lives; see models/resnet.py + PERF.md A/B)
    c.MODEL.BACKBONE_TRAIN_DTYPE = "float32"
    # train-mode FPN / pixel-path dtype (models/plane_head.py px_dtype):
    # "float32" default; "bfloat16" is the round-5 island re-test — the
    # f32 pin predates the mixed-precision backbone (convergence A/B in
    # PERF.md decides whether this island can fall)
    c.MODEL.FPN_TRAIN_DTYPE = "float32"
    # train-mode backbone rematerialisation (activation checkpointing):
    # trades ~+11% train FLOPs for the HBM needed to fit IMS_PER_BATCH=16
    # (the reference's training batch) on a single v5e chip
    c.MODEL.REMAT = True
    c.MODEL.WEIGHTS = ""
    c.MODEL.PIXEL_MEAN = [123.675, 116.280, 103.530]
    c.MODEL.PIXEL_STD = [58.395, 57.120, 57.375]
    c.MODEL.FREEZE = []
    c.MODEL.MASK_ON = True
    c.MODEL.DEPTH_ON = False
    c.MODEL.EMBEDDING_ON = False
    c.MODEL.CAMERA_ON = False
    c.MODEL.HUNGARIAN_MATCHER_ON = True
    c.MODEL.LOSS_DETECTION_ON = True
    c.MODEL.LOSS_CAMERA_ON = False
    c.MODEL.LOSS_EMB_ON = False
    c.MODEL.CAMERA_BRANCH = "CACHED"

    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    c.MODEL.BACKBONE.FREEZE_AT = 0

    c.MODEL.RESNETS = CfgNode()
    c.MODEL.RESNETS.DEPTH = 50
    c.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    c.MODEL.RESNETS.STRIDE_IN_1X1 = False
    c.MODEL.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    c.MODEL.RESNETS.NORM = "FrozenBN"

    h = c.MODEL.SEM_SEG_HEAD = CfgNode()
    h.NAME = "PlaneTRHead"
    h.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    h.NORM = "GN"
    h.NUM_CLASSES = 1
    h.LOSS_WEIGHT = 1.0
    h.CONVS_DIM = 256
    h.DEEP_SUPERVISION = True
    h.NO_OBJECT_WEIGHT = 0.1
    # transformer dropout (reference hardcodes 0.1, transformer.py). Exposed
    # because tiny overfit fixtures need 0.0: with dropout on, extreme
    # overfitting can converge to a degenerate solution where plane/no-plane
    # classification keys off dropout noise instead of query content (the
    # Hungarian matcher chases the per-step noise), leaving the deterministic
    # eval forward with collapsed, query-independent class logits.
    h.DROPOUT = 0.1
    h.DICE_WEIGHT = 1.0
    h.MASK_WEIGHT = 20.0
    h.PARAM_WEIGHT_L1 = 0.5
    h.PARAM_WEIGHT_COS = 10.0
    h.PARAM_HM_WEIGHT_L1 = 0.5
    h.PARAM_WEIGHT_Q = 1.0
    h.PARAM_WEIGHT_CENTER_INS = 0.5
    h.PARAM_WEIGHT_ANGLE = 0.0028
    h.PARAM_WEIGHT_OFFSET = 0.01
    h.CENTER_ON = False
    h.PARAM_ON = False
    h.PARAM_IN_MATCHER = True
    h.NHEADS = 8
    h.ENC_LAYERS = 6
    h.DEC_LAYERS = 6
    h.NUM_OBJECT_QUERIES = 50
    h.MASK_DIM = 256
    h.HIDDEN_DIM = 256

    cam = c.MODEL.CAMERA_HEAD = CfgNode()
    cam.NAME = ""
    cam.LOSS_WEIGHT = 1.0
    cam.KMEANS_TRANS_PATH = "./camCls/kmeans_trans_32.pkl"
    cam.KMEANS_ROTS_PATH = "./camCls/kmeans_rots_32.pkl"
    cam.TRANS_CLASS_NUM = 32
    cam.ROTS_CLASS_NUM = 32
    cam.FEATURE_SIZE = 64
    cam.BACKBONE_FEATURE = "res3"
    cam.REFINE_ON = False
    cam.CAM_REC_ON = False
    cam.RAND_ON = False
    # PIXEL_CAM_FIX_ON is parity-inert by design: the reference defines it
    # (config.py:69) and never reads it anywhere in NopeSAC_Net. Kept for
    # config-file compatibility only (like DEBUG_ON below).
    cam.PIXEL_CAM_FIX_ON = False
    cam.INFERENCE_OUT_CAM_TYPE = "soft"
    cam.INITIAL_CAM_WEIGHT = 1.0
    cam.PLANE_CAM_WEIGHT = 1.0
    cam.PLANE_CAM_WEIGHT_PREDPLANE = 0.1
    cam.CLASSIFICATION_ON = False
    # SparsePlanes top-1-camera ablation: at inference the initial camera is
    # read from the pickle at INFERENCE_SP_TOPCAM_PATH (keyed
    # "<image_id1>-<image_id2>") instead of the PixelCameraHead (reference
    # camera_head.py:44-59, 419-431; requires CAM_REC_ON). Wired in
    # engine/trainer.test() -> PlaneTRNopeSAC.inference(init_cam=...).
    cam.INFERENCE_SP_TOPCAM_ON = False
    cam.INFERENCE_SP_TOPCAM_PATH = ""
    cam.WARP_PLANE_IN_CAM_REF_ON = True

    mh = c.MODEL.MATCHING_HEAD = CfgNode()
    mh.NAME = ""
    mh.INITIAL_CAM_ON = True
    mh.OFFSET_MULTIPLIER = 4.0
    mh.NORMAL_MULTIPLIER = 8.0
    mh.SINKHORN_ITERS = 200

    # ---------------- SOLVER ----------------
    s = c.SOLVER = CfgNode()
    s.IMS_PER_BATCH = 16
    s.BASE_LR = 0.0001
    s.MAX_ITER = 10000
    s.STEPS = [7000]
    s.GAMMA = 0.1
    s.WARMUP_FACTOR = 1.0
    s.WARMUP_ITERS = 10
    s.WEIGHT_DECAY = 0.0001
    s.WEIGHT_DECAY_NORM = 0.0
    s.WEIGHT_DECAY_EMBED = 0.0
    s.OPTIMIZER = "ADAMW"
    s.MOMENTUM = 0.9
    s.BACKBONE_MULTIPLIER = 1.0
    s.SEM_SEG_HEAD_MULTIPLIER = 1.0
    s.PLANE_MATCHER_HEAD_MULTIPLIER = 1.0
    s.CHECKPOINT_PERIOD = 2000
    s.CLIP_GRADIENTS = CfgNode()
    s.CLIP_GRADIENTS.ENABLED = False
    s.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    s.CLIP_GRADIENTS.NORM_TYPE = 2.0

    # ---------------- DATA ----------------
    c.DATASETS = CfgNode()
    c.DATASETS.TRAIN = ["mp3d_train"]
    c.DATASETS.TEST = ["mp3d_test"]
    c.DATASETS.ROOT_DIR = ""

    d = c.DATALOADER = CfgNode()
    d.NUM_WORKERS = 4
    d.FILTER_EMPTY_ANNOTATIONS = True
    d.ASPECT_RATIO_GROUPING = False
    d.AUGMENTATION = False

    c.INPUT = CfgNode()
    c.INPUT.FORMAT = "RGB"
    # fixed model input resolution (the reference hardcodes 480x640,
    # planercnn_transforms.py:314); smaller sizes for smoke/CI runs
    c.INPUT.IMAGE_SIZE = (480, 640)

    # ---------------- TEST ----------------
    t = c.TEST = CfgNode()
    t.EVAL_PERIOD = 0
    t.EVAL_GT_BOX = False
    # eval-loop device batch (TPU extension; the reference hardcodes bs=1 at
    # inference, siamese_planeTR.py:340 - batching is our throughput lever)
    t.IMS_PER_BATCH = 4
    t.OVERLAP_THRESHOLD = 0.6
    t.PLANE_SCORE_THRESHOLD = 0.6
    t.MASK_PROB_THRESHOLD = 0.5
    t.EVAL_FULL_SCENE = False
    # post-training precise-BN recompute (d2 TEST.PRECISE_BN semantics;
    # see engine/precise_bn.py for why running averages are not enough).
    # Default off for reference parity; synthetic configs enable it.
    t.PRECISE_BN = CfgNode()
    t.PRECISE_BN.ENABLED = False
    t.PRECISE_BN.NUM_ITER = 200
    t.MATCHING_SCORE_THRESHOLD = 0.2
    t.POSE_REFINEMENT_WITH_GT_MATCHERS = False
    t.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS = False
    t.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS_OFFSET_SCALE = 0.1
    t.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS_NORMAL_SCALE = 10.0

    return c
