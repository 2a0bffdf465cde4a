"""The evaluation entry point: batched inference over a test split, the host
postprocess, MP3DEvaluator and its artifacts (counterpart of the JAX
package's `Trainer.test` and `test_NopeSAC.py`).

    python -m nopesac_torch.engine.test --config-file configs/smoke_synthetic.yaml \
        --eval-only [--device cpu] [--seed 0] [--num-gpus N] [--num-machines M \
        --machine-rank R --dist-url tcp://host:port] TEST.EVAL_FULL_SCENE True

The CLI takes `test_NopeSAC.py`'s flags. It evaluates cfg.DATASETS.TEST[0] on
`cuda` unless `--device cpu` is given, logs the metrics and prints them as
one JSON line. With TEST.EVAL_FULL_SCENE it writes
`NopeSAC_instances_predictions.pth` and `continuous.pkl` into OUTPUT_DIR,
which `eval.py` reads. MODEL.WEIGHTS names a torch checkpoint (`.pth`: a
state_dict, or `{"model": state_dict}`), loaded strictly by
`engine/checkpoint.py:load_weights`; without one the model gets seeded random
weights (`--seed`). With `--resume` the latest training checkpoint in
OUTPUT_DIR (`last_checkpoint`) takes MODEL.WEIGHTS' place when there is one.
With N ranks on each of M machines (`parallel/dist.py:launch`, N 1 by
default, at most the visible cards) each rank evaluates its strided slice
of the split and rank 0 gathers the predictions, writes the artifacts and
prints the line.

The ablations of pose refinement, as in the JAX package's `Trainer.test`:
  * TEST.POSE_REFINEMENT_WITH_GT_MATCHERS: the refinement runs on the GT
    plane correspondences (`gt_geo_from_samples`); with
    TEST.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS the GT planes get Gaussian
    noise (`perturb_planes`, ..._OFFSET_SCALE metres and ..._NORMAL_SCALE
    degrees), drawn from one generator seeded SEED (0 when negative) per
    `test()` call, pair by pair and view 0 then view 1 over the padded
    batches. Across ranks each rank draws its own stream from that seed over
    its slice, so N ranks' noisy planes are not one process's;
  * MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON: each pair's initial pose is
    looked up in the SparsePlanes top-1 pickle at INFERENCE_SP_TOPCAM_PATH by
    "<image_id0>-<image_id1>" and the PixelCameraHead does not run; it
    needs CAM_REC_ON.
MODEL.DEPTH_ON adds the depth maps, and the evaluator `depth_l1_dist`.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import random
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config.config import CfgNode, get_cfg
from ..data import datasets
from ..data.mapper import PairMapper
from ..data.registry import DatasetCatalog
from ..evaluation.evaluator import MP3DEvaluator
from ..evaluation.postprocess import postprocess_batch
from ..models.nopesac import PlaneTRNopeSAC
from ..parallel.dist import barrier, is_main_process, launch, rank, world_size
from ..utils import trace
from ..utils.device import DeviceLike, resolve_device
from ..utils.np_geometry import rotmat_from_euler_deg
from .checkpoint import Checkpointer, load_weights
from .predict import build_model_from_cfg, make_eval_step

logger = logging.getLogger(__name__)


def build_eval_model(cfg: CfgNode, device: DeviceLike = None, seed: int = 0,
                     weights: Optional[str] = None) -> PlaneTRNopeSAC:
    """The model of `cfg` in eval mode with `weights` (default
    MODEL.WEIGHTS), or with seeded random weights when there are none."""
    weights = weights or cfg.MODEL.WEIGHTS
    if weights:
        model = build_model_from_cfg(cfg, device=device)
        load_weights(model, weights, strict=True)
        logger.info("loaded %s", weights)
        return model
    logger.warning("MODEL.WEIGHTS is empty: seeded random weights (seed %d)", seed)
    return build_model_from_cfg(cfg, device=device, seed=seed)


def _fetch(tree):
    """Start copying the eval step's outputs to the host without waiting: a
    non-blocking copy from a CUDA device lands in pinned memory, which
    PyTorch allocates for it."""
    if isinstance(tree, dict):
        return {k: _fetch(v) for k, v in tree.items()}
    return tree.to("cpu", non_blocking=True)


def _numpy(tree):
    """Host tensors as numpy arrays; bf16 (which numpy lacks) is widened to
    f32 exactly, so the artifacts of a bf16 run have an f32 run's dtypes."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        tree = tree.to(torch.float32)
    return tree.numpy()


def perturb_planes(params: np.ndarray, rng: np.random.Generator, scale_offset: float,
                   scale_normal_deg: float) -> np.ndarray:
    """The GT-matcher noise ablation on plane parameters [N, 3] (n * d; zero
    rows stay zero), as the JAX package draws it (camera_head.py:1233-1272):
    the normal rotated by Euler angles ~ N(0, scale_normal_deg) degrees [N, 3],
    then the offset += N(0, scale_offset) [N, 1]."""
    n = params.shape[0]
    offset = np.linalg.norm(params, axis=-1, keepdims=True)  # [N, 1]
    valid = offset[:, 0] > 1e-8
    normal = params / np.maximum(offset, 1e-8)
    ang = rng.normal(0.0, scale_normal_deg, size=(n, 3)).astype(np.float32)
    rot = rotmat_from_euler_deg(ang[:, 0], ang[:, 1], ang[:, 2])  # [N, 3, 3]
    normal = np.einsum("nij,nj->ni", rot, normal)
    normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-8)
    offset = offset + rng.normal(0.0, scale_offset, size=(n, 1)).astype(np.float32)
    out = (offset * normal).astype(np.float32)
    out[~valid] = 0.0
    return out


def gt_geo_from_samples(chunk: Sequence[dict], samples: Sequence[dict], nq: int,
                        noise_rng: Optional[np.random.Generator] = None,
                        scale_offset: float = 0.1,
                        scale_normal_deg: float = 10.0) -> Dict[str, np.ndarray]:
    """The GT-matcher inputs of a batch (`PlaneTRNopeSAC.camera_inference`'s
    gt_geo) on the host: each view's annotated plane parameters zero-padded
    to [B, nq, 3] (camera_head.py:1205-1219), perturbed with `noise_rng`
    pair by pair, view 0 then view 1, and the mapper's correspondences."""
    bsz = len(chunk)
    params = {v: np.zeros((bsz, nq, 3), np.float32) for v in ("0", "1")}
    for i, pair in enumerate(chunk):
        for v in ("0", "1"):
            planes = [ann["plane"] for ann in pair[v].get("annotations", [])][:nq]
            if planes:
                arr = np.asarray(planes, np.float32)
                if noise_rng is not None:
                    arr = perturb_planes(arr, noise_rng, scale_offset, scale_normal_deg)
                params[v][i, :len(planes)] = arr
    return {"params0": params["0"], "params1": params["1"],
            **{k: np.stack([s[k] for s in samples])
               for k in ("corr_idx1", "corr_idx2", "corr_valid")}}


def load_sp_topcam(cfg: CfgNode) -> Optional[dict]:
    """The SparsePlanes top-1 cameras of MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_PATH
    ({"<image_id0>-<image_id1>": {"position", "rotation"}}) when
    INFERENCE_SP_TOPCAM_ON, else None; it needs CAM_REC_ON
    (camera_head.py:469)."""
    cam = cfg.MODEL.CAMERA_HEAD
    if not cam.INFERENCE_SP_TOPCAM_ON:
        return None
    if not cam.CAM_REC_ON:
        raise ValueError("MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON needs CAMERA_HEAD.CAM_REC_ON "
                         "(reference camera_head.py:469)")
    logger.warning("Note: using top1 cam")
    with open(cam.INFERENCE_SP_TOPCAM_PATH, "rb") as f:
        return pickle.load(f)


def sp_topcam_of(sp_topcam: dict, chunk: Sequence[dict]) -> Dict[str, np.ndarray]:
    """The init_cam of a batch: each pair's pose in the pickle (a missing
    pair raises KeyError, as the reference's dict lookup does)."""
    cams = [sp_topcam[d["0"]["image_id"] + "-" + d["1"]["image_id"]] for d in chunk]
    return {"tran": np.stack([np.asarray(c["position"], np.float32).reshape(3) for c in cams]),
            "rot": np.stack([np.asarray(c["rotation"], np.float32).reshape(4) for c in cams])}


class EvalRunner:
    """Evaluation of a model over a test split, as `Trainer.test` does it."""

    def __init__(self, cfg: CfgNode, model: PlaneTRNopeSAC):
        self.cfg = cfg
        self.model = model
        self.last_eval_stats: Dict = {}

    def test(self, dataset_list: Optional[List[dict]] = None) -> "OrderedDict":
        """Evaluate over `dataset_list` (default: cfg.DATASETS.TEST[0]).
        Across ranks each rank runs the pairs dataset_list[rank::world] and
        the evaluator gathers them; every rank returns the metrics of all
        pairs, and `last_eval_stats` counts all pairs over rank 0's wall up
        to the moment every rank is done, with this rank's valid planes per
        view and final matches per pair."""
        with trace.span("eval.test"):
            return self._test(dataset_list)

    def _test(self, dataset_list: Optional[List[dict]]) -> "OrderedDict":
        cfg = self.cfg
        test_name = cfg.DATASETS.TEST[0]
        if dataset_list is None:
            dataset_list = DatasetCatalog.get(test_name)
        world = world_size()
        n_pairs = len(dataset_list)
        h, w = cfg.INPUT.IMAGE_SIZE
        nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
        mapper = PairMapper(nq, (h, w), cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, is_train=False,
                            eval_gt_box=bool(cfg.TEST.EVAL_GT_BOX),
                            root_dir=cfg.DATASETS.ROOT_DIR,
                            dataset_kind=datasets.dataset_kind(test_name),
                            camera_cls_on=cfg.MODEL.CAMERA_HEAD.CLASSIFICATION_ON)
        # the ablations of pose refinement (camera_head.py:419-431, 520-547)
        gt_matcher = bool(cfg.TEST.POSE_REFINEMENT_WITH_GT_MATCHERS)
        noise_rng = None
        if gt_matcher:
            logger.warning("using GT plane matches for pose refinement")
            if cfg.TEST.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS:
                logger.warning("...with Gaussian noise on the GT planes")
                noise_rng = np.random.default_rng(cfg.SEED if cfg.SEED >= 0 else 0)
        sp_topcam = load_sp_topcam(cfg)
        evaluator = MP3DEvaluator(test_name, cfg, dataset_list=dataset_list, distributed=world > 1)
        dataset_list = dataset_list[rank()::world]
        eval_step = make_eval_step(self.model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        dev = next(self.model.parameters()).device
        bs = int(cfg.TEST.IMS_PER_BATCH)
        debug_camera = bool(cfg.DEBUG_CAMERA_ON)
        # valid planes of both views and final matches over this rank's
        # pairs, counted on the host arrays the drain already holds
        counted = {"pairs": 0, "planes": 0, "matches": 0}

        def drain(pending):
            chunk, metas, out, done = pending
            with trace.span("eval.drain"):
                if done is not None:
                    with trace.span("eval.fetch_wait"):
                        done.synchronize()
                with trace.span("eval.postprocess"):
                    out = _numpy(out)
                    n = len(metas)
                    counted["pairs"] += n
                    counted["planes"] += int(out["view0"]["valid"][:n].sum()
                                             + out["view1"]["valid"][:n].sum())
                    if "assignment" in out:
                        counted["matches"] += int(out["assignment"][:n].sum())
                    results = postprocess_batch(out, metas, height=h, width=w)
                with trace.span("eval.evaluator"):
                    evaluator.process(chunk, results)

        # one-step pipeline: batch i+1 is enqueued on the card before batch i
        # is fetched and postprocessed on the host
        pending = None
        t0 = time.perf_counter()
        for k, lo in enumerate(range(0, len(dataset_list), bs)):
            if debug_camera:
                print("**********************> ", k + 1, flush=True)
            with trace.span("eval.mapper"):
                chunk = dataset_list[lo: lo + bs]
                samples = [mapper(d) for d in chunk]
                n_real = len(samples)
                # the tail batch repeats its last sample so the eval step sees
                # one shape; the repeats are dropped before the postprocess
                samples += [samples[-1]] * (bs - n_real)
                images = [torch.from_numpy(np.stack([s[f"image{i}"] for s in samples]))
                          for i in ("0", "1")]
                pad_chunk = list(chunk) + [chunk[-1]] * (bs - n_real)
                gt_geo = init_cam = None
                if gt_matcher:
                    tc = cfg.TEST
                    gt_geo = gt_geo_from_samples(
                        pad_chunk, samples, nq, noise_rng=noise_rng,
                        scale_offset=tc.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS_OFFSET_SCALE,
                        scale_normal_deg=tc.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS_NORMAL_SCALE)
                if sp_topcam is not None:
                    init_cam = sp_topcam_of(sp_topcam, pad_chunk)
            with trace.span("eval.step"):
                # on a card the outputs are the step's graph buffers: their copy
                # to the host is enqueued before the next batch's replay
                out = _fetch(eval_step(*images, gt_geo=gt_geo, init_cam=init_cam))
                done = None
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            if pending is not None:
                drain(pending)
            pending = (chunk, [s["meta"] for s in samples[:n_real]], out, done)
        if pending is not None:
            drain(pending)
        barrier()
        secs = time.perf_counter() - t0
        per = lambda k, d: round(counted[k] / max(d, 1), 3)
        self.last_eval_stats = {"pairs": n_pairs, "seconds": round(secs, 3),
                                "pairs_per_sec": round(n_pairs / max(secs, 1e-9), 2),
                                "planes_per_view": per("planes", 2 * counted["pairs"]),
                                "matches_per_pair": per("matches", counted["pairs"])}
        with trace.span("eval.evaluate"):
            return evaluator.evaluate()


def default_argument_parser() -> argparse.ArgumentParser:
    """`test_NopeSAC.py`'s flags, with the port's --device and --seed."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-gpus", type=int, default=None)
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--seed", type=int, default=0, help="seeded weights without MODEL.WEIGHTS")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def load_cfg(args) -> CfgNode:
    """The config of --config-file with the KEY VALUE overrides, frozen."""
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def setup_logging(cfg: CfgNode) -> None:
    """INFO to stderr and OUTPUT_DIR/log.txt on rank 0; warnings to stderr
    on the other ranks."""
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    handlers: List[logging.Handler] = [logging.StreamHandler()]
    if is_main_process():
        handlers.append(logging.FileHandler(os.path.join(cfg.OUTPUT_DIR, "log.txt")))
    logging.basicConfig(level=logging.INFO if is_main_process() else logging.WARNING,
                        format="[%(asctime)s %(name)s] %(message)s", handlers=handlers)


def run(args) -> int:
    """The body of one rank (or of the only process)."""
    cfg = load_cfg(args)
    setup_logging(cfg)
    if cfg.FIX_SEED:
        random.seed(cfg.SEED)
        np.random.seed(cfg.SEED)
        os.environ["PYTHONHASHSEED"] = str(cfg.SEED)
    if cfg.DATASETS.ROOT_DIR:
        datasets.register_builtin(cfg.DATASETS.ROOT_DIR)
    latest = Checkpointer(cfg.OUTPUT_DIR).latest() if args.resume else None
    if args.resume and latest is None:
        logger.info("--resume: no checkpoint in %s", cfg.OUTPUT_DIR)
    tester = EvalRunner(cfg, build_eval_model(cfg, device=args.device, seed=args.seed,
                                              weights=latest))
    results = tester.test()
    if is_main_process():
        for k, v in results.items():
            logger.info("%s: %s", k, v)
        print(json.dumps({"results": {k: float(v) for k, v in results.items()},
                          "eval_stats": tester.last_eval_stats,
                          "device": str(next(tester.model.parameters()).device),
                          "world_size": world_size()}), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = default_argument_parser().parse_args(argv)
    device = resolve_device(args.device)
    num_gpus = 1 if args.num_gpus is None else args.num_gpus
    visible = torch.cuda.device_count() if device.type == "cuda" else None
    if num_gpus < 1 or (visible is not None and num_gpus > visible):
        raise ValueError(f"--num-gpus {num_gpus} requested but {visible} device(s) visible")
    launch(run, num_gpus, args.num_machines, args.machine_rank, args.dist_url,
           device=device.type, args=(args,))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
