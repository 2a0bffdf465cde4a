"""The evaluation entry point: batched inference over a test split, the host
postprocess, MP3DEvaluator and its artifacts (counterpart of the JAX
package's `Trainer.test` and `test_NopeSAC.py`).

    python -m nopesac_torch.engine.test --config-file configs/smoke_synthetic.yaml \
        --eval-only [--device cpu] [--seed 0] TEST.EVAL_FULL_SCENE True

The CLI takes `test_NopeSAC.py`'s flags. It evaluates cfg.DATASETS.TEST[0] on
`cuda` unless `--device cpu` is given, logs the metrics and prints them as
one JSON line. With TEST.EVAL_FULL_SCENE it writes
`NopeSAC_instances_predictions.pth` and `continuous.pkl` into OUTPUT_DIR,
which `eval.py` reads. MODEL.WEIGHTS names a torch checkpoint (`.pth`: a
state_dict, or `{"model": state_dict}`), loaded strictly by
`engine/checkpoint.py:load_weights`; without one the model gets seeded random
weights (`--seed`). With `--resume` the latest training checkpoint in
OUTPUT_DIR (`last_checkpoint`) takes MODEL.WEIGHTS' place when there is one.
Evaluation across processes and the GT-matcher / SP-top-camera ablations are
not ported.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import random
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.config import CfgNode, get_cfg
from ..data import datasets
from ..data.mapper import PairMapper
from ..data.registry import DatasetCatalog
from ..evaluation.evaluator import MP3DEvaluator
from ..evaluation.postprocess import postprocess_batch
from ..models.nopesac import PlaneTRNopeSAC
from ..utils.device import DeviceLike
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
    """Start copying the eval step's outputs to the host without waiting."""
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


class EvalRunner:
    """Evaluation of a model over a test split, as `Trainer.test` does it."""

    def __init__(self, cfg: CfgNode, model: PlaneTRNopeSAC):
        self.cfg = cfg
        self.model = model
        self.last_eval_stats: Dict = {}

    def test(self, dataset_list: Optional[List[dict]] = None) -> "OrderedDict":
        """Evaluate over `dataset_list` (default: cfg.DATASETS.TEST[0])."""
        cfg = self.cfg
        if cfg.TEST.POSE_REFINEMENT_WITH_GT_MATCHERS:
            raise NotImplementedError("TEST.POSE_REFINEMENT_WITH_GT_MATCHERS is not ported")
        if cfg.MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON:
            raise NotImplementedError("MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON is not ported")
        test_name = cfg.DATASETS.TEST[0]
        if dataset_list is None:
            dataset_list = DatasetCatalog.get(test_name)
        h, w = cfg.INPUT.IMAGE_SIZE
        mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, (h, w),
                            cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, is_train=False,
                            eval_gt_box=bool(cfg.TEST.EVAL_GT_BOX),
                            root_dir=cfg.DATASETS.ROOT_DIR)
        evaluator = MP3DEvaluator(test_name, cfg, dataset_list=dataset_list)
        eval_step = make_eval_step(self.model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        dev = next(self.model.parameters()).device
        bs = int(cfg.TEST.IMS_PER_BATCH)
        debug_camera = bool(cfg.DEBUG_CAMERA_ON)

        def drain(pending):
            chunk, metas, out, done = pending
            if done is not None:
                done.synchronize()
            evaluator.process(chunk, postprocess_batch(_numpy(out), metas, height=h, width=w))

        # one-step pipeline: batch i+1 is enqueued on the card before batch i
        # is fetched and postprocessed on the host
        pending = None
        t0 = time.perf_counter()
        for k, lo in enumerate(range(0, len(dataset_list), bs)):
            if debug_camera:
                print("**********************> ", k + 1, flush=True)
            chunk = dataset_list[lo: lo + bs]
            samples = [mapper(d) for d in chunk]
            n_real = len(samples)
            # the tail batch repeats its last sample so the eval step sees one
            # shape; the repeats are dropped before the postprocess
            samples += [samples[-1]] * (bs - n_real)
            images = [torch.from_numpy(np.stack([s[f"image{i}"] for s in samples])).to(dev)
                      for i in ("0", "1")]
            out = _fetch(eval_step(*images))
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                drain(pending)
            pending = (chunk, [s["meta"] for s in samples[:n_real]], out, done)
        if pending is not None:
            drain(pending)
        secs = time.perf_counter() - t0
        self.last_eval_stats = {"pairs": len(dataset_list), "seconds": round(secs, 3),
                                "pairs_per_sec": round(len(dataset_list) / max(secs, 1e-9), 2)}
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


def setup(args) -> CfgNode:
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s",
                        handlers=[logging.StreamHandler(),
                                  logging.FileHandler(os.path.join(cfg.OUTPUT_DIR, "log.txt"))])
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    args = default_argument_parser().parse_args(argv)
    cfg = setup(args)
    if args.num_machines > 1:
        raise NotImplementedError("evaluation across machines is not ported")
    if args.num_gpus is not None and args.device != "cpu" and \
            args.num_gpus > torch.cuda.device_count():
        raise ValueError(f"--num-gpus {args.num_gpus} requested but only "
                         f"{torch.cuda.device_count()} device(s) visible")
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
    for k, v in results.items():
        logger.info("%s: %s", k, v)
    print(json.dumps({"results": {k: float(v) for k, v in results.items()},
                      "eval_stats": tester.last_eval_stats,
                      "device": str(next(tester.model.parameters()).device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
