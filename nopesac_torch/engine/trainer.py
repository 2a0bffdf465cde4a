"""The training entry point of the port (counterpart of the JAX package's
`engine/trainer.py:Trainer` and of `train_NopeSAC.py`).

    python -m nopesac_torch.engine.trainer --config-file configs/smoke_synthetic.yaml \
        [--resume] [--eval-only] [--num-gpus N] [--num-machines M --machine-rank R \
        --dist-url tcp://host:port] [--device cpu] [KEY VALUE ...]

The CLI takes `train_NopeSAC.py`'s flags and trains on `cuda` unless
`--device cpu` is given. It runs N ranks on each of M machines
(`parallel/dist.py:launch`): N defaults to the greatest common divisor of
SOLVER.IMS_PER_BATCH and the visible cards (1 on the CPU), may not exceed
them, and N x M must divide SOLVER.IMS_PER_BATCH, as in the JAX package's
`Trainer` (`--eval-only` skips that check). Each rank loads its strided
shard of the training split, IMS_PER_BATCH / (N x M) pairs per step; the
ranks together compute the JAX package's global step (`engine/train.py`).
Rank 0 alone writes config.yaml, metrics.json, the TensorBoard events, the
log rows and the checkpoints; a `--resume` raises unless every rank sees the
same latest checkpoint. `Trainer` dumps the config to OUTPUT_DIR/config.yaml,
builds the model with seeded weights (SEED), overlays MODEL.WEIGHTS on it
(`engine/checkpoint.py:load_weights`: curriculum step N's model_final.pth
feeds step N+1, whose new submodules keep their init), freezes MODEL.FREEZE
and runs `engine/train.py:TrainStep` over the `data/loader.py:PairLoader`
stream of DATASETS.TRAIN[0]. The loop follows the JAX `Trainer.train`:
  * a metrics.json row every 20 steps and on the last (every loss,
    total_loss, grad_norm, skipped_nonfinite, time_per_iter, and
    time_per_iter_recent from the second row on), and the same scalars as
    TensorBoard events (cfg.TENSORBOARD_ON); a fresh start truncates
    metrics.json, a resumed one appends;
  * a checkpoint every SOLVER.CHECKPOINT_PERIOD steps
    (OUTPUT_DIR/model_{iter:07d}.pth, with the optimizer and trainer state);
  * every TEST.EVAL_PERIOD steps, precise-BN (TEST.PRECISE_BN) and then
    `test()`, an `engine/test.py:EvalRunner` over DATASETS.TEST[0] on the
    same module in eval mode (on every rank, each over its slice of the
    split), whose metrics go to metrics.json as
    {"iteration", "eval"} and to TensorBoard under eval/. An exception in
    the hook is logged and training goes on; `last_eval_error` keeps it;
  * at the end, precise-BN with the last periodic checkpoint rewritten, and
    OUTPUT_DIR/model_final.pth.
`--resume` restores the latest checkpoint (model, optimizer state, the step and
update counts, the generator) and continues from its step with a fresh
loader iterator, as the JAX `Trainer` does: the batches after a resume are
not the ones an uninterrupted run would have drawn. Without a checkpoint it
logs and starts fresh. `--eval-only` evaluates the model the flags give.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.config import CfgNode
from ..data import datasets
from ..data.loader import PairLoader
from ..data.mapper import PairMapper
from ..data.packing import batch_to_device
from ..data.registry import DatasetCatalog
from ..parallel.dist import broadcast_module, is_main_process, launch, rank, world_size
from ..parallel.host_gather import all_gather_objects
from ..utils.device import DeviceLike, resolve_device
from ..utils.tb_writer import TBScalarWriter
from .checkpoint import Checkpointer, load_weights
from .precise_bn import recompute_batch_stats
from .test import EvalRunner, load_cfg, setup_logging
from .train import TrainStep, build_train_model

logger = logging.getLogger(__name__)
LOG_PERIOD = 20


def flatten_metrics(tree: Dict, prefix: str = "") -> Dict[str, float]:
    """Nested evaluator results -> {dotted key: float}; non-numbers dropped."""
    flat: Dict[str, float] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_metrics(v, prefix=f"{key}."))
        else:
            try:
                flat[key] = float(v)
            except (TypeError, ValueError):
                continue
    return flat


def resolve_num_gpus(cfg: CfgNode, num_gpus: Optional[int], num_machines: int,
                     device_type: str, training: bool = True) -> int:
    """The ranks per machine of `--num-gpus`, checked as the JAX package's
    `Trainer` checks it: no more than the visible cards; by default the greatest common divisor of
    SOLVER.IMS_PER_BATCH and the visible cards (1 on the CPU); in training,
    the ranks of all machines must divide SOLVER.IMS_PER_BATCH."""
    bs = int(cfg.SOLVER.IMS_PER_BATCH)
    visible = torch.cuda.device_count() if device_type == "cuda" else None
    if num_gpus is None:
        num_gpus = math.gcd(bs, visible) if visible else 1
        if visible and num_gpus != visible:
            logger.warning("using %d of %d devices (batch %d not divisible)", num_gpus, visible,
                           bs)
    elif num_gpus < 1:
        raise ValueError(f"--num-gpus must be at least 1, got {num_gpus}")
    elif visible is not None and num_gpus > visible:
        raise ValueError(f"--num-gpus {num_gpus} requested but only {visible} device(s) visible")
    world = num_gpus * num_machines
    if training and bs % world != 0:
        raise ValueError(f"SOLVER.IMS_PER_BATCH={bs} does not divide by the {world} ranks "
                         f"(--num-gpus {num_gpus} x --num-machines {num_machines})")
    return num_gpus


class Trainer:
    """Training of one model, as the JAX `Trainer` does it: on one device,
    or as one rank of a process group (`parallel/dist.py`), whose ranks
    together take the JAX package's global step."""

    def __init__(self, cfg: CfgNode, dataset_list: Optional[List[dict]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        if is_main_process():
            with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
                f.write(cfg.dump())
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        self._train_dataset = dataset_list
        self._loader: Optional[PairLoader] = None
        self.last_eval_stats: Dict = {}
        self.last_eval_error: Optional[BaseException] = None
        # seconds per step blocked in next(loader), per checkpoint save, per
        # precise-BN pass and per test() of the loop's last train() call
        self.loop_times: Dict[str, List[float]] = {}
        self.model = build_train_model(cfg, device=self.device, seed=cfg.SEED)
        self.weights_report = None
        if cfg.MODEL.WEIGHTS:
            self.weights_report = load_weights(self.model, cfg.MODEL.WEIGHTS, strict=False)
        broadcast_module(self.model)  # every rank starts from rank 0's weights
        # a fresh optimizer per curriculum step: MODEL.WEIGHTS brings weights only
        self.train_step = TrainStep(self.model, cfg, seed=cfg.SEED)

    def _build_train_loader(self) -> PairLoader:
        """This rank's loader: every world-th pair of the split from its rank
        on, SOLVER.IMS_PER_BATCH / world pairs per batch."""
        cfg = self.cfg
        world = world_size()
        if cfg.SOLVER.IMS_PER_BATCH % world != 0:
            raise ValueError(f"SOLVER.IMS_PER_BATCH={cfg.SOLVER.IMS_PER_BATCH} does not divide "
                             f"by the {world} ranks")
        name = cfg.DATASETS.TRAIN[0]
        mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, tuple(cfg.INPUT.IMAGE_SIZE),
                            cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, is_train=True,
                            root_dir=cfg.DATASETS.ROOT_DIR,
                            dataset_kind=datasets.dataset_kind(name),
                            augmentation=cfg.DATALOADER.AUGMENTATION, seed=cfg.SEED,
                            camera_cls_on=cfg.MODEL.CAMERA_HEAD.CLASSIFICATION_ON)
        return PairLoader(self._train_dataset or DatasetCatalog.get(name), mapper,
                          batch_size=cfg.SOLVER.IMS_PER_BATCH // world, shuffle=True,
                          drop_last=True, seed=cfg.SEED, num_shards=world, shard_id=rank(),
                          infinite=True, num_workers=int(cfg.DATALOADER.NUM_WORKERS))

    @property
    def loader(self) -> PairLoader:
        if self._loader is None:
            self._loader = self._build_train_loader()
        return self._loader

    def resume_or_load(self, resume: bool = False) -> None:
        """With `resume`, restore the latest checkpoint of OUTPUT_DIR; the
        MODEL.WEIGHTS overlay already happened at construction. Across ranks
        every rank must see the same latest checkpoint (OUTPUT_DIR on a
        filesystem that every machine shares), or it raises."""
        if not resume:
            return
        latest = self.checkpointer.latest()
        tags = all_gather_objects(latest and os.path.basename(latest))
        if len(set(tags)) != 1:
            raise RuntimeError(f"--resume: the ranks disagree on the latest checkpoint (per rank: "
                               f"{tags}); OUTPUT_DIR must be a filesystem every rank sees")
        iteration = self.checkpointer.restore(self.model, self.train_step)
        if iteration is None:
            logger.info("--resume: no checkpoint found, starting fresh")
        else:
            logger.info("resumed from step %d", iteration)

    def _timed(self, key: str, fn, sync: bool = True):
        """fn(), its seconds appended to loop_times[key]; with `sync`, up to
        the end of the work it queued on the card."""
        t0 = time.perf_counter()
        out = fn()
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.loop_times.setdefault(key, []).append(time.perf_counter() - t0)
        return out

    def _save(self, iteration: int, name: Optional[str] = None) -> str:
        return self._timed("checkpoint_s", lambda: self.checkpointer.save(
            self.model, self.train_step, iteration, name))

    # ------------------------------------------------------------------
    def train(self, max_iter: Optional[int] = None) -> TrainStep:
        cfg = self.cfg
        max_iter = max_iter or cfg.SOLVER.MAX_ITER
        metrics_path = os.path.join(cfg.OUTPUT_DIR, "metrics.json")
        main = is_main_process()
        tb = (TBScalarWriter(cfg.OUTPUT_DIR) if main and cfg.get("TENSORBOARD_ON", True)
              else None)
        start = self.train_step.step
        if start == 0 and main:
            open(metrics_path, "w").close()
        self.loop_times = {}
        self.model.train()
        t0 = time.time()
        last_log = None
        it = iter(self.loader)
        for step in range(start, max_iter):
            batch = self._timed("loader_wait_s", lambda: next(it), sync=False)
            metrics = self.train_step(batch_to_device(batch, self.device))
            if main and (step % LOG_PERIOD == 0 or step == max_iter - 1):
                m = {k: float(v) for k, v in metrics.items()}
                m["iteration"] = step
                now = time.time()
                m["time_per_iter"] = (now - t0) / max(step - start + 1, 1)
                if last_log is not None:
                    m["time_per_iter_recent"] = (now - last_log[1]) / max(step - last_log[0], 1)
                last_log = (step, now)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(m) + "\n")
                if tb is not None:
                    tb.add_scalars(m, step=step)
                logger.info("iter %d total %.4f", step, m["total_loss"])
            if (step + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                self._save(step + 1)
            if cfg.TEST.EVAL_PERIOD > 0 and (step + 1) % cfg.TEST.EVAL_PERIOD == 0:
                self._eval_hook(step, metrics_path, tb)
        it.close()
        if cfg.TEST.PRECISE_BN.ENABLED:
            self._precise_bn()
            self._save(max_iter)  # rewrite the periodic checkpoint
        self._save(max_iter, name="model_final")
        if tb is not None:
            tb.close()
        return self.train_step

    def _eval_hook(self, step: int, metrics_path: str, tb) -> None:
        # precise-BN before every evaluation, as detectron2's PreciseBN hook
        try:
            if self.cfg.TEST.PRECISE_BN.ENABLED:
                self._precise_bn()
            res = self._timed("eval_s", self.test)
            if res and is_main_process():
                row = {"iteration": step, "eval": flatten_metrics(res)}
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                if tb is not None:
                    tb.add_scalars({f"eval/{k}": v for k, v in row["eval"].items()}, step=step)
        except Exception as e:  # evaluation must not end training
            self.last_eval_error = e
            logger.warning("eval failed: %r", e)

    def _precise_bn(self) -> None:
        """Recompute the BN statistics over <= NUM_ITER batches of a fresh
        iterator of the training stream, the parameters frozen; dropout
        drawn from a generator seeded 0 (the JAX package's PRNGKey(0))."""
        n_iter = self.cfg.TEST.PRECISE_BN.NUM_ITER
        logger.info("precise-BN: recomputing batch statistics over <=%d batches", n_iter)
        it = iter(self.loader)
        gen = torch.Generator(device=self.device).manual_seed(0)
        batches = (b for _, b in zip(range(n_iter), it))
        self._timed("precise_bn_s", lambda: recompute_batch_stats(self.model, batches, n_iter,
                                                                   gen=gen))
        it.close()

    # ------------------------------------------------------------------
    def test(self, dataset_list: Optional[List[dict]] = None):
        """EvalRunner.test on this module in eval mode; train mode after."""
        was_training = self.model.training
        self.model.eval()
        try:
            runner = EvalRunner(self.cfg, self.model)
            results = runner.test(dataset_list)
            self.last_eval_stats = runner.last_eval_stats
        finally:
            self.model.train(was_training)
        return results

    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
            self._loader = None


def default_argument_parser() -> argparse.ArgumentParser:
    """`train_NopeSAC.py`'s flags, with the port's --device."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in OUTPUT_DIR")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-gpus", type=int, default=None)
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                   help="KEY VALUE config overrides")
    return p


def setup(args) -> CfgNode:
    cfg = load_cfg(args)
    setup_logging(cfg)
    if cfg.FIX_SEED:
        random.seed(cfg.SEED)
        np.random.seed(cfg.SEED)
        torch.manual_seed(cfg.SEED)
        os.environ["PYTHONHASHSEED"] = str(cfg.SEED)
    if cfg.DATASETS.ROOT_DIR:
        datasets.register_builtin(cfg.DATASETS.ROOT_DIR)
    return cfg


def run(args) -> int:
    """The body of one rank (or of the only process)."""
    cfg = setup(args)
    trainer = Trainer(cfg, device=args.device)
    try:
        trainer.resume_or_load(resume=args.resume)
        if args.eval_only:
            results = trainer.test()
            row = {"results": flatten_metrics(results), "eval_stats": trainer.last_eval_stats}
        else:
            trainer.train()
            row = {"iteration": trainer.train_step.step, "output_dir": cfg.OUTPUT_DIR,
                   "device": str(trainer.device), "world_size": world_size()}
    finally:
        trainer.close()
    if is_main_process():
        print(json.dumps(row), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = default_argument_parser().parse_args(argv)
    device = resolve_device(args.device)
    num_gpus = resolve_num_gpus(load_cfg(args), args.num_gpus, args.num_machines, device.type,
                                training=not args.eval_only)
    launch(run, num_gpus, args.num_machines, args.machine_rank, args.dist_url,
           device=device.type, args=(args,))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
