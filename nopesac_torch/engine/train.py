"""Training step of NopeSAC on seeded synthetic pairs, and a small CLI.

    python -m nopesac_torch.engine.train --config-file configs/smoke_synthetic.yaml \
        --steps 3 --seed 0 [--device cpu] [--planes N] [KEY VALUE ...]

The CLI builds the model of the config with seeded random weights (the
reference checkpoints are not in the repository), maps seeded synthetic pairs
(`data/synthetic.py`, `--planes` planes per view) into SOLVER.IMS_PER_BATCH
batches and runs `--steps` train steps on `cuda` unless `--device cpu` is
given, printing one JSON line of losses per step. Counterpart of the JAX
package's `engine/train_step.py:make_train_step`. The training entry point
with checkpoints, resume, precise-BN and the eval hook is
`engine/trainer.py`, which runs this `TrainStep`.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config.config import CfgNode, get_cfg
from ..data.mapper import PairMapper, collate
from ..data.packing import batch_to_device
from ..data.synthetic import make_pair
from ..models.layers import BatchNorm2d
from ..models.nopesac import PlaneTRNopeSAC
from ..parallel.dist import all_reduce_sum, rank, world_size
from ..parallel.host_gather import all_gather_objects
from ..utils import trace
from ..utils.device import DeviceLike, resolve_device
from .optimizer import apply_freeze, build_optimizer, clip_by_global_norm_, make_lr_schedule, set_lr
from .predict import build_model_from_cfg


def build_train_model(cfg: CfgNode, device: DeviceLike = None,
                      seed: Optional[int] = None) -> PlaneTRNopeSAC:
    """The model of a config in train mode on `device` (default `cuda`). Its
    parameters and so the optimizer state stay f32 under every dtype policy: the
    layers cast their weights, and autograd sends f32 gradients back to
    them."""
    return build_model_from_cfg(cfg, device=device, seed=seed).train()


class TrainStep:
    """One optimisation step per call: train_forward, backward, the global
    gradient norm, the non-finite skip guard, clipping and the optimizer
    (AdamW, or SGD with momentum: SOLVER.OPTIMIZER).

    When the total loss or the gradient norm is not finite the step leaves
    the parameters and the optimizer state as they were and puts back the BN
    running statistics, which the forward pass has already updated; the
    learning-rate schedule does not advance. `gen` (seeded with seed + rank,
    on the model's device) draws the dropout masks and the AIM random poses
    of every step.

    Across ranks (a process group of more than one) each rank backpropagates
    its share of the global batch's loss (`models/nopesac.py:train_forward`),
    and the gradients are summed over the ranks (`reduce_gradients`), so the
    gradient norm, the clipping and the optimizer step see the gradient of the
    global loss, the same on every rank. The logged losses and the skip
    guard's total are the global ones, the shares summed over the ranks.
    The random streams differ from rank to rank, as in the reference's
    per-rank seeding; the JAX step's one global key has no per-rank
    counterpart.
    """

    def __init__(self, model: PlaneTRNopeSAC, cfg: CfgNode, seed: int = 0):
        s = cfg.SOLVER
        self.model = model
        self.frozen = apply_freeze(model, cfg.MODEL.FREEZE)
        self.optimizer = build_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.schedule = make_lr_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_ITERS,
                                         s.WARMUP_FACTOR)
        clip = s.CLIP_GRADIENTS
        self.clip_value = (clip.CLIP_VALUE if clip.ENABLED and clip.CLIP_TYPE == "full_model"
                           else None)
        dev = next(model.parameters()).device
        self.gen = torch.Generator(device=dev).manual_seed(seed + rank())
        self.bn_buffers = [buf for m in model.modules() if isinstance(m, BatchNorm2d)
                           for buf in (m.running_mean, m.running_var)]
        self.step = 0     # calls, skipped or not
        self.updates = 0  # applied updates: the schedule's count

    def state_dict(self) -> Dict:
        """What a resume needs besides the model: the optimizer state, the two
        counts and the generator's state. The generator runs on across
        steps (the JAX step folds the step into a fixed key instead), so a
        resume repeats the uninterrupted run's draws only with it. Across
        ranks every rank calls it: "rank_generators" gathers each rank's
        state, and a resume on as many ranks gives each its own back."""
        state = {"optimizer": self.optimizer.state_dict(), "step": self.step,
                 "updates": self.updates, "generator": self.gen.get_state()}
        if world_size() > 1:
            state["rank_generators"] = all_gather_objects(self.gen.get_state())
        return state

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.updates = int(state["step"]), int(state["updates"])
        gens = state.get("rank_generators")
        self.gen.set_state(gens[rank()] if gens is not None and len(gens) == world_size()
                           else state["generator"])

    def __call__(self, batch: Dict, aim_rot=None, aim_trans=None) -> Dict[str, torch.Tensor]:
        with trace.span("train.step"):
            self.optimizer.zero_grad(set_to_none=True)
            saved_bn = [buf.clone() for buf in self.bn_buffers]
            losses, total = self.forward_backward(batch, aim_rot, aim_trans)
            grad_norm, ok = self.apply_gradients(finite_total=torch.isfinite(total))
            if not ok:
                with torch.no_grad():
                    for buf, old in zip(self.bn_buffers, saved_bn):
                        buf.copy_(old)
            self.step += 1
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["total_loss"] = total.detach()
            metrics["grad_norm"] = grad_norm.detach()
            metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
            return metrics

    def forward_backward(self, batch: Dict, aim_rot=None, aim_trans=None
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """train_forward and its backward, the gradients summed over the
        ranks into the parameters' .grad: (the global losses, their f32
        total). A non-finite share on any rank makes the global total
        non-finite on every rank."""
        with trace.span("train.forward"):
            losses = self.model.train_forward(batch, self.gen, aim_rot, aim_trans)
            total = torch.stack([v.to(torch.float32) for v in losses.values()]).sum()
        with trace.span("train.backward"):
            total.backward()
        with trace.span("train.reduce_gradients"):
            reduce_gradients(self.params)
            *global_losses, total = all_reduce_sum(list(losses.values()) + [total])
        return dict(zip(losses, global_losses)), total

    def apply_gradients(self, finite_total=True) -> Tuple[torch.Tensor, bool]:
        """The update from the parameters' .grad (None counts as zeros):
        the global gradient norm, then, unless it or `finite_total` is not
        finite, clipping, the scheduled lr and one optimizer step. Returns the
        norm (before clipping) and whether the update was applied."""
        with trace.span("train.verdict"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
            grad_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if not bool(torch.isfinite(grad_norm) & finite_total):
                return grad_norm, False
        with trace.span("train.optimizer"):
            for p, g in zip(self.params, grads):
                p.grad = g
            if self.clip_value is not None:
                clip_by_global_norm_(grads, grad_norm, self.clip_value)
            set_lr(self.optimizer, self.schedule(self.updates))
            self.optimizer.step()
            self.updates += 1
            return grad_norm, True


def reduce_gradients(params: List[torch.Tensor]) -> int:
    """Sum the gradients of `params` over the ranks: one all-reduce of a
    flat buffer per dtype, each .grad then a view of it. A parameter without
    a gradient enters as zeros, so every rank reduces the same buffer.
    Returns the bytes reduced; at world size 1 nothing is called and 0."""
    if world_size() == 1:
        return 0
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    n_bytes = 0
    for group in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        dist.all_reduce(flat)
        k = 0
        for p in group:
            p.grad = flat[k:k + p.numel()].view_as(p)
            k += p.numel()
        n_bytes += flat.numel() * flat.element_size()
    return n_bytes


def synthetic_host_batches(cfg: CfgNode, n_batches: int, seed: int,
                           n_planes: int = 6) -> Iterable[Dict]:
    """Collated numpy batches of SOLVER.IMS_PER_BATCH seeded synthetic pairs,
    as the loader hands them to `batch_to_device`."""
    h, w = cfg.INPUT.IMAGE_SIZE
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, (h, w), cfg.MODEL.PIXEL_MEAN,
                        cfg.MODEL.PIXEL_STD)
    rng = np.random.default_rng(seed)
    bs = cfg.SOLVER.IMS_PER_BATCH
    for k in range(n_batches):
        pairs = [make_pair(rng, n_planes=n_planes, h=h, w=w, pair_id=k * bs + i)
                 for i in range(bs)]
        yield collate([mapper(p) for p in pairs])


def synthetic_batches(cfg: CfgNode, n_batches: int, seed: int, n_planes: int = 6,
                      device: DeviceLike = None) -> Iterable[Dict]:
    """`synthetic_host_batches` on `device`, targets in the wire format."""
    dev = resolve_device(device)
    for batch in synthetic_host_batches(cfg, n_batches, seed, n_planes):
        yield batch_to_device(batch, dev)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--planes", type=int, default=6, help="planes per synthetic view (<= 12)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    model = build_train_model(cfg, device=args.device, seed=args.seed)
    step = TrainStep(model, cfg, seed=args.seed)
    for k, batch in enumerate(synthetic_batches(cfg, args.steps, args.seed + 1, args.planes,
                                                args.device)):
        t0 = time.perf_counter()
        metrics = step(batch)
        if batch["image0"].is_cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        row = {"step": k, "total_loss": float(metrics["total_loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "skipped_nonfinite": int(metrics["skipped_nonfinite"]),
               "seconds": round(secs, 4), "device": str(batch["image0"].device)}
        row["losses"] = {n: float(v) for n, v in metrics.items()
                         if n not in ("total_loss", "grad_norm", "skipped_nonfinite")}
        if not all(math.isfinite(v) for v in row["losses"].values()):
            row["nonfinite"] = sorted(n for n, v in row["losses"].items() if not math.isfinite(v))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
