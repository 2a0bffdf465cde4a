"""AdamW or SGD (SOLVER.OPTIMIZER) with the JAX package's parameter groups
(counterpart of its `engine/optimizer.py`, an optax chain): per-module lr
multipliers, weight decay 0 for norm layers and SOLVER.WEIGHT_DECAY_EMBED for
the query embedding, MODEL.FREEZE, full-model gradient clipping and
detectron2's WarmupMultiStepLR schedule.

The optax chain computes, per leaf, update = -lr(count) * mult *
(adam(g) + wd * p); torch's AdamW with lr = lr(count) * mult and
weight_decay = wd does the same arithmetic (decoupled decay scaled by lr).
For SGD the chain is trace(SOLVER.MOMENTUM), then the decay, then the lr:
update = -lr(count) * mult * (buf + wd * p) with buf = momentum * buf + g
from buf = 0. torch.optim.SGD(weight_decay=wd) is not that (it adds wd * p
to g inside the buffer), so `SGD` below keeps the decay outside it.
An unknown SOLVER.OPTIMIZER raises (the JAX package takes any value other
than ADAMW as SGD).
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence

import torch
import torch.nn as nn

from ..models.layers import BatchNorm2d

_NORMS = (nn.LayerNorm, nn.GroupNorm, BatchNorm2d)


def make_lr_schedule(base_lr: float, steps: Sequence[int], gamma: float, warmup_iters: int,
                     warmup_factor: float) -> Callable[[int], float]:
    """lr(count) = base_lr * gamma^(milestones passed) * linear warmup."""
    steps = sorted(int(s) for s in steps)

    def schedule(count: int) -> float:
        lr = base_lr * gamma ** sum(count >= s for s in steps)
        if warmup_iters > 0 and warmup_factor < 1.0:
            alpha = min(max(count / warmup_iters, 0.0), 1.0)
            lr *= warmup_factor * (1 - alpha) + alpha
        return lr

    return schedule


def lr_group(name: str) -> str:
    """LR-multiplier group of a parameter: a substring test on its name, in
    this order, as the reference's build_optimizer does (so the camera
    head's `convs_backbone` takes the backbone multiplier too)."""
    for key, group in (("backbone", "backbone"), ("sem_seg_head", "sem_seg_head"),
                       ("matching_head", "matcher")):
        if key in name:
            return group
    return "default"


def decay_group(name: str, owner: nn.Module) -> str:
    """Weight-decay group by the owning module: the query embedding, norm
    layers (their scales and biases), or regular."""
    if "query_embed" in name:
        return "embed"
    return "norm" if isinstance(owner, _NORMS) else "regular"


def apply_freeze(model: nn.Module, frozen: Iterable[str]) -> List[str]:
    """MODEL.FREEZE: parameters whose name contains one of `frozen` stop
    taking gradients (and so updates). Returns their names."""
    frozen = [f for f in frozen if f]
    names = []
    for name, p in model.named_parameters():
        if any(f in name for f in frozen):
            p.requires_grad_(False)
            names.append(name)
    return names


class SGD(torch.optim.Optimizer):
    """SGD with momentum and weight decay outside the momentum buffer, as the
    optax chain trace -> add_decayed_weights -> scale(-lr) computes it:
    buf = momentum * buf + g (buf = 0 before the first step), then
    p -= lr * (buf + weight_decay * p). The buffers are the optimizer state
    (`momentum_buffer`), which a checkpoint saves."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "momentum": momentum, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, momentum, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.mul_(momentum).add_(p.grad)
                p.add_(buf + wd * p if wd else buf, alpha=-lr)


OPTIMIZERS = ("ADAMW", "SGD")


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW or SGD (SOLVER.OPTIMIZER, SGD with SOLVER.MOMENTUM) over the
    trainable parameters, one group per (lr multiplier, weight decay); each
    group carries its `lr_mult`. FrozenBN statistics are buffers and never
    reach it."""
    s = cfg.SOLVER
    kind = s.OPTIMIZER.upper()
    if kind not in OPTIMIZERS:
        raise ValueError(f"SOLVER.OPTIMIZER must be one of {OPTIMIZERS}, got {s.OPTIMIZER!r}")
    mults = {"backbone": s.BACKBONE_MULTIPLIER, "sem_seg_head": s.SEM_SEG_HEAD_MULTIPLIER,
             "matcher": s.PLANE_MATCHER_HEAD_MULTIPLIER, "default": 1.0}
    decays = {"regular": s.WEIGHT_DECAY, "norm": s.get("WEIGHT_DECAY_NORM", 0.0),
              "embed": s.WEIGHT_DECAY_EMBED}
    groups = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            key = (mults[lr_group(name)], decays[decay_group(name, mod)])
            groups.setdefault(key, []).append(p)
    param_groups = [{"params": ps, "lr": s.BASE_LR * m, "lr_mult": m, "weight_decay": wd}
                    for (m, wd), ps in groups.items()]
    if kind == "SGD":
        return SGD(param_groups, lr=s.BASE_LR, momentum=s.MOMENTUM)
    return torch.optim.AdamW(param_groups, lr=s.BASE_LR, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_mult"]


def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm where norm
    >= max_norm, on the device (no host sync)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
