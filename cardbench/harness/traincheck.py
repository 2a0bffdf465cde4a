"""What decides `correct` in the training cells.

Set-up drives the program's train step through its first three steps; the
reference follows them from the same weights, pairs and random stream:

* `loss_gap`: |total loss difference| of the first step, over the
  reference's total (steps 2 and 3 are not compared: the backward's
  nondeterministic sums move them as much in the reference against
  itself);
* `grad_gap`: by the worst leaf, |norm of the program's first gradient as
  AdamW holds it (its first moment after one step over 1 - beta1) - the
  reference's|, over the larger of the reference's norm of that leaf and
  the median leaf's;
* `update_gap`: the median leaf's |norm of its change over the three steps
  - the reference's| over the larger of the reference's norm and the median
  leaf's. (By the worst leaf it swings from seed to seed as much in the
  reference against itself: the later steps' discrete choices, such as the
  matcher's assignment, follow the backward's nondeterministic sums.)

The window's first step is held too: the program's state as set-up hands
it to the window (parameters and AdamW's moments, host copies) is the
reference's start, the reference's own random stream after its three steps
the step's, and the step's loss, its gradient (from the first moment's
change) and its update are compared as above, all by the worst leaf
(`window.loss_gap`, `window.grad_gap`, `window.update_gap`). The three
set-up steps check the stage this start skips.

Leaves whose reference gradient is under `ROUNDING` of the median leaf's
are nought to rounding and move by round-off alone under AdamW: they are
left out of the updates. At the cells' sizes that is the first decoder
layer's self-attention and norms (their input is the zero target: exactly
0) and the matcher's bin score (a few 1e-9); the camera head's small leaves
(1e-4 and up, the score heads' biases from 5e-7) stay in.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import scenes

BETA1 = 0.9  # the AdamW of engine/optimizer.py
CHECKED_STEPS = 3
ROUNDING = 1e-7


def step_seed(ctx) -> int:
    """The train step's random stream (dropout, AIM poses) of the run."""
    return ctx.torch_seed(4) % 2**31


def make_pairs(ctx):
    """The ring's pairs: ring_batches x SOLVER.IMS_PER_BATCH seeded scenes
    with their dense masks."""
    tr = ctx.traffic
    h, w = ctx.tree["INPUT"]["IMAGE_SIZE"]
    n = tr["ring_batches"] * int(ctx.tree["SOLVER"]["IMS_PER_BATCH"])
    return scenes.pool(ctx.rng(1), n, tr["planes"], h, w, dense_masks=True)


def window_batch(ctx, pairs):
    """The pairs of the window's first step (the ring's batch after the
    checked ones)."""
    bs = int(ctx.tree["SOLVER"]["IMS_PER_BATCH"])
    k = CHECKED_STEPS % ctx.traffic["ring_batches"]
    return pairs[k * bs:(k + 1) * bs]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _trained(model: torch.nn.Module):
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def first_gradients(model: torch.nn.Module, optimizer) -> Dict[str, torch.Tensor]:
    """name -> the first gradient as AdamW got it, from its first moment
    after one step (host copies)."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st and "exp_avg" in st:
            out[name] = (st["exp_avg"].detach().float() / (1.0 - BETA1)).cpu()
    return out


def params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().float().cpu().clone() for n, p in _trained(model)}


def snapshot(model: torch.nn.Module, optimizer) -> Dict[str, Dict]:
    """Host copies of the parameters and of AdamW's state, by name."""
    out = {"params": params(model), "exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    for name, p in _trained(model):
        st = optimizer.state.get(p) or {}
        for key in ("exp_avg", "exp_avg_sq", "step"):
            out[key][name] = (st[key].detach().float().cpu().clone() if key in st else
                              torch.zeros(() if key == "step" else p.shape))
    return out


def load_snapshot(model: torch.nn.Module, optimizer, state: Dict[str, Dict]) -> None:
    """Put `state` (a `snapshot`) into the model's parameters and AdamW's
    state."""
    with torch.no_grad():
        for name, p in _trained(model):
            p.copy_(state["params"][name])
            st = optimizer.state[p]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                st[key].copy_(state[key][name])


def window_record(state: Dict[str, Dict], loss: float, end: Dict[str, torch.Tensor],
                  exp_avg: Dict[str, torch.Tensor]) -> Dict:
    """One step from `state`: its loss, its gradient as AdamW got it (from
    the first moment's change), its start and end."""
    grads = {n: (exp_avg[n] - BETA1 * state["exp_avg"][n]) / (1.0 - BETA1) for n in exp_avg}
    return {"losses": [loss], "grads": grads, "start": state["params"], "end": end}


class WindowCapture:
    """The program's parameters and first moments after the window's first
    step, copied into pinned host buffers made at set-up, queued behind the
    step on its stream (no wait in the window)."""

    def __init__(self, state: Dict[str, Dict], pin: bool):
        names = list(state["params"])
        sizes = [state["params"][n].numel() for n in names]
        self._flat = [torch.empty(sum(sizes), dtype=torch.float32, pin_memory=pin)
                      for _ in range(2)]
        self.state = state
        self.end, self.exp_avg = ({n: t.view(state["params"][n].shape)
                                   for n, t in zip(names, flat.split(sizes))}
                                  for flat in self._flat)
        self.loss: Optional[torch.Tensor] = None

    def take(self, model: torch.nn.Module, optimizer, loss: torch.Tensor) -> None:
        for name, p in _trained(model):
            self.end[name].copy_(p.detach(), non_blocking=True)
            st = optimizer.state.get(p) or {}
            if "exp_avg" in st:
                self.exp_avg[name].copy_(st["exp_avg"].detach(), non_blocking=True)
            else:
                self.exp_avg[name].zero_()
        self.loss = loss

    def record(self) -> Optional[Dict]:
        """After a synchronise: the step's `window_record`, or None if the
        window ran no step."""
        if self.loss is None:
            return None
        return window_record(self.state, float(self.loss), self.end, self.exp_avg)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> torch.Tensor:
    """Per leaf |prog - ref| over the larger of ref and the median leaf's ref."""
    med = float(torch.tensor([ref[n] for n in names]).median())
    return torch.tensor([abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names])


def gaps(prog: Dict, ref: Dict, update_by=torch.max) -> Dict[str, float]:
    """prog / ref: {"losses": [total of each step], "grads": {name: tensor},
    "start": {name: tensor}, "end": {name: tensor}}; the first step's loss,
    the worst leaf's gradient, the update by `update_by` over the leaves
    that are not nought to rounding."""
    inf = float("inf")
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30)
    gp, gr = norms(prog["grads"]), norms(ref["grads"])
    if set(gp) != set(gr) or not gr:
        return {"loss_gap": loss_gap, "grad_gap": inf, "update_gap": inf}
    names = sorted(gr)
    med = float(torch.tensor([gr[n] for n in names]).median())
    moving = [n for n in names if gr[n] >= ROUNDING * med]
    dp = norms({n: prog["end"][n] - prog["start"][n] for n in moving})
    dr = norms({n: ref["end"][n] - ref["start"][n] for n in moving})
    return {"loss_gap": loss_gap, "grad_gap": float(_leaf_gaps(gp, gr, names).max()),
            "update_gap": float(update_by(_leaf_gaps(dp, dr, moving))) if moving else inf}


def all_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The set-up steps' numbers and the window step's ("window."); the
    window's are inf where the program ran no window step."""
    out = gaps(prog, ref, update_by=torch.median)
    if prog.get("window") is None:
        out.update({f"window.{k}": float("inf") for k in ("loss_gap", "grad_gap", "update_gap")})
    else:
        out.update({f"window.{k}": v for k, v in gaps(prog["window"], ref["window"]).items()})
    return out


def reference_steps(ctx, pairs, seed: int, state: Optional[Dict] = None) -> dict:
    """The reference's first three steps from the run's weights, on the same
    pairs (mapped by its own mapper) and random stream; then the window's
    first step, from `state` (the program's after its three steps) or,
    without one, from its own (the control's stand-in for the program).
    `own` is its state after the three steps."""
    from ..reference.build import TrainStep
    from ..reference.data.mapper import PairMapper, collate
    from ..reference.data.packing import batch_to_device

    cfg = ctx.ref_cfg()
    bs = int(cfg.SOLVER.IMS_PER_BATCH)
    model = ctx.reference_model(train=True)
    step = TrainStep(model, cfg, seed=seed)
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, tuple(cfg.INPUT.IMAGE_SIZE),
                        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)

    def batch(ps):
        return batch_to_device(collate([mapper(p) for p in ps]), ctx.device)

    ref = {"start": params(model), "losses": []}
    for k in range(CHECKED_STEPS):
        losses, _ = step(batch(pairs[k * bs:(k + 1) * bs]))
        ref["losses"].append(losses["total_loss"])
        if k == 0:
            ref["grads"] = first_gradients(model, step.optimizer)
    ref["own"] = snapshot(model, step.optimizer)
    ref["end"] = ref["own"]["params"]
    if state is not None:
        load_snapshot(model, step.optimizer, state)
    losses, _ = step(batch(window_batch(ctx, pairs)))
    exp_avg = {n: step.optimizer.state[p]["exp_avg"].detach().cpu() for n, p in _trained(model)}
    ref["window"] = window_record(state or ref["own"], losses["total_loss"], params(model), exp_avg)
    del step, model
    ctx.free()
    return ref
