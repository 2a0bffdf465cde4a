"""Wrappers that open a `cardbench:<op>` range around a kernel's operation
and, while `capture` is set, add up the least time each call needs
(`roofline.py`) from the call's own shapes and inputs. Data-dependent
counts are kept as device tensors and read after the traced window, so the
wrapper adds no host sync."""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

import torch

from . import roofline
from .spans import RANGE


class Bounds:
    def __init__(self):
        self.capture = False
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._pending: List[Callable[[], None]] = []
        self._undo: List[Callable[[], None]] = []

    def _install(self, module, attr: str, name: str, cost: Callable) -> None:
        fn = getattr(module, attr)
        bounds = self

        def wrapped(*args, **kwargs):
            if bounds.capture:
                bounds.calls[name] += 1
                cost(*args, **kwargs)
            with torch.profiler.record_function(RANGE + name):
                return fn(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, fn))

    def select(self, module, attr: str = "fused_select_maps") -> None:
        """B1: fused_select_maps(mask_prob, score, valid, thr, out_h, out_w)."""
        def cost(mask_prob, score, valid, thr, out_h, out_w):
            b, nq, h, w = mask_prob.shape
            self.seconds["select"] += roofline.select_bound_s(
                b, nq, h, w, out_h, out_w, mask_prob.element_size())
        self._install(module, attr, "select", cost)

    def sinkhorn(self, module, attr: str = "log_optimal_transport_masked") -> None:
        """B2: log_optimal_transport_masked(scores, alpha, iters, rows, cols)."""
        def cost(scores, alpha, iters, row_masks=None, col_masks=None):
            b, m, n = scores.shape
            self.seconds["sinkhorn"] += roofline.sinkhorn_bound_s(b, m, n, int(iters))
        self._install(module, attr, "sinkhorn", cost)

    def mask_loss(self, module, attr: str = "fused_focal_dice") -> None:
        """B3 forward and backward: fused_focal_dice(src, gt_masks, tgt_idx,
        matched). The backward's range opens when the gradient reaches the
        outputs and closes when it leaves src (identity autograd nodes on
        both sides)."""
        fn = getattr(module, attr)
        bounds = self

        def wrapped(src, gt_masks, tgt_idx, matched=None):
            b, nq, h, w = src.shape
            if bounds.capture:
                bounds.calls["mask_loss"] += 1
                n = (matched.sum() if matched is not None
                     else torch.tensor(b * nq, device=src.device))
                size = src.element_size()
                bounds._pending.append(lambda n=n: bounds.seconds.__setitem__(
                    "mask_loss", bounds.seconds["mask_loss"]
                    + roofline.mask_loss_bound_s(b, nq, h, w, int(n), size)))
            src = _Enter.apply(src)
            with torch.profiler.record_function(RANGE + "mask_loss"):
                out = fn(src, gt_masks, tgt_idx, matched)
            return tuple(_Exit.apply(*out)) if src.requires_grad else out

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, fn))

    def settle(self) -> Dict[str, float]:
        """Read the pending counts (after the traced window)."""
        while self._pending:
            self._pending.pop(0)()
        return dict(self.seconds)

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()


_OPEN: List = []


class _Exit(torch.autograd.Function):
    """Identity on B3's outputs; its backward opens the backward's range."""

    @staticmethod
    def forward(ctx, *outs):
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        rf = torch.profiler.record_function(RANGE + "mask_loss")
        rf.__enter__()
        _OPEN.append(rf)
        return grads


class _Enter(torch.autograd.Function):
    """Identity on B3's logits; its backward closes the backward's range."""

    @staticmethod
    def forward(ctx, src):
        return src.view_as(src)

    @staticmethod
    def backward(ctx, grad):
        if _OPEN:
            _OPEN.pop().__exit__(None, None, None)
        return grad
