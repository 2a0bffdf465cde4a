"""Kernel B4 in the evaluation cells that run the backbone's identity-block
tails fused (MODEL.RESNETS.FUSE_TAIL): its calls where the device ran them,
the least time they need, the device time they took inside the CUDA graphs,
and the reference and control with the same plain fused tail.

* `TailWatch` wraps the program's call site,
  `nopesac_torch.models.resnet.conv1x1_bn_act` (one call per 1x1 conv of an
  identity block: kernel B4 on a card, its plain version on the CPU). Inside
  the backbone's CUDA graph the wrapper's Python runs only at a signature's
  eager call and at its capture, so each call it sees hands the program's
  `utils/graphs.py:on_replay` a callback that counts the call where the
  device runs it: at each replay of the graph, or at once outside a
  capture. With `marks` (traced runs) the wrapper also brackets each call
  it sees captured by two marker kernels (`torch.cuda._sleep`) captured into
  the same graph. In a profile, the device operations between the two
  markers of one graph launch are then that call's, whatever kernels
  implement it: the device time is read against the work the wrapper saw,
  not against a kernel's name.
* `tail_bound_s`: the least time of one call, from its shapes
  (`harness/roofline.py`'s rule).
* `marked_device_s`: a profile's device time between the marker pairs.
* `fuse`, `fp8_tails`, `control_readings`: the reference with its plain
  fused tail (the program's arithmetic: an f32 product of the bf16 values,
  rounded once), and the control, whose every bf16 product, the tails'
  included, takes operands rounded to fp8.
"""
from __future__ import annotations

import contextlib
import functools
import math
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from . import control, evalcheck, roofline, scenes, tracing
from ..reference.models.resnet import STAGE_BLOCKS

# B4 calls per batch: conv1 and conv3 of each identity block (all but the
# first block of each stage), one backbone call for both views
CALLS_PER_BATCH = 2 * sum(n - 1 for n in STAGE_BLOCKS)
MARK_CYCLES = 1000  # the marker kernel's spin, about half a microsecond


def tail_cost(x_shape: Tuple[int, ...], cout: int, residual: bool, elem: int) -> Tuple[int, int]:
    """Bytes (x, W, scale, shift and the residual read once, y written once)
    and operations (the product and the epilogue: scale, shift, add, max)
    of relu((W . x) * scale + shift [+ residual]) on x [B, Cin, *spatial]."""
    b, cin = x_shape[0], x_shape[1]
    p = math.prod(x_shape[2:])
    n_bytes = elem * (b * cin * p + cout * cin + b * cout * p * (2 if residual else 1)) + 8 * cout
    n_ops = b * p * cout * (2 * cin + 3 + (1 if residual else 0))
    return n_bytes, n_ops


def tail_bound_s(x_shape: Tuple[int, ...], cout: int, residual: bool, elem: int) -> float:
    """The least time of one call: bf16 at the tensor cores' dense rate,
    f32 at the rate outside them."""
    rate = roofline.PEAK_FLOP_PER_S["bf16" if elem == 2 else "f32"]
    return roofline.bound_s(*tail_cost(x_shape, cout, residual, elem), rate)


def marker_name() -> str:
    """The name a profile gives the marker kernel, from one launch."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if tracing._is_device(e)}
    if len(names) != 1:
        raise RuntimeError(f"one marker launch gave the device operations {sorted(names)}")
    return names.pop()


class TailWatch:
    """The calls of the fused tail (see the module's doc). `counting` counts
    them (`calls`, of which `eager` ran outside a graph); `tracing` adds up
    the least time of those replayed from a graph (`traced_calls`,
    `traced_bound_s`); `captured` counts the calls captured into graphs."""

    def __init__(self, marks: bool = False):
        self.marks = marks
        self.marker = None
        self.counting = False
        self.tracing = False
        self.calls = self.eager = self.captured = self.traced_calls = 0
        self.traced_bound_s = 0.0
        self._undo: List = []

    def _ran(self, bound_s: float, replayed: bool) -> None:
        if self.counting:
            self.calls += 1
            self.eager += not replayed
        if self.tracing and replayed:
            self.traced_calls += 1
            self.traced_bound_s += bound_s

    def install(self, module, attr: str = "conv1x1_bn_act") -> None:
        from nopesac_torch.utils import graphs

        if self.marks:
            self.marker = marker_name()
        fn = getattr(module, attr)
        watch = self

        def wrapped(x, w, scale, shift, residual=None, relu=True):
            capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
            watch.captured += capturing
            bound = tail_bound_s(tuple(x.shape), w.shape[0], residual is not None,
                                 x.element_size())
            graphs.on_replay(functools.partial(watch._ran, bound, capturing))
            mark = capturing and watch.marks
            if mark:
                torch.cuda._sleep(MARK_CYCLES)
            out = fn(x, w, scale, shift, residual, relu)
            if mark:
                torch.cuda._sleep(MARK_CYCLES)
            return out

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, fn))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()

    def trace_window(self):
        """`tracing.TraceWindow` that adds up the replayed calls' bounds
        while it is open and puts their marked device time in its summary
        ("tail")."""
        watch = self

        class TailTraceWindow(tracing.TraceWindow):
            def __enter__(self):
                out = super().__enter__()
                watch.tracing = True
                return out

            def __exit__(self, *exc):
                watch.tracing = False
                super().__exit__(*exc)
                if exc[0] is None and watch.marker is not None:
                    self.summary["tail"] = marked_device_s(self._prof.events(), watch.marker)
                return False

        return TailTraceWindow


def marked_device_s(events, marker: str) -> Dict[str, float]:
    """The device time of the operations between the two markers of each
    bracketed call, within one launch (a device operation's id is the
    correlation id of the runtime call that launched it: a graph launch's
    for each of the graph's operations). A launch with an odd number of
    markers (a record lost) is left out whole and counted in "broken"."""
    launches = defaultdict(list)
    for e in events:
        if tracing._is_device(e):
            launches[e.id].append((e.time_range.start, e.time_range.end, e.name))
    seconds, calls, broken = 0.0, 0, 0
    for ops in launches.values():
        ops.sort()
        marks = [k for k, op in enumerate(ops) if op[2] == marker]
        if len(marks) % 2:
            broken += 1
            continue
        for a, b in zip(marks[0::2], marks[1::2]):
            seconds += sum(e - s for s, e, _ in ops[a + 1:b]) * 1e-6
            calls += 1
    return {"seconds": seconds, "calls": calls, "broken": broken}


def fuse(model):
    """The reference `model` with each identity block's tail on its plain
    fused path (`reference/models/resnet.py`; it adds no parameters)."""
    from ..reference.models.resnet import Bottleneck

    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.fuse_tail = True
    return model


@contextlib.contextmanager
def fp8_tails():
    """`control.fp8_products`, and the fused tails' operands (x, and the
    weight in x's dtype) rounded to fp8 as well."""
    from ..reference.models import resnet

    tail = resnet.conv1x1_bn_act

    def rounded(x, w, scale, shift, residual=None, relu=True):
        return tail(control.fp8_round(x), control.fp8_round(w.to(x.dtype)), scale, shift,
                    residual, relu)

    with control.fp8_products():
        resnet.conv1x1_bn_act = rounded
        try:
            yield
        finally:
            resnet.conv1x1_bn_act = tail


def control_readings(ctx, n_batches: int, batch: int) -> Dict[str, float]:
    """The fp8 reference against the stated one (both fused) on `n_batches`
    batches of `batch` pairs of the run's pool, as `control.eval_readings`
    reads TF32: the inference dicts, and the records of the program's
    postprocess and evaluator run on the control's outputs ("evaluator."
    numbers)."""
    from nopesac_torch.evaluation.evaluator import MP3DEvaluator
    from nopesac_torch.evaluation.postprocess import postprocess_batch

    tr = ctx.traffic
    h, w = ctx.tree["INPUT"]["IMAGE_SIZE"]
    pool = scenes.pool(ctx.rng(1), tr["pool_pairs"], tr["planes"], h, w)
    pairs = scenes.split(ctx.rng(2), pool, n_batches * batch, 0)
    batches = [pairs[k * batch:(k + 1) * batch] for k in range(n_batches)]
    ref = fuse(ctx.reference_model(train=False))
    want = evalcheck.reference_outputs(ctx, ref, batches)
    with fp8_tails():
        got = evalcheck.reference_outputs(ctx, ref, batches)
    out = evalcheck.worst([evalcheck.gaps(g, r) for g, r in zip(got, want)])
    cfg = ctx.program_cfg()
    rows = []
    for pairs_k, g, r in zip(batches, got, want):
        evaluator = MP3DEvaluator(cfg.DATASETS.TEST[0], cfg, dataset_list=pairs_k)
        metas = [{f"{key}{v}": p[v][key] for v in "01" for key in ("image_id", "file_name")}
                 for p in pairs_k]
        evaluator.process(pairs_k, postprocess_batch(g, metas, height=h, width=w))
        rows.append(evalcheck.record_gaps(evaluator._predictions, r))
    out.update({"evaluator." + k: v for k, v in evalcheck.worst(rows).items()})
    return out
