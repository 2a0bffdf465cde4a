"""Spans and counters of the port's layers.

`span(name)` marks a layer boundary (`with span("eval.drain"): ...`):

  * off (the default): it returns one shared null context, after a check of
    this module's flag and of `torch.autograd.profiler._is_profiler_enabled`;
  * while `torch.profiler` runs: a `record_function("nopesac:" + name)` range,
    in the same timeline and on the same clock as the device's operations;
  * while the recorder is on (`enable()` .. `disable()`): the span's host
    duration (`time.perf_counter_ns`) and self time (the duration less what
    its child spans on the same thread cover), summed per (name, parent),
    the parent being the innermost span open on the same thread.

`count(name, n)` adds to a counter while the recorder is on. A count of
work inside a CUDA graph of the eval step goes through
`utils/graphs.py:on_replay`, so that it counts at each replay, as
`model.fused_tail_calls` does (one per kernel-B4 call of the backbone's
fused identity-block tails, `models/resnet.py`). `snapshot()`
returns what the recorder holds; `reset()` empties it. The aggregates are per
(name, parent), so the recorder's memory does not grow with the run.

Spans sit at layer boundaries only, never per iteration of a loop or per
block of a checkpointed (REMAT) stage, whose backward recomputes the block.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "nopesac:"  # the profiler ranges' prefix

_recording = False
_lock = threading.Lock()
_local = threading.local()  # .stack: the open recorded spans of this thread
_spans: Dict[Tuple[str, Optional[str]], List[int]] = defaultdict(lambda: [0, 0, 0])
_counts: Dict[str, int] = defaultdict(int)
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "recorded", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.recorded = False

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        if _recording:
            self.recorded = True
            self.child_ns = 0
            _stack().append(self)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.recorded:
            dur = time.perf_counter_ns() - self.t0
            stack = _stack()
            stack.pop()
            parent = stack[-1] if stack else None
            if parent is not None:
                parent.child_ns += dur
            with _lock:
                row = _spans[(self.name, parent.name if parent is not None else None)]
                row[0] += 1
                row[1] += dur
                row[2] += dur - self.child_ns
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _stack() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager around one layer's work (see the module's doc)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while the recorder is on."""
    if _recording:
        with _lock:
            _counts[name] += n


def enable() -> None:
    global _recording
    _recording = True


def disable() -> None:
    global _recording
    _recording = False


def reset() -> None:
    """Forget every recorded span and counter (spans open now still close
    into the emptied recorder)."""
    with _lock:
        _spans.clear()
        _counts.clear()


def snapshot() -> Dict:
    """{"spans": [{"name", "parent", "calls", "host_ms", "self_ms"}, ...]
    largest host time first, "counts": {name: n}}; both empty when nothing
    was recorded."""
    with _lock:
        rows = [{"name": name, "parent": parent, "calls": calls, "host_ms": host * 1e-6,
                 "self_ms": own * 1e-6}
                for (name, parent), (calls, host, own) in _spans.items()]
        counts = dict(_counts)
    rows.sort(key=lambda r: -r["host_ms"])
    return {"spans": rows, "counts": counts}


def by_name(snap: Dict) -> Dict[str, Dict[str, float]]:
    """A snapshot's spans summed over their parents: {name: {"calls",
    "host_ms", "self_ms"}}."""
    out: Dict[str, Dict[str, float]] = {}
    for r in snap["spans"]:
        acc = out.setdefault(r["name"], {"calls": 0, "host_ms": 0.0, "self_ms": 0.0})
        for k in acc:
            acc[k] += r[k]
    return out
