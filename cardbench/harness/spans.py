"""Spans recorded from the benchmark's own side, around the calls into the
program's layers (a copy of the port's `engine/profile.py:StageTimer`): a
pair of CUDA events on the stream, the host's time inside the call, and a
profiler range `cardbench:<name>` that the trace reader finds. Events and
host times are kept only while `collect` is set; the range is always
opened, so that a traced window can attribute device work to the layer."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

RANGE = "cardbench:"


class Spans:
    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.collect = False
        self.events: Dict[str, List[Tuple]] = defaultdict(list)
        self.host_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, obj, attr: str, name: str, device: bool = True) -> None:
        """Replace obj.attr by a timed call of it (undone by `unwrap`)."""
        fn = getattr(obj, attr)
        spans = self

        def timed(*args, **kwargs):
            events = spans.collect and device and spans.cuda
            if events:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            with torch.profiler.record_function(RANGE + name):
                out = fn(*args, **kwargs)
            if spans.collect:
                spans.host_s[name] += time.perf_counter() - t0
                spans.calls[name] += 1
            if events:
                end.record()
                spans.events[name].append((start, end))
            return out

        setattr(obj, attr, timed)
        self._undo.append(lambda: setattr(obj, attr, fn))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()

    def device_ms(self) -> Dict[str, float]:
        """Summed CUDA-event spans per name (call after a synchronise)."""
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}
