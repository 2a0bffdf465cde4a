"""One `torch.profiler` window over part of a run, read into a summary:
the device's busy time (the union of its operations' intervals), the
window's wall, the device time of the operations launched inside each
`cardbench:` range, the host's time in the runtime calls that wait for the
device, the device operations that took most time and the idle gaps by
the innermost range the host was in."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .spans import RANGE

# the CUDA runtime calls in which the host waits for the device (the port's
# `engine/profile.py:WAIT_CALLS`): a stream, event or device synchronisation,
# and a copy to or from pageable host memory
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync")
TOP = 10


def _is_device(evt) -> bool:
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith((RANGE, "ProfilerStep")))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(points: List[float], ranges: List[Tuple[float, float, str]]) -> List[str]:
    """For each point (ascending), the name of the latest-starting range
    that holds it, or "outside spans"."""
    ranges = sorted(ranges)
    names, active, k = [], [], 0
    for t in points:
        while k < len(ranges) and ranges[k][0] <= t:
            active.append(ranges[k])
            k += 1
        active = [r for r in active if r[1] >= t]
        names.append(active[-1][2] if active else "outside spans")
    return names


class TraceWindow:
    """`with TraceWindow() as tw: ...` profiles the block (CPU and CUDA
    activity); `tw.summary` is filled when it closes, after a synchronise."""

    def __init__(self):
        self.summary: Dict = {}
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t0 = time.perf_counter()
            self.summary = summarize(self._prof.events(), wall)
            self.summary["read_s"] = time.perf_counter() - t0
        return False


def summarize(events, wall_s: float) -> Dict:
    device, ranges, waits = [], [], defaultdict(float)
    cpu_ids: List[Tuple[float, int]] = []
    for evt in events:
        s, e = evt.time_range.start, evt.time_range.end
        if _is_device(evt):
            device.append((s, e, evt.id, getattr(evt, "linked_correlation_id", 0) or 0, evt.name))
        elif evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name.startswith(RANGE):
                ranges.append((s, e, evt.name[len(RANGE):]))
            else:
                cpu_ids.append((s, evt.id))
                if evt.name in WAIT_CALLS:
                    waits[evt.name] += (e - s) * 1e-6
    busy = _union([(s, e) for s, e, *_ in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # device time of the operations launched inside each range: a host event
    # (runtime call or op) that starts inside the range shares its id with
    # the device operation it launched
    cpu_ids.sort()
    starts = [t for t, _ in cpu_ids]
    range_ids: Dict[str, set] = defaultdict(set)
    import bisect
    for s, e, name in ranges:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
        range_ids[name].update(i for _, i in cpu_ids[lo:hi])
    range_device_s = {}
    for name, ids in range_ids.items():
        secs = [(e - s) * 1e-6 for s, e, i, li, _ in device if i in ids or (li and li in ids)]
        range_device_s[name] = {"seconds": sum(secs), "ops": len(secs)}
    ops = defaultdict(float)
    for s, e, *_, name in device:
        ops[name[:120]] += (e - s) * 1e-6
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    gap_names = _innermost([(a + b) / 2 for a, b in gaps], ranges)
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, gap_names):
        idle[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": wall_s, "busy_s": busy_s, "device_ops": len(device),
            "span_s": ((busy[-1][1] - busy[0][0]) * 1e-6) if busy else 0.0,
            "range_device": range_device_s, "waits_s": dict(waits),
            "top_device_ops": top(ops), "idle_gaps": top(idle)}
