"""What a rank's traced steps say of the collectives: the device time of
its NCCL kernels (named `nccl...` by the library), the part of it in which
no other kernel of the rank runs (what overlapping the exchange with the
backward would hide), and the device time of the operations launched inside
each of the program's own spans (`nopesac:` ranges of
`nopesac_torch/utils/trace.py`), NCCL's apart.

`CollectiveTraceWindow` is `tracing.TraceWindow` with this reading added to
its summary under "collectives"."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .tracing import TraceWindow, _is_device, _union

PROGRAM_RANGE = "nopesac:"


def is_nccl(name: str) -> bool:
    return name.lower().startswith("nccl")


def _minus(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the union `a` outside the union `b` (both sorted and
    disjoint)."""
    out, k = 0.0, 0
    for s, e in a:
        while k < len(b) and b[k][1] <= s:
            k += 1
        t, j = s, k
        while j < len(b) and b[j][0] < e:
            if b[j][0] > t:
                out += b[j][0] - t
            t = max(t, b[j][1])
            j += 1
        if t < e:
            out += e - t
    return out


def summarize(events) -> Dict:
    """{"nccl_s", "exposed_s", "kernels", "spans": {name: {"device_s",
    "nccl_s", "ops"}}}, seconds over the traced window."""
    device, ranges, cpu_ids = [], [], []
    for evt in events:
        s, e = evt.time_range.start, evt.time_range.end
        if _is_device(evt):
            device.append((s, e, evt.id, getattr(evt, "linked_correlation_id", 0) or 0,
                           is_nccl(evt.name)))
        elif evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name.startswith(PROGRAM_RANGE):
                ranges.append((s, e, evt.name[len(PROGRAM_RANGE):]))
            else:
                cpu_ids.append((s, evt.id))
    nccl = _union([(s, e) for s, e, _, _, n in device if n])
    other = _union([(s, e) for s, e, _, _, n in device if not n])
    # a host event that starts inside a span shares its id with the device
    # operation it launched (as `tracing.summarize` attributes its ranges)
    cpu_ids.sort()
    starts = [t for t, _ in cpu_ids]
    ids: Dict[str, set] = defaultdict(set)
    for s, e, name in ranges:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
        ids[name].update(i for _, i in cpu_ids[lo:hi])
    spans = {}
    for name, own in ids.items():
        ops = [(e - s, n) for s, e, i, li, n in device if i in own or (li and li in own)]
        spans[name] = {"device_s": sum(d for d, _ in ops) * 1e-6,
                       "nccl_s": sum(d for d, n in ops if n) * 1e-6, "ops": len(ops)}
    return {"nccl_s": sum(e - s for s, e, _, _, n in device if n) * 1e-6,
            "exposed_s": _minus(nccl, other) * 1e-6,
            "kernels": sum(1 for *_, n in device if n), "spans": spans}


class CollectiveTraceWindow(TraceWindow):
    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is None:
            self.summary["collectives"] = summarize(self._prof.events())
        return False
