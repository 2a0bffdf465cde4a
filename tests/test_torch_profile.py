"""`engine/profile.py` on a CPU profile: `host_waits` sums each chosen call
by the innermost program span around it, per batch; `device_by_stage` gives
each span the device time of the operations launched inside it and the idle
gaps whose midpoints it holds innermost. Both match by time, so a call on
another thread falls in the main thread's open span. (The CPU has no device
operations and none of the waiting CUDA runtime calls: CPU ops stand in for
the calls, and device operations linked to chosen CPU ops, at chosen times,
for the card's; a runtime call is a stand-in event of its own.)"""
import os
import threading
from types import SimpleNamespace

import pytest
import torch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.profile import SETUPS, SPAN, device_by_stage, host_waits
from nopesac_torch.losses.hungarian import pad_and_sanitize
from nopesac_torch.utils import trace
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "smoke_synthetic.yaml")


def test_host_waits_by_stage():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN + "outer"):
            for _ in range(2):
                with torch.profiler.record_function(SPAN + "inner"):
                    pad_and_sanitize(torch.randn(3, 4, 2))
            torch.randn(3).amax()
    got = host_waits(prof.events(), 2, names=("aten::amax",))
    # pad_and_sanitize takes one amax per call, in "inner"; the loose one is in "outer"
    assert got["calls_per_batch"] == pytest.approx(1.5)
    stages = {d["at"]: d["calls"] for d in got["by_stage"]}
    assert stages == pytest.approx({"inner": 1.0, "outer": 0.5})
    assert got["ms_per_batch"] == pytest.approx(sum(d["ms"] for d in got["by_call"]))


def _two_thread_profile():
    """outer > inner (aten::mul), then aten::sub on a second thread and
    aten::add on the main thread inside outer, aten::div after it; returns
    the events and the first event of each op and span by name."""
    a = torch.randn(64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts, experimental_config=every_thread) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.mul(a, a)
            worker = threading.Thread(target=lambda: torch.sub(a, a))
            worker.start()
            worker.join(timeout=30)
            torch.add(a, a)
        torch.div(a, 2.0)
    assert not worker.is_alive()
    events = list(prof.events())
    first = {}
    for e in events:
        first.setdefault(e.name, e)
    return events, first


def _device_op(start, end, launched_by, name="kernel", correlation=-1):
    """A device operation launched inside the op `launched_by` (its linked
    id), by the runtime call of id `correlation`."""
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name=name,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end),
                           id=correlation, linked_correlation_id=launched_by.id)


def _host_event(name, start, end, event_id):
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CPU, name=name,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end), id=event_id)


def test_device_by_stage_matches_launches_and_ops_each_in_their_own_ids():
    """A device operation's id is its runtime call's correlation id, and an
    op's id counts ops: the two sequences meet. A graph launch in one span
    takes all its kernels there, though an op in another span has its id."""
    events = [_host_event(SPAN + "backbone", 0, 100, 1), _host_event(SPAN + "select", 200, 300, 2),
              _host_event("cudaGraphLaunch", 10, 20, 314),
              _host_event("aten::empty", 210, 211, 314), _host_event("aten::to", 220, 221, 51),
              _host_event("cudaLaunchKernel", 230, 240, 246)]
    kernel = lambda s, e, i, li=0: SimpleNamespace(
        device_type=torch.autograd.DeviceType.CUDA, name="k", is_user_annotation=False,
        time_range=SimpleNamespace(start=s, end=e), id=i, linked_correlation_id=li)
    graph = [kernel(400 + 10 * k, 405 + 10 * k, 314) for k in range(45)]
    b1 = kernel(900, 980, 246)
    copy = kernel(1000, 1001, 51)  # launched by runtime call 51, elsewhere
    linked = kernel(1100, 1102, 7, li=51)  # launched inside the op aten::to
    got = device_by_stage(events + graph + [b1, copy, linked], n_batches=1)
    assert got["stage_device_ms_per_batch"] == pytest.approx(
        {"backbone": 45 * 5 / 1e3, "select": (80 + 2) / 1e3})


def test_device_by_stage_by_time_across_threads():
    events, first = _two_thread_profile()
    inner, outer = first[SPAN + "inner"].time_range, first[SPAN + "outer"].time_range
    mul, sub, add, div = (first[f"aten::{k}"] for k in ("mul", "sub", "add", "div"))
    assert sub.thread != mul.thread
    # four device operations, from the profile's first event on: idle gaps
    # inside inner, inside outer after inner, and after outer; the last
    # operation ends with the profile, so there is no gap after it
    lo = min(e.time_range.start for e in events)
    hi = max(max(e.time_range.end for e in events), outer.end + 11)
    d = [_device_op(lo, inner.start, mul),
         _device_op(inner.end - 1, inner.end, sub),
         _device_op(outer.end - 2, outer.end - 1, add),
         _device_op(outer.end + 10, hi, div)]
    got = device_by_stage(events + d, n_batches=1)
    ms = lambda us: us / 1e3
    first_op = inner.start - lo
    assert got["busy_ms_per_batch"] == pytest.approx(ms(first_op + 2 + hi - outer.end - 10))
    assert got["stage_device_ms_per_batch"] == pytest.approx(
        {"inner": ms(first_op), "outer": ms(first_op + 2)})
    assert got["idle_ms_per_batch"] == pytest.approx({
        "inner": ms(inner.end - 1 - inner.start),
        "outer": ms(outer.end - 2 - inner.end),
        "none": ms(11)})
    # the second thread's call falls in the main thread's open span, by time
    waits = host_waits(events, 1, names=("aten::sub",))
    assert {d["at"]: d["calls"] for d in waits["by_stage"]} == {"outer": 1}


@pytest.mark.parametrize("kind", ["eval", "entry", "train"])
def test_setups_feed_the_recorder(kind, tmp_path):
    """Each CLI mode's measured pass records its layer's spans once per batch
    (96x128 on the CPU): the eval step's, the entry point's `eval.*` stages,
    and the train step's with the host batch's copy and its counters."""
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TEST.IMS_PER_BATCH = 2
    cfg.freeze()
    n = 2
    _, step, batches = SETUPS[kind](cfg, n, device="cpu")
    step(batches[0])
    trace.reset()
    trace.enable()
    try:
        for batch in batches[1:]:
            step(batch)
    finally:
        trace.disable()
    snap = trace.snapshot()
    trace.reset()
    calls = {k: v["calls"] for k, v in trace.by_name(snap).items()}
    per_batch = {"eval": ("eval.step", "model.backbone", "model.refine"),
                 "entry": ("eval.mapper", "eval.step", "eval.drain", "eval.postprocess",
                           "eval.evaluator", "model.matching_gnn"),
                 "train": ("data.batch_to_device", "train.step", "train.backward",
                           "train.optimizer", "model.sinkhorn")}[kind]
    for name in per_batch:
        assert calls[name] == n, name
    if kind == "entry":
        assert calls["eval.test"] == calls["eval.evaluate"] == 1
        assert step.__self__.last_eval_stats["pairs"] == 2 * n
        # each view scored in process(): its mask IoU computed for its plane AP
        # record, read again for its pair's correspondences
        assert snap["counts"] == {"eval.iou_matrices": 4 * n, "eval.iou_reused": 4 * n,
                                  "eval.views_scored": 4 * n}
    if kind == "train":
        arrays = [a for b in batches[1:] for k, v in b.items() if k != "meta"
                  for a in (v.values() if isinstance(v, dict) else [v])]
        assert snap["counts"] == {"data.h2d_bytes": sum(a.nbytes for a in arrays),
                                  "data.h2d_copies": len(arrays)}
    elif kind == "eval":
        assert snap["counts"] == {}
