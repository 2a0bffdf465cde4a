"""Where the eval step's, the evaluation entry point's or the train step's
time goes on the card, by the program's own spans (`utils/trace.py`).

    python -m nopesac_torch.engine.profile [--config-file configs/inference_mp3d.yaml]
        [--batches 5] [--fuse-tail] [--out FILE]
    python -m nopesac_torch.engine.profile --entry [--config-file configs/inference_mp3d.yaml]
        [--batches 32] [--fuse-tail] [--out FILE] [KEY VALUE ...]
    python -m nopesac_torch.engine.profile --train [--config-file configs/train_mp3d_step3.yaml]
        [--batches 3] [--memory] [--out FILE] [KEY VALUE ...]

The eval step: builds the inference model with seeded random weights, runs
a warm-up batch of TEST.IMS_PER_BATCH synthetic uint8 pairs, each batch
inside the span `eval.step`. `--fuse-tail` sets MODEL.RESNETS.FUSE_TAIL (in
the eval step and the entry point): the backbone runs its identity-block
tails through kernel B4. The entry point (`--entry`): `EvalRunner.test`
as `--eval-only` runs it (mapper, eval step, one-deep pipeline, fetch,
postprocess, evaluator, `evaluate()`, each in its `eval.*` span) on a
warm-up split of 2 batches, then on one split of `--batches` batches, of
seeded synthetic pairs of 12 planes per view. The train step (`--train`, f32
and MODEL.REMAT off unless the KEY VALUE overrides say otherwise): builds the
train model and TrainStep; each step copies a host batch of
SOLVER.IMS_PER_BATCH synthetic pairs of 12 planes per view to the card
through `batch_to_device`, as `Trainer.train` does, then steps; one warm-up
step. Then three passes of `--batches` batches each:
  0. with tracing off: the wall per batch (`untraced_wall_ms_per_batch`);
  1. with the span recorder on and no profiler: the wall per batch and each
     span's host time per batch, in all and less its child spans'
     (`stage_host_ms_per_batch`, `stage_self_ms_per_batch`), and the
     counters per batch (`counts_per_batch`: the batch copy's bytes and
     copies; the eval step's segments replayed as CUDA graphs, captured,
     and run eagerly, `eval.graph_*`: in a warm split the replays alone;
     the views the evaluator's `process()` scored and the mask IoU matrices
     it made and read again, `eval.views_scored`, `eval.iou_*`; with the
     fused tail, B4's calls, `model.fused_tail_calls`, 24 per batch);
  2. under torch.profiler, where each span is a `nopesac:` range: the
     device time of the operations launched inside each range (a host call
     that starts inside it shares its id with the device operation it
     launched), the device's idle time by the innermost range at each idle
     gap's midpoint ("none" outside every range), the busy share (the union
     of the device's operations over this pass's own wall), the operations
     that take the most device time, and the host's time in the runtime
     calls that wait for the device (`WAIT_CALLS`), by call and by the
     innermost range at their start (`host_waits`). Ranges and calls are
     matched by time, so the autograd thread's launches and waits fall in
     the main thread's `train.backward`.
With `--entry`, `eval_stats` is the profiled split's `last_eval_stats` (its
rate, valid planes per view, matches per pair).
With `--memory`, one more step runs under the caching allocator's history:
the blocks live at its peak, summed by the innermost line of this package
outside `models/layers.py` that allocated them (`memory_at_peak`).
Needs a CUDA card. Prints one JSON object and, with `--out`, writes it
there.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from ..config.config import get_cfg
from ..data.packing import batch_to_device
from ..data.synthetic import make_dataset
from ..utils import trace
from ..utils.device import resolve_device
from .predict import build_model_from_cfg, make_eval_step, synthetic_pairs
from .test import EvalRunner
from .train import TrainStep, build_train_model, synthetic_host_batches

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


SPAN = trace.PREFIX  # the profiler ranges of the program's spans
# the CUDA runtime calls in which the host waits for the device: a stream,
# event or device synchronisation, and a copy to or from pageable host memory
# (which waits for the stream's earlier work)
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync")
OUTSIDE = "none"


def _eval_setup(cfg, n_batches, device=None):
    h, w = cfg.INPUT.IMAGE_SIZE
    bs = cfg.TEST.IMS_PER_BATCH
    model = build_model_from_cfg(cfg, device=device, seed=0)
    eval_step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batches = [synthetic_pairs(bs, h, w, seed=s, device=device) for s in range(n_batches + 1)]

    def step(batch):
        with trace.span("eval.step"):
            return eval_step(*batch)

    return bs, step, batches


def _entry_setup(cfg, n_batches, device=None):
    h, w = cfg.INPUT.IMAGE_SIZE
    bs = int(cfg.TEST.IMS_PER_BATCH)
    runner = EvalRunner(cfg, build_model_from_cfg(cfg, device=device, seed=0))
    splits = [make_dataset(n * bs, n_planes=12, seed=s, h=h, w=w)
              for s, n in enumerate((2, n_batches))]
    return bs, runner.test, splits


def _train_setup(cfg, n_batches, device=None):
    dev = resolve_device(device)
    train_step = TrainStep(build_train_model(cfg, device=dev, seed=0), cfg, seed=0)

    def step(batch):
        return train_step(batch_to_device(batch, dev))

    batches = list(synthetic_host_batches(cfg, n_batches + 1, seed=1, n_planes=12))
    return cfg.SOLVER.IMS_PER_BATCH, step, batches


SETUPS = {"eval": _eval_setup, "entry": _entry_setup, "train": _train_setup}


def _pass(step, work) -> float:
    """Seconds to run `step` over `work` and the work it queued on the card."""
    t0 = time.perf_counter()
    for batch in work:
        step(batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _site(frames):
    """The innermost frame of this package in an allocation's Python stack,
    the shared layers of `models/layers.py` and this file aside (so that a
    convolution is charged to the model code that called it), as "path:line
    function"."""
    if frames and "runpy" in frames[0]["filename"]:
        frames = frames[::-1]  # innermost first
    for f in frames:
        path = f["filename"].replace(os.sep, "/")
        if "/nopesac_torch/" in path and not path.endswith(("engine/profile.py",
                                                            "models/layers.py")):
            return f"{path.split('/nopesac_torch/')[-1]}:{f['line']} {f['name']}"
    return "outside nopesac_torch"


def _is_device(evt) -> bool:
    """A device operation (kernel, copy, set), not a range's annotation on
    the device's timeline."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith(SPAN))


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
    that holds it, or OUTSIDE."""
    ranges = sorted(ranges)
    names, active, k = [], [], 0
    for t in points:
        while k < len(ranges) and ranges[k][0] <= t:
            active.append(ranges[k])
            k += 1
        active = [r for r in active if r[1] >= t]
        names.append(active[-1][2] if active else OUTSIDE)
    return names


def _ranges(events) -> List[Tuple[float, float, str]]:
    """The program's spans in a profile: (start, end, name) in us."""
    return [(e.time_range.start, e.time_range.end, e.name[len(SPAN):]) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(SPAN)]


def host_waits(events, n_batches: int, names=WAIT_CALLS, top: int = 15) -> dict:
    """The host's time in the calls `names` of a profile's events, ms per
    batch: in all, by call and by the innermost program span at each call's
    start, on any thread (OUTSIDE where none is open)."""
    calls = sorted((e.time_range.start, e.name, e.cpu_time_total) for e in events
                   if e.name in names and e.device_type == torch.autograd.DeviceType.CPU)
    stages = _innermost([t for t, _, _ in calls], _ranges(events))
    sums = {k: defaultdict(lambda: [0.0, 0]) for k in ("by_call", "by_stage")}
    for (_, name, us), stage in zip(calls, stages):
        for key, k in (("by_call", name), ("by_stage", stage)):
            sums[key][k][0] += us / 1e3 / n_batches
            sums[key][k][1] += 1 / n_batches
    out = {"ms_per_batch": sum(v[0] for v in sums["by_call"].values()),
           "calls_per_batch": sum(v[1] for v in sums["by_call"].values())}
    for key, d in sums.items():
        rows = sorted(d.items(), key=lambda kv: -kv[1][0])[:top]
        out[key] = [{"at": k, "ms": v[0], "calls": v[1]} for k, v in rows]
    return out


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cudaGraphLaunch,
    cuLaunchKernel, ...), whose id is the correlation id of what it launched."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def device_by_stage(events, n_batches: int, top: int = 15) -> Dict:
    """A profile's device side, ms per batch: busy (the union of the
    device's operations), each span's device time (the operations launched
    inside it, its child spans' included) and the idle gaps by the innermost
    span at their midpoints (the gaps add up to the profile's span less
    busy), and the operations that take the most time.

    A device operation's id is the correlation id of the runtime call that
    launched it, and its linked id that of the op around the call. An op's
    own id counts ops, another sequence: so an operation is matched by id to
    the runtime calls alone, and by linked id to the ops. (Matched to both,
    an op's id equal to a graph launch's would take in every kernel of the
    graph.)"""
    device, calls, host_ops = [], [], []
    for e in events:
        if _is_device(e):
            device.append((e.time_range.start, e.time_range.end, e.id,
                           getattr(e, "linked_correlation_id", 0) or 0, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU and not e.name.startswith(SPAN):
            (calls if _is_runtime(e.name) else host_ops).append((e.time_range.start, e.id))
    ranges = _ranges(events)

    def inside(host):
        host.sort()
        starts = [t for t, _ in host]
        got: Dict[str, set] = defaultdict(set)
        for s, e, name in ranges:
            got[name].update(i for _, i in host[bisect.bisect_left(starts, s):
                                                bisect.bisect_right(starts, e)])
        return got

    call_ids, op_ids = inside(calls), inside(host_ops)
    per = lambda us: us / 1e3 / n_batches
    stage = {name: per(sum(e - s for s, e, i, li, _ in device
                           if i in call_ids[name] or (li and li in op_ids[name])))
             for name in set(call_ids) | set(op_ids)}
    busy = _union([(s, e) for s, e, *_ in device])
    # the idle gaps between the device's operations, and before the first and
    # after the last within the profile's first and last events
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost([(a + b) / 2 for a, b in gaps], ranges)):
        idle[name] += per(b - a)
    ops = defaultdict(lambda: [0.0, 0])
    for s, e, *_, name in device:
        ops[name[:120]][0] += per(e - s)
        ops[name[:120]][1] += 1 / n_batches
    desc = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {"busy_ms_per_batch": per(sum(e - s for s, e in busy)),
            "ops_per_batch": len(device) / n_batches,
            "stage_device_ms_per_batch": desc(stage), "idle_ms_per_batch": desc(idle),
            "top_ops": [{"name": k, "ms_per_batch": v[0], "calls_per_batch": v[1]}
                        for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]]}


def memory_at_peak(step, batch, top: int = 20) -> dict:
    """One step under the allocator's history: the bytes live before it
    (parameters, optimizer state, batches), the step's peak, and the blocks
    live at the peak summed by allocation site and by file."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python")
    try:
        step(batch)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][torch.cuda.current_device()]
    live, total, peak, at = {}, 0, 0, -1
    for i, e in enumerate(events):  # first pass: where the peak is
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
            if total > peak:
                peak, at = total, i
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            total -= live.pop(e["addr"])
    live = {}
    for e in events[:at + 1]:  # second pass: what is live there
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _site(e.get("frames", [])))
        elif e["action"] in ("free_requested", "free_completed"):
            live.pop(e["addr"], None)
    sites, files = defaultdict(lambda: [0, 0]), defaultdict(int)
    for size, site in live.values():
        sites[site][0] += size
        sites[site][1] += 1
        files[site.split(":")[0]] += size
    gib = lambda n: n / 2**30
    return {"before_step_gib": gib(base), "step_peak_gib": gib(base + peak),
            "max_memory_allocated_gib": gib(torch.cuda.max_memory_allocated()),
            "peak_reached_at": _site(events[at].get("frames", [])) if at >= 0 else None,
            "live_at_peak_gib": gib(sum(v[0] for v in live.values())),
            "by_file_gib": {k: gib(v) for k, v in sorted(files.items(), key=lambda kv: -kv[1])},
            "by_site": [{"site": k, "gib": gib(v[0]), "blocks": v[1]}
                        for k, v in sorted(sites.items(), key=lambda kv: -kv[1][0])[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=None,
                    help="default: configs/inference_mp3d.yaml, or train_mp3d_step3.yaml")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="profile the train step")
    mode.add_argument("--entry", action="store_true",
                      help="profile EvalRunner.test on one split of --batches batches")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--fuse-tail", action="store_true",
                    help="MODEL.RESNETS.FUSE_TAIL True: the backbone's tails through kernel B4")
    ap.add_argument("--memory", action="store_true",
                    help="one more step under the allocator's history: live memory at its peak")
    ap.add_argument("--out", default=None)
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA card")

    cfg = get_cfg()
    default = "train_mp3d_step3.yaml" if args.train else "inference_mp3d.yaml"
    cfg.merge_from_file(args.config_file or os.path.join(REPO, "configs", default))
    if args.train:  # f32 without REMAT, the settings of the earlier train profiles
        cfg.merge_from_list(["MODEL.COMPUTE_DTYPE", "float32",
                             "MODEL.BACKBONE_TRAIN_DTYPE", "float32", "MODEL.REMAT", "False"])
    if args.fuse_tail:
        cfg.merge_from_list(["MODEL.RESNETS.FUSE_TAIL", "True"])
    if args.opts:
        cfg.merge_from_list(args.opts)
    h, w = cfg.INPUT.IMAGE_SIZE
    kind = "train" if args.train else "entry" if args.entry else "eval"
    bs, step, batches = SETUPS[kind](cfg, args.batches)
    step(batches[0])  # warm-up
    untraced = _pass(step, batches[1:])

    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    trace.enable()
    try:
        wall = _pass(step, batches[1:])
    finally:
        trace.disable()
    snap = trace.snapshot()
    stages = trace.by_name(snap)
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = _pass(step, batches[1:])
    events = prof.events()
    dev = device_by_stage(events, args.batches)
    wall_ms = wall / args.batches * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    result = {
        "device": torch.cuda.get_device_name(0), "card": smi.stdout.strip().splitlines()[0],
        "step": kind, "fuse_tail": bool(cfg.MODEL.RESNETS.FUSE_TAIL),
        "pairs_per_batch": bs, "image": [h, w],
        "sinkhorn_iters": cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS,
        "peak_memory_gib": peak / 2**30,
        "untraced_wall_ms_per_batch": untraced / args.batches * 1e3,
        "wall_ms_per_batch": wall_ms, "pairs_per_s": bs / wall_ms * 1e3,
        "stage_host_ms_per_batch": {k: v["host_ms"] / args.batches for k, v in stages.items()},
        "stage_self_ms_per_batch": {k: v["self_ms"] / args.batches for k, v in stages.items()},
        "counts_per_batch": {k: v / args.batches for k, v in snap["counts"].items()},
        "profiled_wall_ms_per_batch": prof_wall / args.batches * 1e3,
        "busy_share": dev["busy_ms_per_batch"] / (prof_wall / args.batches * 1e3),
        **dev,
        "host_waits": host_waits(events, args.batches),
    }
    if kind == "entry":  # the profiled split's rate, planes per view and matches per pair
        result["eval_stats"] = step.__self__.last_eval_stats
    if args.memory:
        result["memory_at_peak"] = memory_at_peak(step, batches[1])
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
