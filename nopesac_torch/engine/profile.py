"""Where the eval step's or the train step's time goes on the card.

    python -m nopesac_torch.engine.profile [--config-file configs/inference_mp3d.yaml]
        [--batches 5] [--fuse-tail] [--out FILE]
    python -m nopesac_torch.engine.profile --train [--config-file configs/train_mp3d_step3.yaml]
        [--batches 3] [--memory] [--out FILE] [KEY VALUE ...]

The eval step: builds the inference model with seeded random weights (with
`--fuse-tail`, its backbone runs the identity-block tails through kernel B4),
runs a warm-up batch of TEST.IMS_PER_BATCH synthetic uint8 pairs. The train step
(`--train`, f32 and MODEL.REMAT off unless the KEY VALUE overrides say
otherwise): builds the train model and TrainStep, runs a warm-up step
on SOLVER.IMS_PER_BATCH synthetic pairs of 12 planes per view. Then two
timed passes of `--batches` batches each:
  1. without the profiler: the wall time per batch and, per stage, the span
     between CUDA events recorded around the stage on the stream (the
     device-side span, which includes the gaps while the host is still
     launching the stage's kernels);
  2. under torch.profiler: the summed device time of all kernels and the
     kernels that take the most of it. The busy share is pass 2's kernel
     time over pass 1's wall time (the profiler slows the host down).
In the train step the spans are the forward (with the host LSA matcher and
the criterion inside it) and the optimizer update; the backward is the
step's span less those two. With `--memory`, one more step runs under the
caching allocator's history: the blocks live at its peak, summed by the
innermost line of this package outside `models/layers.py` that allocated
them (`memory_at_peak`).
Needs a CUDA card. Prints one JSON object and, with `--out`, writes it
there.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

from ..config.config import get_cfg
from ..models import nopesac as nopesac_module
from .predict import build_model_from_cfg, make_eval_step, synthetic_pairs
from .train import TrainStep, build_train_model, synthetic_batches

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class StageTimer:
    """Wraps bound methods so that each call records a CUDA event pair."""

    def __init__(self):
        self.events = defaultdict(list)

    def wrap(self, obj, attr: str, name: str):
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out

        setattr(obj, attr, timed)

    def ms(self):
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}


def _eval_setup(cfg, n_batches, fuse_tail=False):
    h, w = cfg.INPUT.IMAGE_SIZE
    bs = cfg.TEST.IMS_PER_BATCH
    model = build_model_from_cfg(cfg, seed=0, fuse_tail=fuse_tail)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batches = [synthetic_pairs(bs, h, w, seed=s) for s in range(n_batches + 1)]
    head = model.camera_head
    spans = ((model.backbone, "forward", "backbone"),
             (model.sem_seg_head, "forward", "plane_head"),
             (model, "select_planes", "select_planes"),
             (head, "pixel_camera", "pixel_camera"),
             (model.matching_head.gnn, "forward", "matching_gnn"),
             (model.matching_head, "forward", "matching_head"),
             (head, "refine", "refine"),
             (model, "inference", "total"))
    return bs, lambda b: step(*b), batches, spans


def _train_setup(cfg, n_batches):
    model = build_train_model(cfg, seed=0)
    step = TrainStep(model, cfg, seed=0)
    batches = list(synthetic_batches(cfg, n_batches + 1, seed=1, n_planes=12))
    head = model.camera_head
    spans = ((model.backbone, "forward", "backbone"),
             (model.sem_seg_head, "forward", "plane_head"),
             (nopesac_module, "match_planes_multi", "matcher"),
             (nopesac_module, "detection_losses_siamese", "criterion"),
             (model.matching_head, "forward", "matching_head"),
             (head, "pixel_camera", "pixel_camera"),
             (head, "refine", "refine"),
             (model, "train_forward", "forward"),
             (step, "apply_gradients", "optimizer"))
    return cfg.SOLVER.IMS_PER_BATCH, step, batches, spans


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
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--fuse-tail", action="store_true", help="eval step with kernel B4")
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
    if args.opts:
        cfg.merge_from_list(args.opts)
    h, w = cfg.INPUT.IMAGE_SIZE
    if args.train:
        bs, step, batches, spans = _train_setup(cfg, args.batches)
    else:
        bs, step, batches, spans = _eval_setup(cfg, args.batches, args.fuse_tail)
    step(batches[0])  # warm-up
    torch.cuda.synchronize()

    timer = StageTimer()
    for obj, attr, name in spans:
        timer.wrap(obj, attr, name)
    torch.cuda.reset_peak_memory_stats()
    totals = []
    t0 = time.perf_counter()
    for batch in batches[1:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch)
        end.record()
        totals.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {k: v / args.batches for k, v in timer.ms().items()}
    if args.train:
        stages["step"] = sum(s.elapsed_time(e) for s, e in totals) / args.batches
        stages["backward"] = stages["step"] - stages["forward"] - stages["optimizer"]
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for batch in batches[1:]:
            step(batch)
        torch.cuda.synchronize()
    kernels = []  # device-side events only (kernels, memcpy, memset)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.key, evt.self_device_time_total / 1e3 / args.batches,
                            evt.count / args.batches))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    wall_ms = wall / args.batches * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    result = {
        "device": torch.cuda.get_device_name(0), "card": smi.stdout.strip().splitlines()[0],
        "step": "train" if args.train else "eval", "fuse_tail": args.fuse_tail,
        "pairs_per_batch": bs, "image": [h, w],
        "sinkhorn_iters": cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS,
        "peak_memory_gib": peak / 2**30,
        "wall_ms_per_batch": wall_ms, "pairs_per_s": bs / wall_ms * 1e3,
        "kernel_ms_per_batch": busy_ms, "busy_share": busy_ms / wall_ms,
        "kernel_launches_per_batch": sum(k[2] for k in kernels),
        "stage_span_ms_per_batch": stages,
        "top_kernels": [{"name": n[:120], "ms_per_batch": ms, "calls_per_batch": c}
                        for n, ms, c in kernels[:15]],
    }
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
