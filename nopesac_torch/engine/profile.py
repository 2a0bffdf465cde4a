"""Where the eval step's time goes on the card.

    python -m nopesac_torch.engine.profile [--config-file configs/inference_mp3d.yaml]
        [--batches 5] [--out FILE]

Builds the inference model with seeded random weights, runs a warm-up batch
of TEST.IMS_PER_BATCH synthetic uint8 pairs, then makes two timed passes of
`--batches` batches each:
  1. without the profiler: the wall time per batch and, per stage, the span
     between CUDA events recorded around the stage on the stream (the
     device-side span, which includes the gaps while the host is still
     launching the stage's kernels);
  2. under torch.profiler: the summed device time of all kernels and the
     kernels that take the most of it. The busy share is pass 2's kernel
     time over pass 1's wall time (the profiler slows the host down).
Needs a CUDA card. Prints one JSON object and, with `--out`, writes it there.
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
from .predict import build_model_from_cfg, make_eval_step, synthetic_pairs

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=os.path.join(REPO, "configs", "inference_mp3d.yaml"))
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA card")

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    h, w = cfg.INPUT.IMAGE_SIZE
    bs = cfg.TEST.IMS_PER_BATCH
    model = build_model_from_cfg(cfg, seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batches = [synthetic_pairs(bs, h, w, seed=s) for s in range(args.batches + 1)]
    step(*batches[0])  # warm-up
    torch.cuda.synchronize()

    timer = StageTimer()
    head = model.camera_head
    for obj, attr, name in ((model.backbone, "forward", "backbone"),
                            (model.sem_seg_head, "forward", "plane_head"),
                            (model, "select_planes", "select_planes"),
                            (head, "pixel_camera", "pixel_camera"),
                            (model.matching_head.gnn, "forward", "matching_gnn"),
                            (model.matching_head, "forward", "matching_head"),
                            (head, "refine", "refine"),
                            (model, "inference", "total")):
        timer.wrap(obj, attr, name)
    t0 = time.perf_counter()
    for pair in batches[1:]:
        step(*pair)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {k: v / args.batches for k, v in timer.ms().items()}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for pair in batches[1:]:
            step(*pair)
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
        "pairs_per_batch": bs, "image": [h, w],
        "sinkhorn_iters": cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS,
        "wall_ms_per_batch": wall_ms, "pairs_per_s": bs / wall_ms * 1e3,
        "kernel_ms_per_batch": busy_ms, "busy_share": busy_ms / wall_ms,
        "kernel_launches_per_batch": sum(k[2] for k in kernels),
        "stage_span_ms_per_batch": stages,
        "top_kernels": [{"name": n[:120], "ms_per_batch": ms, "calls_per_batch": c}
                        for n, ms, c in kernels[:15]],
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
