#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`nopesac_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. device: name, capability (>= 9.0) and nvidia-smi's name and power limit;
  2. build: every `nopesac_torch/ops/csrc/*.cu` with nvcc, in parallel;
  3. B1 (select_maps) at the main-path shapes, kernel against its plain
     PyTorch version: seg, max and the counts bit-equal, sums to rtol 1e-5,
     two runs bit-equal, the vec variant; its registers, shared memory,
     spills and blocks per SM; one device kernel per call (torch.profiler);
  4. B2 (sinkhorn) at [4, 50, 50], 200 iterations, masked, from the scores
     to the log coupling: kernel against its plain version, atol 1e-4 where
     |ref| < 1e4, two runs bit-equal, the register variant, one device
     kernel per call; timed from scores to output, the kernel's own device
     time beside it, and an estimate of its dependency floor (assumed
     latencies, not measured; printed, not in the kernels line);
  5. main path: the eval step built from configs/inference_mp3d.yaml with
     seeded random weights, a warm-up batch, then 3 batches of 4 pairs of
     480x640 uint8 images; output shapes, dtypes and finiteness are checked
     and each kernel's launch counter must rise by exactly 3. With random
     weights the 50 queries collapse to one representation, so every view
     keeps one plane and every pair has one match;
  6. planar scene: select_planes and camera_inference of the same model at
     full size on head outputs with 12 distinct planes per view, view 1 a
     permutation of view 0 (the regime a trained model gives: overlap
     filter, several valid queries, more than one match per pair), on the
     card against the CPU; and their time against the main path's regime;
  7. reference: the same eval step at 96x128 on the card (through the
     kernels) against the CPU (through their plain versions);
  8. B3 (mask_loss_fwd, mask_loss_bwd) at one supervision level of the train
     step: [32, 50, 120, 160] logits, [32, 50, 480, 640] uint8 masks, 12
     matched queries per view; kernel against its plain version: sums within
     rtol 1e-4, d src within 1e-4 of max |d src|, exact zeros for unmatched
     queries, and an all-unmatched batch; each kernel's registers, shared
     memory, spill bytes and resident blocks per SM (cudaFuncGetAttributes);
  9. train path: the train step of configs/train_mp3d_step3.yaml (f32, 16
     pairs of 480x640, seeded random weights) on synthetic pairs of 12
     planes per view from the port's generator, a warm-up step, then 3
     steps: every loss of the JAX train_forward present and finite, no
     skipped step, a finite positive gradient norm in each of the four
     modules, each B3 counter at 3 per step, B1 and B2 not launched;
 10. train reference: one train step of one pair at 96x128
     (configs/smoke_synthetic.yaml, dropout 0, AIM random poses injected)
     on the card and on the CPU from the same weights and batch: the match
     of every supervision level equal, every loss within max(1e-4, 1e-3
     relative), the gradient norm within 1e-3 relative, the parameters
     after the AdamW step within 1e-5 relative (norm over the model);
 11. B4 (bottleneck_tail) at the eight shapes of the fused-tail eval path
     (8 images of 480x640: res2..res5, conv1 Cin -> Cout/4 with ReLU, conv3
     Cout/4 -> Cout with the residual and ReLU), f32, kernel against its
     plain version within 1e-5 of max |ref|; bf16 at the JAX test's shape
     (B 2, P 300, 64 -> 256, with and without residual and ReLU) and at
     res2's conv3, within one bf16 ulp of it (2^-7 |ref| + 1e-6);
     times beside the unfused sequence the backbone runs without B4 (cuDNN
     1x1 conv, then the ATen affine, add and ReLU); every eval shape must
     take the vec variant, whose config (BM, Cin split, blocks) is printed
     per shape with each variant's registers, shared memory and spills;
 12. fused-tail eval path: the phase-5 model and batches with
     `fuse_tail=True`: B4's counter rises by exactly 24 per batch (12
     identity blocks, two calls each), res2..res5 match the unfused backbone
     within 1e-4 of max |ref|, the outputs match phase 5's at the limits of
     phases 6 and 7, and the two eval steps are timed in alternating rounds;
 13. the evaluation entry point (`engine/test.py`) at full width on 16
     synthetic pairs of 12 planes per view from the port's generator,
     inference_mp3d.yaml with the fused-tail backbone and
     TEST.EVAL_FULL_SCENE: the metrics of tests/test_end_to_end.py present
     and finite, both artifacts written under output/ and readable,
     the B1/B2/B4 counters at one/one/24 per batch; the host postprocess
     timed per pair on the main path's and the planar scene's outputs.
 14. training entry point: `engine/trainer.py:Trainer` on
     configs/train_mp3d_step3.yaml (f32, seeded weights, 16 pairs of
     480x640 per step) over 32 synthetic pairs of 12 planes per view, with
     the spawn pool (DATALOADER.NUM_WORKERS 4), 4 steps, a checkpoint every
     2, precise-BN over 2 batches and the evaluation hook (8 pairs) at step
     4: loss rows for iterations 0 and 3 in metrics.json, finite, no skipped
     step; the eval row with tests/test_end_to_end.py's metrics, finite;
     model_0000002.pth, model_0000004.pth, model_final.pth and
     last_checkpoint; B3 launched 3 times per step and B1/B2 once per eval
     batch; a second Trainer resumed from the last checkpoint equal bit for
     bit to the first (model, AdamW moments, update count, generator); the
     weight chain: a train_mp3d_step1 model loads the step-3 file (every
     shared tensor the file's, the heads unexpected) and a train_mp3d_step2
     model loads the step-1 file (the new heads reported missing). Prints
     the loop's ms per step beside phase 9's bare step, the time blocked on
     the loader per step, checkpoint save ms and size, precise-BN ms and
     the evaluation hook's ms.
Phases 11-13 run right after phase 7, while the eval model is on the card;
phase 14 runs after phase 10.
Phases 6, 7 and 12 hold the card to the CPU, or the fused path to the
unfused one, as the CPU is held to JAX in tests/test_torch_slice.py: valid
planes equal, labels agree on >= 99.9% of pixels, log-scores within 1.5e-3
and every camera within 1e-3; phase 10 does the same with the tolerances of
tests/test_torch_train.py.
Then one JSON line with every kernel's launches, error and times, and, last,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The launches of B1 and B2 are those of the eval path (phase 5), those of B3
those of the train path (phase 9), those of B4 those of the fused-tail eval
path (phase 12); phase 14 checks its own. B4's times are per eval batch:
the sum over its 24 calls.

Kernel times are CUDA-event means over many warm launches. `bound_ms` is the
larger of bytes moved / 3.35 TB/s and f32 operations / 67 TFLOP/s (H100 SXM
published peaks).

    python3 chip_smoke.py --time-tree DIR

times B1 and B2 of the port in DIR (a checkout of any of its commits, e.g. a
parent unpacked with `git archive`) on phase 3's and 4's inputs, through the
functions the eval path calls, with this script's timing code, and prints
one JSON line; run it for a parent and a change in turns in one call.
"""
import argparse
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "inference_mp3d.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "train_mp3d_step3.yaml")
SMOKE_CONFIG = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
N_PAIRS = 4        # TEST.IMS_PER_BATCH
N_BATCHES = 3
SINKHORN_ITERS = 200
TRAIN_PAIRS = 16   # SOLVER.IMS_PER_BATCH
TRAIN_STEPS = 3
TRAIN_PLANES = 12  # the generator's full 4 x 3 grid
# B3 operation counts per output pixel of a matched query, from
# csrc/mask_loss.cu (exp, log1p and a division count one each): forward, the
# 2x2 stencil (9), the shared-exp focal/dice terms (22) and the four sums
# (8); backward, the same stencil and terms, dz from the three incoming
# gradients (19) and the adjoint stencil (5)
MASK_FWD_OPS = 39
MASK_BWD_OPS = 55
LOSS_ABS, LOSS_REL = 1e-4, 1e-3  # tests/test_torch_train.py
MATCH_GAP = 1e-3
# An estimate of B2's dependency floor, not a measurement: assumed latencies
# in cycles of the steps of one half-iteration's chain on the H100: a shared
# load, a shuffle, an f32 add/max, the IEEE expf (7 dependent instructions
# around one MUFU.EX2 in the compiled kernel's SASS) and logf (~18 dependent
# ones), a block barrier; and the SM clock under load that the kernel
# table's rates use
SINKHORN_LATENCY = {"lds": 30, "shfl": 25, "alu": 4, "expf": 46, "logf": 80, "barrier": 30}
SM_CLOCK_HZ = 1.755e9
# B4 at 480x640 with 8 images (4 pairs, both views): per stage the map size,
# the block's width and bottleneck width, and its identity blocks
B4_STAGES = (("res2", 120, 160, 256, 64, 2), ("res3", 60, 80, 512, 128, 3),
             ("res4", 30, 40, 1024, 256, 5), ("res5", 15, 20, 2048, 512, 2))
B4_LAUNCHES = 2 * sum(s[-1] for s in B4_STAGES)  # 24 per eval batch
B4_F32_TOL = 1e-5  # of max |ref|: f32 sums over Cin in another order
BF16_ULP = 2.0 ** -7
ENTRY_PAIRS = 16
TRAINER_PAIRS = 32       # the training split of phase 14
TRAINER_TEST_PAIRS = 8   # its test split: two eval batches
TRAINER_STEPS = 4
TRAINER_HW = (480, 640)
TRAINER_SPLIT = "chip_smoke_trainer_test"


class SmokeFailure(Exception):
    pass


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, warm=3, iters=20):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(torch, fn, calls=5):
    """Device events (kernels, memcpy, memset) per call of fn, their names and
    their summed device ms per call, under torch.profiler after a warm call:
    how many launches a wrapper really costs."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"per_call": sum(e.count for e in evts) / calls,
            "device_ms": sum(e.self_device_time_total for e in evts) / 1e3 / calls,
            "names": sorted({e.key[:60] for e in evts})}


def alternating_ms(torch, fns, rounds=10, iters=2):
    """Median and range of CUDA-event ms per call of each of `fns`, timed in
    rounds whose order flips every round, so that a change of the host's
    speed during the run falls on all of them alike."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for r in range(rounds):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            times[i].append(cuda_ms(torch, fns[i], warm=0, iters=iters))
    return [(statistics.median(t), min(t), max(t)) for t in times]


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {name} capability {cap[0]}.{cap[1]} count {torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap < (9, 0):
        raise SmokeFailure(f"needs compute capability >= 9.0 (sm_90a), got {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "unknown"
    print(card)
    return name, card


def phase_build():
    from nopesac_torch.ops import _build
    secs = _build.build_all()
    print(f"[build] nvcc {secs:.2f} s -> {_build._build_dir()}")


def select_inputs(torch, gen, b, nq, h, w, dev):
    """Seeded probabilities with smooth regions and sharp edges, scores and
    validity; view 0 has no valid query (its labels must all be 0)."""
    coarse = torch.randn((b, nq, h // 8, w // 8), generator=gen, device=dev) * 6.0
    fine = torch.randn((b, nq, h, w), generator=gen, device=dev)
    logits = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                             align_corners=False) + fine
    prob = torch.sigmoid(logits)
    score = torch.rand((b, nq), generator=gen, device=dev) * 0.5 + 0.5
    valid = torch.rand((b, nq), generator=gen, device=dev) > 0.5
    valid[0] = False
    return prob, score, valid


def select_case(torch, dev):
    """Phase 3's inputs: the eval batch's 8 views of 50 queries at 120x160,
    bf16 probabilities."""
    gen = torch.Generator(device=dev).manual_seed(1)
    prob, score, valid = select_inputs(torch, gen, 2 * N_PAIRS, 50, 120, 160, dev)
    return prob.to(torch.bfloat16), score, valid


def sinkhorn_case(torch, dev):
    """Phase 4's inputs: scores [4, 50, 50], masked rows and columns, bin
    score 1."""
    gen = torch.Generator(device=dev).manual_seed(2)
    scores = torch.randn((N_PAIRS, 50, 50), generator=gen, device=dev) * 3.0
    row = torch.rand((N_PAIRS, 50), generator=gen, device=dev) > 0.4
    col = torch.rand((N_PAIRS, 50), generator=gen, device=dev) > 0.4
    return scores, torch.tensor(1.0, device=dev), row, col


def eval_path_calls(torch, dev):
    """B1 and B2 on phase 3's and 4's inputs through the functions the eval
    path calls, which every commit of the port has (so `--time-tree` times
    a parent by the same code)."""
    from nopesac_torch.ops import select, sinkhorn
    prob, score, valid = select_case(torch, dev)
    scores, alpha, row, col = sinkhorn_case(torch, dev)
    _, _, h, w = prob.shape
    return {"select_maps": lambda: select.fused_select_maps(prob, score, valid, 0.5, 4 * h, 4 * w),
            "sinkhorn": lambda: sinkhorn.log_optimal_transport_masked(scores, alpha,
                                                                      SINKHORN_ITERS, row, col)}


def check_select(torch, dev):
    from nopesac_torch.ops import select
    prob16, score, valid = select_case(torch, dev)
    b, nq, h, w = prob16.shape
    out_h, out_w, thr = 4 * h, 4 * w, 0.5
    seg_k, mx_k, st_k = select.select_maps_cuda(prob16, score, valid, thr, out_h, out_w)
    cfg = dict(select.last_config)
    seg_p, mx_p, st_p = select.select_maps_plain(prob16.float(), score, valid, thr, out_h, out_w)
    again = select.select_maps_cuda(prob16, score, valid, thr, out_h, out_w)
    torch.cuda.synchronize()
    n_seg = int((seg_k != seg_p).sum())
    n_mx = int((mx_k != mx_p).sum())
    err = float((mx_k - mx_p).abs().max())
    counts = [0, 3, 6]
    n_cnt = int((st_k[:, counts] != st_p[:, counts]).sum())
    sums = [1, 2, 4, 5]
    sum_ok = torch.allclose(st_k[:, sums], st_p[:, sums], rtol=1e-5, atol=0.0)
    same = all(torch.equal(x, y) for x, y in zip((seg_k, mx_k, st_k), again))
    print(f"[B1 select_maps] seg mismatches {n_seg}, max mismatches {n_mx} "
          f"(max |diff| {err:.3e}), count mismatches {n_cnt}, sums within rtol 1e-5: {sum_ok}; "
          f"all-invalid view labels all 0: {bool((seg_k[0] == 0).all())}; two runs bit-equal: "
          f"{same}; variant {cfg}")
    if (n_seg or n_mx or n_cnt or not sum_ok or not bool((seg_k[0] == 0).all()) or not same
            or cfg["variant"] != "vec"):
        raise SmokeFailure("B1 kernel disagrees with its plain version (or leaves its vec "
                           "variant at the main-path shape)")
    print(f"[B1 select_maps] kernel: {select.kernel_attributes('vec', nq)} (cudaFuncGetAttributes)")
    call = eval_path_calls(torch, dev)["select_maps"]
    prof = device_events(torch, call)
    print(f"[B1 select_maps] torch.profiler: {prof['per_call']:g} device events per call "
          f"({prof['names']}), {prof['device_ms']:.4f} device ms per call")
    if prof["per_call"] != 1:
        raise SmokeFailure("B1 must be one device kernel per call")
    ms = cuda_ms(torch, call, iters=50)
    plain_ms = cuda_ms(torch, lambda: select.select_maps_plain(
        prob16.float(), score, valid, thr, out_h, out_w), warm=2, iters=5)
    n_bytes = (b * nq * h * w * 2 + b * nq * (4 + 1)        # prob bf16, score, valid
               + 2 * b * out_h * out_w * 4 + b * 7 * nq * 4)  # seg, max, stats
    # per output pixel and query: a row 2-tap (3), the score product (1) and
    # 3/4 of a column 2-tap (2.25), shared by the 4 output rows of a low-res pixel
    n_ops = b * nq * out_h * out_w * 6.25
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"[B1 select_maps] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}: {n_bytes} B, {n_ops:.0f} flop)")
    return {"name": "select_maps", "route": "cuda", "source": "nopesac_torch/ops/csrc/select.cu",
            "replaces": "nopesac_tpu/ops/select_pallas.py:213", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "device_events_per_call": prof["per_call"]}


def sinkhorn_floor_ms(iters, group):
    """An estimate of B2's dependency floor: 2 * iters half-iterations, each a
    chain of a shared-memory load of u or v, two log2(group)-level shuffle
    trees (a shuffle and a max or add per level), an expf, a logf and a
    barrier, at the assumed latencies of SINKHORN_LATENCY (cycles) and
    SM_CLOCK_HZ."""
    lat = SINKHORN_LATENCY
    levels = int(math.log2(group))
    cycles = (lat["lds"] + 2 * levels * (lat["shfl"] + lat["alu"]) + lat["expf"] + lat["logf"]
              + lat["barrier"] + 4 * lat["alu"])
    return 2 * iters * cycles / SM_CLOCK_HZ * 1e3, cycles


def check_sinkhorn(torch, dev):
    from nopesac_torch.ops import sinkhorn
    scores, alpha, row, col = sinkhorn_case(torch, dev)
    (b, m, n), iters = scores.shape, SINKHORN_ITERS
    got = sinkhorn.log_optimal_transport_masked(scores, alpha, iters, row, col)
    cfg = dict(sinkhorn.last_config)
    ref = sinkhorn.sinkhorn_plain(scores, alpha, iters, row, col)
    again = sinkhorn.log_optimal_transport_masked(scores, alpha, iters, row, col)
    torch.cuda.synchronize()
    # 200 dependent iterations compound ulp differences of expf/logf and of
    # the reduction order; the -1e5 masked band is left out
    keep = ref.abs() < 1e4
    err = float((got - ref).abs()[keep].max())
    print(f"[B2 sinkhorn] max |kernel - plain| {err:.3e} over {int(keep.sum())} entries "
          f"(finite: {bool(torch.isfinite(got).all())}); two runs bit-equal: "
          f"{torch.equal(got, again)}; config {cfg}")
    if not err <= 1e-4 or not bool(torch.isfinite(got).all()) or not torch.equal(got, again):
        raise SmokeFailure("B2 kernel disagrees with its plain version")
    if cfg["variant"] != "register":
        raise SmokeFailure(f"B2 took its {cfg['variant']} variant at [{b}, {m + 1}, {n + 1}]; the "
                           f"main-path shape must take the register one")
    # scores to output, through the wrapper the matching head calls
    call = eval_path_calls(torch, dev)["sinkhorn"]
    prof = device_events(torch, call)
    print(f"[B2 sinkhorn] torch.profiler: {prof['per_call']:g} device events per call "
          f"({prof['names']}), kernel {prof['device_ms']:.4f} device ms per call")
    if prof["per_call"] != 1:
        raise SmokeFailure("B2 must be one device kernel per call, from scores to output")
    ms = cuda_ms(torch, call, iters=50)
    plain_ms = cuda_ms(torch, lambda: sinkhorn.sinkhorn_plain(scores, alpha, iters, row, col),
                       warm=1, iters=3)
    r, c = m + 1, n + 1
    n_bytes = 4 * b * m * n + b * (m + n) + 4 + 4 * b * r * c  # scores, masks, alpha, out
    n_ops = b * iters * 2 * r * c * 5                          # add, max, sub, exp, sum per entry and pass
    bms, by = bound_ms(n_bytes, n_ops)
    floor_ms, cycles = sinkhorn_floor_ms(iters, sinkhorn.GROUP)
    print(f"[B2 sinkhorn] scores to output {ms:.4f} ms ({sinkhorn.GROUP} lanes per row), kernel "
          f"alone {prof['device_ms']:.4f} device ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
          f"({by}: {n_bytes} B, {n_ops} flop); dependency floor estimate {floor_ms:.4f} ms "
          f"({cycles} cycles per half-iteration at assumed latencies, not measured)")
    return {"name": "sinkhorn", "route": "cuda", "source": "nopesac_torch/ops/csrc/sinkhorn.cu",
            "replaces": "nopesac_tpu/ops/sinkhorn_pallas.py:87", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "kernel_device_ms": prof["device_ms"], "device_events_per_call": prof["per_call"]}


def check_outputs(torch, out, b, h, w, nq):
    expect = {
        "view0.valid": ((b, nq), torch.bool), "view0.score": ((b, nq), torch.float32),
        "view0.params": ((b, nq, 3), torch.float32), "view0.seg_gated": ((b, h, w), torch.int8),
        "view0.centers": ((b, nq, 2), torch.float32),
        "log_scores": ((b, nq + 1, nq + 1), torch.float32),
        "assignment": ((b, nq, nq), torch.float32),
        "assignment_beforeRef": ((b, nq, nq), torch.float32),
        "num_matches": ((b,), torch.int32),
        "camera_onePP.rot": ((b, nq + 1, 4), torch.float32),
        "camera_onePP.hyp_valid": ((b, nq + 1), torch.bool),
    }
    for cam in ("camera_zero", "camera_init", "camera_initRec", "camera_avgRef0",
                "camera_softRef0", "camera"):
        expect[f"cameras.{cam}.tran"] = ((b, 3), torch.float32)
        expect[f"cameras.{cam}.rot"] = ((b, 4), torch.float32)
    for v in ("view1",):
        for k in ("valid", "score", "params", "seg_gated", "centers"):
            expect[f"{v}.{k}"] = expect[f"view0.{k}"]
    for key, (shape, dtype) in expect.items():
        t = out
        for part in key.split("."):
            t = t[part]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise SmokeFailure(f"{key}: got {tuple(t.shape)} {t.dtype}, want {shape} {dtype}")
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise SmokeFailure(f"{key} has non-finite values")
    for cam in ("camera", "camera_softRef0"):
        norm = out["cameras"][cam]["rot"].norm(dim=-1)
        if not bool(((norm - 1).abs() < 1e-4).all()):
            raise SmokeFailure(f"{cam} rotation is not a unit quaternion: {norm.tolist()}")


def load_cfg(size=None):
    from nopesac_torch.config.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    if size is not None:
        cfg.INPUT.IMAGE_SIZE = size
    return cfg


def run_main_path(torch, dev, card):
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step, synthetic_pairs
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    t0 = time.perf_counter()
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    print(f"[main] model built in {time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS} Sinkhorn iterations, {h}x{w}")
    batches = [synthetic_pairs(N_PAIRS, h, w, seed=s, device=dev) for s in range(N_BATCHES + 1)]
    with torch.inference_mode():
        out = step(*batches[0])  # warm-up (cuDNN autotuning, allocator)
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        outs = [step(*pair) for pair in batches[1:]]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = LAUNCHES.snapshot()
    for o in outs:
        check_outputs(torch, o, N_PAIRS, h, w, nq)
    ms = secs / N_BATCHES * 1e3
    planes = [int(x) for o in outs for v in ("view0", "view1") for x in o[v]["valid"].sum(1)]
    print(f"[main] {ms:.2f} ms/batch of {N_PAIRS} pairs, {N_PAIRS * N_BATCHES / secs:.2f} pairs/s "
          f"on {card}; launches {counts}; valid planes per view {planes}; matches per pair "
          f"{[int(x) for o in outs for x in o['num_matches']]}")
    want = {"select_maps": N_BATCHES, "sinkhorn": N_BATCHES, "mask_loss_fwd": 0, "mask_loss_bwd": 0,
            "bottleneck_tail": 0}
    if counts != want:
        raise SmokeFailure(f"eval path launches {counts}, want {want}")
    return counts, model, batches, outs, ms


def planar_scene(torch, b, nq, h, w, seed, grid=(3, 4)):
    """Head outputs and query features of b pairs ([2b, ...], view 0 then
    view 1): grid[0] x grid[1] confident planes per
    view, each owning one block of the low-res [h, w] mask grid, the other
    queries not planes; view 1 is view 0 with its queries permuted and its
    plane parameters and query features slightly perturbed."""
    gen = torch.Generator().manual_seed(seed)
    k = grid[0] * grid[1]
    logits = torch.tensor([-3.0, 3.0]).repeat(b, nq, 1)
    logits[:, :k] = torch.tensor([3.0, -3.0])
    masks = torch.full((b, nq, h, w), -8.0)
    gh, gw = h // grid[0], w // grid[1]
    for q in range(k):
        r, c = divmod(q, grid[1])
        masks[:, q, r * gh:(r + 1) * gh, c * gw:(c + 1) * gw] = (
            2.0 + 4.0 * torch.rand((b, 1, 1), generator=gen))
    params = torch.randn((b, nq, 3), generator=gen)
    qf0 = torch.randn((b, nq, 256), generator=gen)
    perm = torch.randperm(nq, generator=gen)

    def noisy(t, sigma):
        return t + sigma * torch.randn(t.shape, generator=gen)

    view0 = {"pred_logits": logits, "pred_params": params, "pred_mask_logits": masks}
    view1 = {"pred_logits": logits[:, perm], "pred_params": noisy(params[:, perm], 0.05),
             "pred_mask_logits": masks[:, perm]}
    outputs = {key: torch.cat([view0[key], view1[key]]) for key in view0}
    return outputs, torch.cat([qf0, noisy(qf0[:, perm], 0.1)]), k


def compare_with_cpu(torch, ref, got, what, versus="card vs CPU"):
    """Eval outputs `got` against `ref` (both moved to the CPU), at the
    slice's tolerances."""
    ref, got = to_host(ref), to_host(got)
    errs = {}
    for view in ("view0", "view1"):
        if not torch.equal(got[view]["valid"], ref[view]["valid"]):
            raise SmokeFailure(f"{what}, {view}: valid planes differ ({versus})")
        errs[f"{view}.seg_agree"] = float(
            (got[view]["seg_gated"] == ref[view]["seg_gated"]).float().mean())
    if not torch.equal(got["num_matches"], ref["num_matches"]):
        raise SmokeFailure(f"{what}: the number of matches differs ({versus})")
    keep = ref["log_scores"].abs() < 1e4
    errs["log_scores"] = float((got["log_scores"] - ref["log_scores"]).abs()[keep].max())
    errs["cameras"] = max(float((got["cameras"][c][k] - v).abs().max())
                          for c, d in ref["cameras"].items() for k, v in d.items())
    print(f"[{what}] {versus}: {errs}")
    if (min(errs["view0.seg_agree"], errs["view1.seg_agree"]) < 0.999
            or not errs["log_scores"] <= 1.5e-3 or not errs["cameras"] <= 1e-3):
        raise SmokeFailure(f"{what}: outputs disagree ({versus})")


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.cpu()


def run_planar_scene(torch, dev, model, images, card):
    from nopesac_torch.engine.predict import build_model_from_cfg

    cfg = load_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, device=dev)
    std = torch.tensor(cfg.MODEL.PIXEL_STD, device=dev)
    x = ((torch.cat(images).float() - mean) / std).permute(0, 3, 1, 2).contiguous()
    outputs, qf, k = planar_scene(torch, N_PAIRS, nq, h // 4, w // 4, seed=5)
    with torch.inference_mode():
        feats, head_out, qf_cat = model.detect(x)
        on_card = [{key: v.to(dev) for key, v in outputs.items()}, qf.to(dev)]
        got = model.inference_from_detections(feats, *on_card, h, w)
        check_outputs(torch, got, N_PAIRS, h, w, nq)
        planes = [int(n) for v in ("view0", "view1") for n in got[v]["valid"].sum(1)]
        matches = [int(n) for n in got["num_matches"]]
        print(f"[planar] valid planes per view {planes}; matches per pair {matches}")
        if any(n != k for n in planes) or any(m <= 1 for m in matches):
            raise SmokeFailure(f"the planar scene must keep {k} planes per view and match "
                               f"more than one per pair")
        planar, main = alternating_ms(torch, [
            lambda: model.inference_from_detections(feats, *on_card, h, w),
            lambda: model.inference_from_detections(feats, head_out, qf_cat, h, w)])
        print("[planar] select_planes + camera_inference, median (min-max) ms per batch over "
              "10 alternating rounds: planar scene {:.2f} ({:.2f}-{:.2f}), main path's head "
              "outputs {:.2f} ({:.2f}-{:.2f}), on {}".format(*planar, *main, card))
        cpu_model = build_model_from_cfg(cfg, device="cpu", seed=0)
        ref = cpu_model.inference_from_detections(
            {key: v.cpu() for key, v in feats.items()}, outputs, qf, h, w)
    compare_with_cpu(torch, ref, got, "planar")
    return got


def check_small_reference(torch, dev):
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step, synthetic_pairs

    cfg = load_cfg((96, 128))
    images = synthetic_pairs(2, 96, 128, seed=7, device="cpu")
    outs = []
    for d in ("cpu", dev):
        model = build_model_from_cfg(cfg, device=d, seed=0)
        outs.append(make_eval_step(model, 96, 128, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)(
            *images))
    compare_with_cpu(torch, *outs, "reference 96x128")


def mask_loss_inputs(torch, seed, b, nq, h, w, n_matched, grid=(3, 4)):
    """Seeded logits with coarse structure, disjoint GT masks (a grid of
    planes per view, ids shuffled) and n_matched matched queries per view,
    made on the host."""
    gen = torch.Generator().manual_seed(seed)
    coarse = torch.randn((b, nq, h // 4, w // 4), generator=gen) * 4.0
    src = coarse.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    src = src + torch.randn((b, nq, h, w), generator=gen)
    gh, gw = 4 * h, 4 * w
    k = grid[0] * grid[1]
    cell = ((torch.arange(gh) // (gh // grid[0]))[:, None] * grid[1]
            + (torch.arange(gw) // (gw // grid[1]))[None, :])  # [gh, gw] cell id
    onehot = (cell[None] == torch.arange(k)[:, None, None]).to(torch.uint8)  # [k, gh, gw]
    masks = torch.zeros((b, nq, gh, gw), dtype=torch.uint8)
    tgt = torch.zeros((b, nq), dtype=torch.int64)
    matched = torch.zeros((b, nq), dtype=torch.bool)
    for i in range(b):
        masks[i, torch.randperm(k, generator=gen)] = onehot
        q = torch.randperm(nq, generator=gen)[:n_matched]
        tgt[i, q] = torch.randperm(k, generator=gen)[:n_matched]
        matched[i, q] = True
    return src, masks, tgt, matched


def check_mask_loss(torch, dev):
    from nopesac_torch.ops import mask_loss

    b, nq, h, w, n_matched = 2 * TRAIN_PAIRS, 50, 120, 160, TRAIN_PLANES
    src, masks, tgt, matched = (t.to(dev) for t in mask_loss_inputs(torch, 3, b, nq, h, w,
                                                                       n_matched))
    weights = torch.randn((b, nq, 4), generator=torch.Generator().manual_seed(4)).to(dev)

    def sums_and_grad(fn, m):
        x = src.clone().requires_grad_(True)
        sums = fn(x, masks, tgt, m)
        torch.autograd.backward(torch.stack(sums, dim=-1), weights)
        return torch.stack(sums, dim=-1).detach(), x.grad

    k_sums, k_grad = sums_and_grad(mask_loss.fused_focal_dice, matched)
    p_sums, p_grad = sums_and_grad(mask_loss.focal_dice_plain, matched)
    z_sums, z_grad = sums_and_grad(mask_loss.fused_focal_dice, torch.zeros_like(matched))
    torch.cuda.synchronize()
    sum_rel = float(((k_sums - p_sums).abs() / p_sums.abs().clamp_min(1e-30))[matched].max())
    sum_err = float((k_sums - p_sums).abs().max())
    scale = float(p_grad.abs().max())
    grad_err = float((k_grad - p_grad).abs().max())
    zeros_ok = (bool((k_sums[~matched] == 0).all()) and bool((k_grad[~matched] == 0).all())
                and not bool(z_sums.any()) and not bool(z_grad.any()))
    print(f"[B3 mask_loss] {int(matched.sum())} matched of {b * nq} queries at [{b}, {nq}, {h}, "
          f"{w}] -> {4 * h}x{4 * w}: sums max rel err {sum_rel:.3e} (max abs {sum_err:.3e}), "
          f"d src max err {grad_err:.3e} of max |d src| {scale:.3e}; unmatched and all-unmatched "
          f"exact zeros: {zeros_ok}")
    if not (sum_rel <= 1e-4 and grad_err <= 1e-4 * scale and zeros_ok):
        raise SmokeFailure("B3 kernel disagrees with its plain version")

    for which in ("fwd", "bwd"):
        print(f"[B3 mask_loss] {which} kernel at w {w}: {mask_loss.kernel_attributes(which, w)} "
              f"(cudaFuncGetAttributes)")
    idx = mask_loss._flat_index(masks, tgt, matched)
    grad3 = weights[..., :3].reshape(-1, 3).contiguous()
    ms_fwd = cuda_ms(torch, lambda: mask_loss.mask_loss_fwd_cuda(src, masks, idx), iters=50)
    ms_bwd = cuda_ms(torch, lambda: mask_loss.mask_loss_bwd_cuda(src, masks, idx, grad3),
                     iters=50)

    def plain_fwd():
        return mask_loss.focal_dice_plain(src.detach().requires_grad_(True), masks, tgt, matched)

    def plain_fwd_bwd():
        torch.autograd.backward(torch.stack(plain_fwd(), dim=-1), weights)

    plain_fwd_ms = cuda_ms(torch, plain_fwd, warm=2, iters=5)
    plain_bwd_ms = cuda_ms(torch, plain_fwd_bwd, warm=2, iters=5) - plain_fwd_ms
    n_m, n_px = int(matched.sum()), 16 * h * w
    read = n_m * (h * w * 4 + n_px) + b * nq * 4  # matched logits, matched masks, index
    fwd_bms, fwd_by = bound_ms(read + b * nq * 4 * 4, n_m * n_px * MASK_FWD_OPS)
    bwd_bms, bwd_by = bound_ms(read + b * nq * 3 * 4 + b * nq * h * w * 4,
                               n_m * n_px * MASK_BWD_OPS)
    print(f"[B3 mask_loss] forward kernel {ms_fwd:.4f} ms (bound {fwd_bms:.4f} ms, {fwd_by}), "
          f"plain {plain_fwd_ms:.3f} ms; backward kernel {ms_bwd:.4f} ms (bound {bwd_bms:.4f} "
          f"ms, {bwd_by}), plain {plain_bwd_ms:.3f} ms")
    common = {"route": "cuda", "source": "nopesac_torch/ops/csrc/mask_loss.cu",
              "library_ms": None}
    return [dict(common, name="mask_loss_fwd", replaces="nopesac_tpu/ops/mask_loss_pallas.py:199",
                 max_abs_err=sum_err, ms=ms_fwd, plain_ms=plain_fwd_ms, bound_ms=fwd_bms,
                 bound_by=fwd_by),
            dict(common, name="mask_loss_bwd", replaces="nopesac_tpu/ops/mask_loss_pallas.py:235",
                 max_abs_err=grad_err, ms=ms_bwd, plain_ms=plain_bwd_ms, bound_ms=bwd_bms,
                 bound_by=bwd_by)]


_DET = ("loss_ce", "loss_mask", "loss_dice", "loss_center_ins", "loss_param_l1", "loss_param_cos")
_REF = ("tran_planeAvgReg", "rot_planeAvgReg", "tran_planeSoftReg", "rot_planeSoftReg",
        "rotIdx", "transIdx", "paramL2_dist")
# the loss keys of the JAX train_forward with every loss on (two aux levels)
TRAIN_LOSS_KEYS = sorted(
    list(_DET) + ["loss_center_pixel", "loss_q"]
    + [f"{k}_{i}" for i in (0, 1) for k in _DET]
    + ["losses_emb_0", "loss_tran_pixelReg", "loss_rot_pixelReg", "loss_rot_initCamRec",
       "loss_trans_initCamRec", "loss_rot_randCamRecLBS_N1", "loss_trans_randCamRecLBS_N1"]
    + [f"loss_{k}_{b}" for b in ("initCamRef", "initRecCamRef", "initCamRef_Aux",
                                 "initRecCamRef_Aux") for k in _REF])
TRAIN_MODULES = ("backbone", "sem_seg_head", "matching_head", "camera_head_list")


def load_train_cfg(path, opts):
    from nopesac_torch.config.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def module_grad_norms(torch, model):
    norms = {}
    for mod in TRAIN_MODULES:
        sq = [p.grad.pow(2).sum() for n, p in model.named_parameters()
              if n.startswith(mod) and p.grad is not None]
        norms[mod] = float(torch.stack(sq).sum().sqrt()) if sq else 0.0
    return norms


def run_train_path(torch, dev, card):
    from nopesac_torch.engine.train import TrainStep, build_train_model, synthetic_batches
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_train_cfg(TRAIN_CONFIG, [
        "MODEL.COMPUTE_DTYPE", "float32", "MODEL.BACKBONE_TRAIN_DTYPE", "float32",
        "SOLVER.IMS_PER_BATCH", str(TRAIN_PAIRS), "INPUT.IMAGE_SIZE", "(480, 640)"])
    t0 = time.perf_counter()
    model = build_train_model(cfg, device=dev, seed=0)
    step = TrainStep(model, cfg, seed=0)
    batches = list(synthetic_batches(cfg, TRAIN_STEPS + 1, seed=1, n_planes=TRAIN_PLANES,
                                     device=dev))
    torch.cuda.synchronize()
    print(f"[train] model and {TRAIN_STEPS + 1} batches of {TRAIN_PAIRS} pairs ({TRAIN_PLANES} "
          f"planes per view) built in {time.perf_counter() - t0:.2f} s")
    step(batches[0])  # warm-up (cuDNN autotuning, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    times, rows = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append((metrics, module_grad_norms(torch, model)))
    counts = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    for k, (metrics, norms) in enumerate(rows):
        losses = {n: float(v) for n, v in metrics.items()
                  if n not in ("total_loss", "grad_norm", "skipped_nonfinite")}
        if sorted(losses) != TRAIN_LOSS_KEYS:
            raise SmokeFailure(f"train step {k}: loss keys differ from the JAX train_forward's: "
                               f"{sorted(set(losses) ^ set(TRAIN_LOSS_KEYS))}")
        bad = sorted(n for n, v in losses.items() if not math.isfinite(v))
        if bad or float(metrics["skipped_nonfinite"]) != 0.0:
            raise SmokeFailure(f"train step {k}: non-finite losses {bad}, skipped "
                               f"{float(metrics['skipped_nonfinite'])}")
        if not all(math.isfinite(v) and v > 0 for v in norms.values()):
            raise SmokeFailure(f"train step {k}: gradient norms per module {norms}")
        print(f"[train] step {k}: total {float(metrics['total_loss']):.4f}, grad norm "
              f"{float(metrics['grad_norm']):.4f}, per module "
              f"{ {m: round(v, 4) for m, v in norms.items()} }, {times[k] * 1e3:.1f} ms")
    ms = statistics.mean(times) * 1e3
    print(f"[train] {ms:.2f} ms/step of {TRAIN_PAIRS} pairs at 480x640 f32, "
          f"{TRAIN_PAIRS / ms * 1e3:.2f} pairs/s, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) on {card}; launches {counts}")
    want = {"mask_loss_fwd": 3 * TRAIN_STEPS, "mask_loss_bwd": 3 * TRAIN_STEPS,
            "select_maps": 0, "sinkhorn": 0, "bottleneck_tail": 0}
    if counts != want:
        raise SmokeFailure(f"train path launches {counts}, want {want}")
    return counts, ms


def separate_queries(torch, model, seed):
    """With random weights the queries are nearly one representation and the
    optimal assignment nearly ties: larger query embeddings and a wider
    plane-param layer separate them (tests/test_torch_train.py does the
    same to the JAX init)."""
    gen = torch.Generator().manual_seed(seed)
    head = model.sem_seg_head
    with torch.no_grad():
        head.query_embed.weight.mul_(10.0)
        head.plane_param.layers[2].weight.mul_(10.0)
        for mlp in (head.plane_param, head.plane_center):
            last = mlp.layers[2]
            last.bias.copy_(torch.randn(last.bias.shape, generator=gen) * 0.5)


def detect_matches(torch, model, batch):
    """The Hungarian match and cost of every supervision level, from a
    train-mode detect (the model's BN running statistics change)."""
    from nopesac_torch.data.packing import unpack_targets
    from nopesac_torch.losses.criterion import compute_match_cost, match_planes_multi

    weights = model.train_settings.match_cost_weights()
    t0, t1 = unpack_targets(batch["targets0"]), unpack_targets(batch["targets1"])
    targets = {k: torch.cat([t0[k], t1[k]]) for k in t0}
    with torch.no_grad():
        images = torch.cat([batch["image0"], batch["image1"]]).permute(0, 3, 1, 2).contiguous()
        _, out, _ = model.detect(images)
        levels = [out] + out["aux_outputs"]
        costs = [compute_match_cost(o, targets, weights).cpu() for o in levels]
        return match_planes_multi(levels, targets, weights), costs, targets["gt_valid"].sum(1)


def assignment_gap(cost, n_gt):
    """Second-best minus optimal assignment cost on the [NQ, n_gt] block."""
    from scipy.optimize import linear_sum_assignment

    c = cost[:, :n_gt].double().numpy()
    rows, cols = linear_sum_assignment(c)
    best, second = c[rows, cols].sum(), float("inf")
    for r, k in zip(rows, cols):
        alt = c.copy()
        alt[r, k] = 1e9
        rr, cc = linear_sum_assignment(alt)
        second = min(second, alt[rr, cc].sum())
    return second - best


def check_train_reference(torch, dev):
    from nopesac_torch.engine.train import TrainStep, build_train_model, synthetic_batches
    from nopesac_torch.losses import camera_losses
    from nopesac_torch.models.nopesac import AIM_RAND_POSES

    # one pair, as tests/test_torch_train.py: at 96x128 the pose stacks end
    # at 1x1, where BN over two pairs' two values amplifies rounding noise
    cfg = load_train_cfg(SMOKE_CONFIG, ["MODEL.SEM_SEG_HEAD.DROPOUT", "0.0",
                                        "SOLVER.IMS_PER_BATCH", "1"])
    cpu_model = build_train_model(cfg, device="cpu", seed=0)
    separate_queries(torch, cpu_model, seed=1)
    card_model = build_train_model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    batch = next(iter(synthetic_batches(cfg, 1, seed=5, n_planes=6, device="cpu")))
    card_batch = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                      else v.to(dev)) for k, v in batch.items()}
    b = batch["image0"].shape[0]
    gen = torch.Generator().manual_seed(3)
    n_aim = b * max(AIM_RAND_POSES // b, 1)
    aim = [camera_losses.rand_aim_rot(gen, n_aim), camera_losses.rand_aim_trans(gen, n_aim)]

    ref_match, costs, n_gt = detect_matches(torch, copy.deepcopy(cpu_model), batch)
    got_match, _, _ = detect_matches(torch, copy.deepcopy(card_model), card_batch)
    gap = min(assignment_gap(c[i], int(n_gt[i])) for c in costs for i in range(c.shape[0]))
    if gap < MATCH_GAP:
        raise SmokeFailure(f"train reference: the optimal assignment's gap {gap:.2e} is below "
                           f"{MATCH_GAP}, so the match can tie")
    if not all(torch.equal(g.cpu(), r) for g, r in zip(got_match, ref_match)):
        raise SmokeFailure("train reference: the match differs between the card and the CPU")

    ref = TrainStep(cpu_model, cfg, seed=0)(batch, *aim)
    got = TrainStep(card_model, cfg, seed=0)(card_batch, *(a.to(dev) for a in aim))
    bad = {}
    for key, r in ref.items():
        g, r = float(got[key]), float(r)
        if key != "grad_norm" and not abs(g - r) <= max(LOSS_ABS, LOSS_REL * abs(r)):
            bad[key] = (g, r)
    gn_rel = abs(float(got["grad_norm"]) - float(ref["grad_norm"])) / float(ref["grad_norm"])
    # AdamW's first step is ~lr * sign(g); where a gradient entry is at the
    # rounding-noise level its sign may differ between the devices (a 2 * lr
    # difference), so the parameters are compared by their relative norm
    cpu_params = dict(cpu_model.named_parameters())
    diff = sum(float((p.detach().cpu() - cpu_params[n].detach()).pow(2).sum())
               for n, p in card_model.named_parameters())
    param_rel = (diff / sum(float(p.detach().pow(2).sum()) for p in cpu_params.values())) ** 0.5
    param_max = max(float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
                    for n, p in card_model.named_parameters())
    print(f"[train reference 96x128] card vs CPU: match equal on {len(ref_match)} levels (gap "
          f"{gap:.2e}), {len(ref) - 3} losses, {len(bad)} outside tolerance, grad norm rel "
          f"{gn_rel:.2e}, params after AdamW rel {param_rel:.2e} (max |diff| {param_max:.2e})")
    if bad or not gn_rel <= 1e-3 or not param_rel <= 1e-5:
        raise SmokeFailure(f"train reference: the card disagrees with the CPU: {bad}")


def trainer_cfg(path, out_dir, opts=()):
    """A curriculum config in f32 at 480x640 with 16 pairs per step, seeded
    weights unless `opts` name MODEL.WEIGHTS, and phase 14's loop settings."""
    return load_train_cfg(path, [
        "MODEL.COMPUTE_DTYPE", "float32", "MODEL.BACKBONE_TRAIN_DTYPE", "float32",
        "SOLVER.IMS_PER_BATCH", str(TRAIN_PAIRS), "INPUT.IMAGE_SIZE", str(TRAINER_HW),
        "MODEL.WEIGHTS", "", "DATALOADER.NUM_WORKERS", "4",
        "SOLVER.MAX_ITER", str(TRAINER_STEPS), "SOLVER.CHECKPOINT_PERIOD", "2",
        "TEST.EVAL_PERIOD", str(TRAINER_STEPS), "TEST.PRECISE_BN.ENABLED", "True",
        "TEST.PRECISE_BN.NUM_ITER", "2", "DATASETS.TEST", f'("{TRAINER_SPLIT}",)',
        "OUTPUT_DIR", out_dir, *opts])


def check_weight_chain(torch, trainer, path, prev, want_missing, want_unexpected, what):
    """Every tensor the model shares with the file at `path` (its state_dict
    `prev`) is the file's, and the overlay reported what was asked."""
    got = trainer.model.state_dict()
    shared = [k for k in got if k in prev]
    report = trainer.weights_report
    bad = [k for k in shared if not torch.equal(got[k].cpu(), prev[k])]
    print(f"[trainer] weight chain {what}: {len(shared)} shared tensors, "
          f"{len(report['missing'])} missing, {len(report['unexpected'])} unexpected")
    if (bad or not shared or sorted(report["missing"]) != sorted(want_missing)
            or sorted(report["unexpected"]) != sorted(want_unexpected)):
        raise SmokeFailure(f"weight chain {what}: {len(bad)} shared tensors differ from "
                           f"{path}, or the report differs")


def run_trainer(torch, dev, card, step_ms):
    import shutil

    from nopesac_torch.data.registry import DatasetCatalog
    from nopesac_torch.data.synthetic import make_dataset
    from nopesac_torch.engine.trainer import Trainer
    from nopesac_torch.utils.device import LAUNCHES

    out_dir = os.path.join(REPO, "output", "trainer_step3")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    train_pairs, test_pairs = (
        make_dataset(n, TRAIN_PLANES, seed=seed, h=TRAINER_HW[0], w=TRAINER_HW[1])
        for n, seed in ((TRAINER_PAIRS, 21), (TRAINER_TEST_PAIRS, 22)))
    # the masks as the split jsons carry them, COCO RLE only: the generator's
    # dense copies would triple what each worker is sent
    for pair in train_pairs:
        for v in ("0", "1"):
            for ann in pair[v]["annotations"]:
                del ann["mask"]
    if TRAINER_SPLIT not in DatasetCatalog:
        DatasetCatalog.register(TRAINER_SPLIT, lambda: test_pairs)
    cfg = trainer_cfg(TRAIN_CONFIG, out_dir)
    trainer = Trainer(cfg, dataset_list=train_pairs, device=dev)
    print(f"[trainer] {TRAINER_PAIRS} + {TRAINER_TEST_PAIRS} synthetic pairs and the trainer "
          f"built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    trainer.loader  # the spawn pool: each worker is sent the mapper and the split
    print(f"[trainer] loader with {cfg.DATALOADER.NUM_WORKERS} spawn workers started in "
          f"{time.perf_counter() - t0:.2f} s")
    LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        trainer.train()
    finally:
        trainer.close()
    secs = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    if trainer.last_eval_error is not None:
        raise SmokeFailure(f"trainer: the evaluation hook failed: {trainer.last_eval_error!r}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    loss_rows = {r["iteration"]: r for r in rows if "eval" not in r}
    eval_rows = [r for r in rows if "eval" in r]
    if sorted(loss_rows) != [0, TRAINER_STEPS - 1]:
        raise SmokeFailure(f"trainer: metrics.json loss rows for {sorted(loss_rows)}")
    for it, r in loss_rows.items():
        losses = {k: v for k, v in r.items() if k.startswith("loss")}
        bad = sorted(k for k, v in r.items() if not math.isfinite(v))
        if sorted(losses) != TRAIN_LOSS_KEYS or bad or r["skipped_nonfinite"] != 0:
            raise SmokeFailure(f"trainer: row {it} has non-finite {bad}, skipped "
                               f"{r['skipped_nonfinite']}, or other loss keys")
    keys = ("T median err", "R median err", "T err < 1.0", "R err < 30", "mask_ap@0.5",
            "plane_ap@iou0.5normal30.0offset0.3", "precision", "recall")
    if len(eval_rows) != 1:
        raise SmokeFailure(f"trainer: {len(eval_rows)} eval rows in metrics.json")
    ev = eval_rows[0]["eval"]
    if any(k not in ev for k in keys) or not all(math.isfinite(v) for v in ev.values()):
        raise SmokeFailure(f"trainer: the eval row lacks {[k for k in keys if k not in ev]} "
                           f"or is not finite")
    files = ("model_0000002.pth", "model_0000004.pth", "model_final.pth", "last_checkpoint")
    missing = [n for n in files if not os.path.exists(os.path.join(out_dir, n))]
    if missing:
        raise SmokeFailure(f"trainer: {missing} not written")
    n_eval = TRAINER_TEST_PAIRS // N_PAIRS
    want = {"mask_loss_fwd": 3 * TRAINER_STEPS, "mask_loss_bwd": 3 * TRAINER_STEPS,
            "select_maps": n_eval, "sinkhorn": n_eval, "bottleneck_tail": 0}
    if counts != want:
        raise SmokeFailure(f"trainer launches {counts}, want {want}")
    times = trainer.loop_times
    final = os.path.join(out_dir, "model_final.pth")
    print(f"[trainer] Trainer.train, {TRAINER_STEPS} steps of {TRAIN_PAIRS} pairs with "
          f"{cfg.DATALOADER.NUM_WORKERS} loader workers: {secs:.2f} s in all; time_per_iter_recent "
          f"{loss_rows[TRAINER_STEPS - 1]['time_per_iter_recent'] * 1e3:.2f} ms/step over steps "
          f"1-3 (a checkpoint save among them) against phase 9's bare step {step_ms:.2f} ms; "
          f"next(loader) blocked {statistics.mean(times['loader_wait_s']) * 1e3:.2f} ms per step "
          f"(per step {[round(t * 1e3, 2) for t in times['loader_wait_s']]}); checkpoint save "
          f"{statistics.mean(times['checkpoint_s']) * 1e3:.2f} ms per file "
          f"({len(times['checkpoint_s'])} files of {os.path.getsize(final) / 2**20:.1f} MB); "
          f"precise-BN {statistics.mean(times['precise_bn_s']) * 1e3:.2f} ms per pass (2 batches); "
          f"evaluation hook {times['eval_s'][0] * 1e3:.2f} ms over {TRAINER_TEST_PAIRS} pairs; "
          f"launches {counts}; on {card}")
    print(f"[trainer] eval row: { {k: round(ev[k], 4) for k in keys} }")

    # (e) resume: a second trainer restores the last checkpoint bit for bit
    resumed = Trainer(cfg, dataset_list=train_pairs, device=dev)
    resumed.resume_or_load(resume=True)
    a, b = trainer.train_step, resumed.train_step
    same = all(torch.equal(v, resumed.model.state_dict()[k])
               for k, v in trainer.model.state_dict().items())
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    same &= sa.keys() == sb.keys() and all(
        torch.equal(sa[i][m], sb[i][m]) for i in sa for m in ("exp_avg", "exp_avg_sq", "step"))
    same &= (a.step, a.updates) == (b.step, b.updates) and torch.equal(a.gen.get_state(),
                                                                      b.gen.get_state())
    print(f"[trainer] resumed at step {b.step}, {b.updates} updates: model, AdamW moments and "
          f"generator {'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise SmokeFailure("trainer: the resumed state differs from the saved one")
    del trainer, resumed, a, b, sa, sb
    torch.cuda.empty_cache()

    # (f) the weight chain in both directions
    step3 = torch.load(final, map_location="cpu", weights_only=False)["model"]
    step1_cfg = os.path.join(REPO, "configs", "train_mp3d_step1.yaml")
    step2_cfg = os.path.join(REPO, "configs", "train_mp3d_step2.yaml")
    one_dir = os.path.join(REPO, "output", "trainer_step1")
    one = Trainer(trainer_cfg(step1_cfg, one_dir, ["MODEL.WEIGHTS", final]), device=dev)
    sd1 = {k: v.cpu() for k, v in one.model.state_dict().items()}
    check_weight_chain(torch, one, final, step3, [], sorted(k for k in step3 if k not in sd1),
                       "step 3 -> step 1")
    one_final = one.checkpointer.save(one.model, None, 0, name="model_final")
    del one
    two_dir = os.path.join(REPO, "output", "trainer_step2")
    two = Trainer(trainer_cfg(step2_cfg, two_dir, ["MODEL.WEIGHTS", one_final]), device=dev)
    new = [k for k in two.model.state_dict() if k not in sd1]
    check_weight_chain(torch, two, one_final, sd1, new, [], "step 1 -> step 2")
    if not any(k.startswith("matching_head.") for k in new):
        raise SmokeFailure("weight chain step 1 -> step 2: no new matching head")
    del two
    torch.cuda.empty_cache()
    # each checkpoint of the model and its AdamW state is ~0.9 GB
    for d in (out_dir, one_dir, two_dir):
        shutil.rmtree(d, ignore_errors=True)


def b4_inputs(torch, dev, seed, b, cin, cout, h, w, residual, dtype=None):
    """Post-ReLU activations, a He-initialised 1x1 conv weight, a folded
    FrozenBN affine and a residual, seeded on the host."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, cin, h, w), generator=gen).abs()
    wt = torch.randn((cout, cin, 1, 1), generator=gen) * (2.0 / cin) ** 0.5
    scale = torch.rand(cout, generator=gen) + 0.5
    shift = torch.randn(cout, generator=gen) * 0.1
    res = torch.randn((b, cout, h, w), generator=gen) if residual else None
    dtype = dtype or torch.float32
    return (x.to(dev, dtype), wt.to(dev), scale.to(dev), shift.to(dev),
            None if res is None else res.to(dev, dtype))


def b4_cost(b, cin, cout, p, residual, elem=4):
    """Bytes (x, W, scale, shift, residual read once, y written once) and
    operations (the product and the epilogue: scale, shift, add, max)."""
    n_bytes = elem * (b * cin * p + cout * cin + b * cout * p * (2 if residual else 1)) + 8 * cout
    n_ops = b * p * cout * (2 * cin + 3 + (1 if residual else 0))
    return n_bytes, n_ops


def check_bottleneck(torch, dev, card):
    from nopesac_torch.ops import bottleneck

    F = torch.nn.functional
    b = 2 * N_PAIRS
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "unfused_ms": 0.0}
    by_count = {"bytes": 0, "operations": 0}
    worst = 0.0
    for stage, h, w, cout, mid, n_blocks in B4_STAGES:
        for cin, co, residual in ((cout, mid, False), (mid, cout, True)):
            x, wt, scale, shift, res = b4_inputs(torch, dev, len(rows), b, cin, co, h, w, residual)
            got = bottleneck.conv1x1_bn_act_cuda(x, wt, scale, shift, residual=res)
            cfg = dict(bottleneck.last_config)
            ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res)
            torch.cuda.synchronize()
            if cfg["variant"] != "vec":
                raise SmokeFailure(f"B4 took its {cfg['variant']} variant at {stage} {cin}->{co}; "
                                   f"every eval shape must take the vec one")
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            worst = max(worst, err)
            if not rel <= B4_F32_TOL:
                raise SmokeFailure(f"B4 kernel disagrees with its plain version at {stage} "
                                   f"{cin}->{co}: max |diff| {err:.3e} ({rel:.3e} of max |ref|)")

            def unfused():  # models/resnet.py without B4: ConvNorm, then add and ReLU
                y = F.conv2d(x, wt) * scale[None, :, None, None] + shift[None, :, None, None]
                return F.relu(y + res) if residual else F.relu(y)

            ms = cuda_ms(torch, lambda: bottleneck.conv1x1_bn_act_cuda(
                x, wt, scale, shift, residual=res), iters=20)
            plain_ms = cuda_ms(torch, lambda: bottleneck.conv1x1_bn_act_plain(
                x, wt, scale, shift, residual=res), warm=2, iters=5)
            unfused_ms = cuda_ms(torch, unfused, iters=20)
            bms, by = bound_ms(*b4_cost(b, cin, co, h * w, residual))
            rows.append({"shape": f"{stage} {cin}->{co}{' +res' if residual else ''}",
                         "P": b * h * w, "ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                         "bound_ms": bms, "bound_by": by, "max_rel_err": rel, "config": cfg})
            print(f"[B4 bottleneck_tail] {rows[-1]['shape']} (P {b * h * w}, x{n_blocks} per "
                  f"batch): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused cuDNN+ATen "
                  f"{unfused_ms:.4f} ms, bound {bms:.4f} ms ({by}); max |diff| {err:.3e} "
                  f"({rel:.2e} of max |ref|); variant {cfg['variant']}, BM {cfg['bm']}, split "
                  f"{cfg['split']}, {cfg['blocks']} blocks")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("unfused_ms", unfused_ms),
                           ("bound_ms", bms)):
                total[key] += n_blocks * v
            by_count[by] += n_blocks
            del x, wt, res, got, ref
    # bf16: the JAX test's shape (P 300, not a multiple of the 128-pixel tile)
    # and res2's conv3; within one bf16 ulp of the plain output
    bf16_rel = 0.0
    for bb, cin, co, h, w, residual, relu in ((2, 64, 256, 15, 20, True, True),
                                              (2, 64, 256, 15, 20, False, False),
                                              (b, 64, 256, 120, 160, True, True)):
        x, wt, scale, shift, res = b4_inputs(torch, dev, 100 + cin, bb, cin, co, h, w, residual,
                                             torch.bfloat16)
        got = bottleneck.conv1x1_bn_act_cuda(x, wt, scale, shift, residual=res, relu=relu).float()
        variant = bottleneck.last_config["variant"]
        ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res, relu=relu).float()
        torch.cuda.synchronize()
        diff, lim = (got - ref).abs(), BF16_ULP * ref.abs() + 1e-6
        over = int((diff > lim).sum())
        ulps = float((diff / lim).max())
        bf16_rel = max(bf16_rel, ulps)
        print(f"[B4 bottleneck_tail] bf16 [{bb}, {cin}, {h * w}] -> {co}, residual {residual}, "
              f"relu {relu} ({variant} variant): max |diff| {float(diff.max()):.3e}, max |diff| / "
              f"(2^-7 |ref| + 1e-6) {ulps:.3f}; {over} of {diff.numel()} outside")
        if over:
            raise SmokeFailure("B4 kernel (bf16) disagrees with its plain version")
    for dtype, bm, variant in ((torch.float32, 128, "vec"), (torch.float32, 64, "vec"),
                               (torch.bfloat16, 128, "scalar")):
        print(f"[B4 bottleneck_tail] {variant} {str(dtype)[6:]} BM {bm}: "
              f"{bottleneck.kernel_attributes(dtype, bm, variant)} (cudaFuncGetAttributes)")
    by = "bytes" if by_count["bytes"] > by_count["operations"] else "operations"
    print(f"[B4 bottleneck_tail] per eval batch ({B4_LAUNCHES} calls): kernel {total['ms']:.4f} "
          f"ms, plain {total['plain_ms']:.4f} ms, unfused cuDNN+ATen {total['unfused_ms']:.4f} "
          f"ms, bound {total['bound_ms']:.4f} ms, on {card}")
    return {"name": "bottleneck_tail", "route": "cuda",
            "source": "nopesac_torch/ops/csrc/bottleneck.cu",
            "replaces": "nopesac_tpu/ops/bottleneck_pallas.py:88", "max_abs_err": worst,
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": by, "library_ms": None, "unfused_ms": total["unfused_ms"],
            "bf16_max_diff_over_limit": bf16_rel, "per_shape": rows}


def run_fused_path(torch, dev, model, batches, outs, card):
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    fused = build_model_from_cfg(cfg, device=dev, fuse_tail=True)
    fused.load_state_dict(model.state_dict(), strict=True)
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, device=dev)
    std = torch.tensor(cfg.MODEL.PIXEL_STD, device=dev)
    x = ((torch.cat(batches[1]).float() - mean) / std).permute(0, 3, 1, 2).contiguous()
    # the seeded weights leave every FrozenBN at its identity statistics
    # (shift 0); copies of both backbones with trained-like statistics also
    # exercise B4's epilogue
    backbones = {"seeded": (fused.backbone, model.backbone),
                 "BN statistics": tuple(copy.deepcopy(m.backbone) for m in (fused, model))}
    gen = torch.Generator().manual_seed(6)
    for name, buf in backbones["BN statistics"][0].state_dict().items():
        if buf.dim() == 1:
            new = (torch.rand(buf.shape, generator=gen) + 0.5 if name.endswith(("weight", "var"))
                   else torch.randn(buf.shape, generator=gen) * 0.1)
            for bb in backbones["BN statistics"]:
                bb.state_dict()[name].copy_(new.to(dev))
    for what, (fb, ub) in backbones.items():
        with torch.inference_mode():
            feats, ref = fb(x), ub(x)
        errs = {k: float((feats[k] - r).abs().max()) / float(r.abs().max()) for k, r in ref.items()}
        print(f"[fused] res2..res5 fused vs unfused on the card ({what}), max |diff| / max |ref|: "
              f"{errs}")
        if not all(e <= 1e-4 for e in errs.values()):
            raise SmokeFailure("the fused-tail backbone disagrees with the unfused one")
    del backbones, feats, ref
    step = make_eval_step(fused, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    plain_step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    with torch.inference_mode():
        step(*batches[0])  # warm-up
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        fused_outs = [step(*pair) for pair in batches[1:]]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = LAUNCHES.snapshot()
        want = {"select_maps": N_BATCHES, "sinkhorn": N_BATCHES, "mask_loss_fwd": 0,
                "mask_loss_bwd": 0, "bottleneck_tail": B4_LAUNCHES * N_BATCHES}
        print(f"[fused] {secs / N_BATCHES * 1e3:.2f} ms/batch of {N_PAIRS} pairs (wall), "
              f"launches {counts}")
        if counts != want:
            raise SmokeFailure(f"fused-tail eval path launches {counts}, want {want}")
        for k, (o, r) in enumerate(zip(fused_outs, outs)):
            check_outputs(torch, o, N_PAIRS, h, w, nq)
            compare_with_cpu(torch, r, o, f"fused batch {k}", versus="fused vs unfused")
        fused_ms, plain_ms = alternating_ms(torch, [lambda: step(*batches[1]),
                                                    lambda: plain_step(*batches[1])])
    print("[fused] eval step, median (min-max) ms per batch over 10 alternating rounds: fused "
          "tail {:.2f} ({:.2f}-{:.2f}), unfused {:.2f} ({:.2f}-{:.2f}), on {}".format(
              *fused_ms, *plain_ms, card))
    return counts, fused


def run_entry_point(torch, dev, fused, planar_out, card):
    import pickle

    from nopesac_torch.config.config import get_cfg
    from nopesac_torch.data.synthetic import make_dataset
    from nopesac_torch.engine.predict import make_eval_step, synthetic_pairs
    from nopesac_torch.engine.test import EvalRunner
    from nopesac_torch.evaluation.postprocess import postprocess_batch
    from nopesac_torch.utils.device import LAUNCHES

    out_dir = os.path.join(REPO, "output", "eval_entry_point")
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(["MODEL.WEIGHTS", "", "TEST.EVAL_FULL_SCENE", "True",
                         "DATASETS.TEST", '("synthetic_test",)', "OUTPUT_DIR", out_dir])
    cfg.freeze()
    h, w = cfg.INPUT.IMAGE_SIZE
    for name in ("NopeSAC_instances_predictions.pth", "continuous.pkl", "siamese2coco.json"):
        if os.path.exists(os.path.join(out_dir, name)):
            os.remove(os.path.join(out_dir, name))
    t0 = time.perf_counter()
    pairs = make_dataset(n_pairs=ENTRY_PAIRS, n_planes=TRAIN_PLANES, seed=11, h=h, w=w)
    print(f"[entry] {ENTRY_PAIRS} synthetic pairs of {h}x{w}, {TRAIN_PLANES} planes per view, "
          f"made in {time.perf_counter() - t0:.2f} s")
    runner = EvalRunner(cfg, fused)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    results = runner.test(dataset_list=pairs)
    secs = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    n_batches = ENTRY_PAIRS // N_PAIRS
    want = {"select_maps": n_batches, "sinkhorn": n_batches, "mask_loss_fwd": 0,
            "mask_loss_bwd": 0, "bottleneck_tail": B4_LAUNCHES * n_batches}
    print(f"[entry] EvalRunner.test: last_eval_stats {runner.last_eval_stats}, with evaluate() "
          f"{secs:.2f} s, launches {counts}, on {card}")
    if counts != want:
        raise SmokeFailure(f"entry point launches {counts}, want {want}")
    keys = ("T median err", "R median err", "T err < 1.0", "R err < 30", "mask_ap@0.5",
            "plane_ap@iou0.5normal30.0offset0.3", "precision", "recall")
    missing = [k for k in keys if k not in results]
    bad = [k for k, v in results.items() if not math.isfinite(float(v))]
    print(f"[entry] metrics: { {k: round(float(results[k]), 4) for k in keys if k in results} }")
    if missing or bad:
        raise SmokeFailure(f"entry point metrics missing {missing}, not finite {bad}")
    preds = torch.load(os.path.join(out_dir, "NopeSAC_instances_predictions.pth"),
                       weights_only=False)
    with open(os.path.join(out_dir, "continuous.pkl"), "rb") as f:
        cont = pickle.load(f)
    cont_keys = {"n_corr", "cost", "best_camera", "gt_camera", "best_assignment",
                 "plane_param_override", "image_ids"}
    if (len(preds) != ENTRY_PAIRS or len(cont) != ENTRY_PAIRS or set(cont[0]) != cont_keys
            or not isinstance(preds[0]["0"]["pred_plane"], torch.Tensor)
            or not preds[0]["0"]["instances"]):
        raise SmokeFailure("entry point artifacts do not have the contract's shape")
    print(f"[entry] artifacts: {len(preds)} predictions, continuous.pkl keys {sorted(cont[0])}")

    # the host postprocess per pair: the main path's regime (one plane per
    # view with random weights) and the planar scene's (12 per view)
    metas = [{"image_id0": f"a{i}", "image_id1": f"b{i}"} for i in range(N_PAIRS)]
    step = make_eval_step(fused, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    with torch.inference_mode():
        main_out = step(*synthetic_pairs(N_PAIRS, h, w, seed=12, device=dev))
    for what, out in (("main path", main_out), ("planar scene", planar_out)):
        host = numpy_tree(out)
        postprocess_batch(host, metas, h, w)  # warm
        t0 = time.perf_counter()
        for _ in range(5):
            res = postprocess_batch(host, metas, h, w)
        ms = (time.perf_counter() - t0) / 5 / N_PAIRS * 1e3
        n_inst = [len(r[v]["instances"]) for r in res for v in ("0", "1")]
        print(f"[entry] postprocess {ms:.3f} ms/pair on the {what}'s outputs (instances per view "
              f"{n_inst}), host CPU of {card}")


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def time_tree(torch, tree):
    """`--time-tree`: B1 and B2 of the port in `tree` timed by this script
    (CUDA-event mean over 50 warm calls, device events under the profiler);
    one JSON line with the card's name and power limit."""
    dev = torch.device("cuda", 0)
    _, card = phase_device(torch)
    result = {"tree": os.path.relpath(tree, REPO), "card": card}
    with torch.inference_mode():
        for name, call in eval_path_calls(torch, dev).items():
            prof = device_events(torch, call)
            result[name] = {"ms": cuda_ms(torch, call, iters=50),
                            "device_events_per_call": prof["per_call"],
                            "device_ms": prof["device_ms"]}
    print(json.dumps(result))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-tree", default=None, metavar="DIR",
                    help="only time B1 and B2 of the port in DIR (see above)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(args.time_tree or REPO)
    sys.path.insert(0, tree)
    try:
        import nopesac_torch
    except ImportError as e:
        print(f"chip_smoke: the nopesac_torch package is missing in {tree} ({e})",
              file=sys.stderr)
        return 2
    if not os.path.abspath(nopesac_torch.__file__).startswith(tree + os.sep):
        print(f"chip_smoke: imported {nopesac_torch.__file__}, not the package in {tree}",
              file=sys.stderr)
        return 2
    if args.time_tree:
        return time_tree(torch, tree)
    from nopesac_torch.utils.device import set_f32_parity
    set_f32_parity()
    dev = torch.device("cuda", 0)
    try:
        name, card = phase_device(torch)
        phase_build()
        kernels = [check_select(torch, dev), check_sinkhorn(torch, dev)]
        counts, model, batches, outs, _ = run_main_path(torch, dev, card)
        planar_out = run_planar_scene(torch, dev, model, batches[0], card)
        check_small_reference(torch, dev)
        b4 = check_bottleneck(torch, dev, card)
        fused_counts, fused = run_fused_path(torch, dev, model, batches, outs, card)
        counts["bottleneck_tail"] = fused_counts["bottleneck_tail"]
        run_entry_point(torch, dev, fused, planar_out, card)
        del model, fused, batches, outs, planar_out
        torch.cuda.empty_cache()
        kernels += check_mask_loss(torch, dev)
        train_counts, step_ms = run_train_path(torch, dev, card)
        counts.update({k: v for k, v in train_counts.items() if k.startswith("mask_loss")})
        check_train_reference(torch, dev)
        run_trainer(torch, dev, card, step_ms)
        kernels.append(b4)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
