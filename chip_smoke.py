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
     queries, and an all-unmatched batch; the same with bf16 logits (sums
     within rtol 1e-4, d src within one bf16 ulp, 2^-7 max |d src|), timed
     beside the f32 kernels; each kernel's registers, shared memory, spill
     bytes and resident blocks per SM (cudaFuncGetAttributes);
  9. train path: the train step of configs/train_mp3d_step3.yaml (f32 and
     MODEL.REMAT off, 16 pairs of 480x640, seeded random weights) on
     synthetic pairs of 12
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
     plain version within 1e-5 of max |ref|; bf16 at the same eight shapes
     and at the JAX test's (B 2, P 300, 64 -> 256, with and without residual
     and ReLU), within one bf16 ulp of it (2^-7 |ref| + 1e-6), its bound at
     bf16 bytes and the dense bf16 tensor-core rate; both timed beside the
     unfused sequence the backbone runs without B4 in that dtype (cuDNN
     1x1 conv, then the ATen affine, add and ReLU); every f32 eval shape must
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
     the evaluation hook's ms (f32 and REMAT off, as phase 9);
 15. bf16 eval path: the eval step of inference_mp3d.yaml with
     MODEL.COMPUTE_DTYPE bfloat16 on phase 5's weights and batches,
     unfused and with the fused-tail backbone: output dtypes as the policy
     says (cameras and the refinement's hypotheses bf16, log-scores, plane
     parameters and scores f32), B1 and B2 once per batch and B4 24 times
     per fused batch; the card against the CPU at 96x128 at the bf16 rule of
     tests/test_torch_bf16_eval.py with the card's own bf16-vs-f32 deviation
     in place of JAX's; the bf16 eval steps timed against phase 5's and 12's
     f32 ones in alternating rounds;
 16. bf16 train path: configs/train_mp3d_step3.yaml as shipped (bf16 compute
     and block interiors, REMAT on) on phase 9's batches, a warm-up and 3
     steps: every loss finite, no skipped step, B3 3 f32-logit launches per
     step and no bf16-logit one (the model sends f32 logits), B1 and B2
     none; ms per step and peak memory, then again with REMAT off,
     beside phase 9's f32 step; then one step of one pair at 96x128 on the
     card against the CPU (both bf16, the CPU's Hungarian match injected
     into the card's step) at tests/test_torch_bf16_train.py's loss and
     gradient rules, with the card's own bf16-vs-f32 deviation in place of
     JAX's (for the losses, the larger of the card's and the CPU's).
 17. training and evaluation across ranks (`parallel/dist.py:launch`), after
     phase 14 with the parent's cached memory freed: A, one rank over NCCL,
     and B, two ranks over gloo on the one card (NCCL refuses two ranks on
     one device), each a `Trainer` from the same seeded weights (phase 9's
     config, dropout 0, BASE_LR 1e-7, queries pulled apart as in phase 10)
     on the same 16 synthetic pairs of 480x640 with 12 planes per view (8 +
     8 in B, each rank making its own from per-pair seeds) and the same AIM
     poses split per rank: a warm-up step and 2 steps, then `Trainer.test`
     over 16 pairs (8 per rank in B, gathered). B is held to A at phase
     10's limits on the global values (every loss of every step, the
     gradient norm, the parameters after the steps), the BN statistics
     within 5e-5 and equal on B's ranks, the parameters bit-equal on B's
     ranks, the evaluation at phase 13's (keys equal, AP, matching and
     camera accuracies equal, camera errors within 1e-3; the plane
     parameters' errors printed); each rank's B3 at 3 launches per step and
     B1/B2 at one per evaluation batch, no skipped step, continuous.pkl
     written once with 16 pairs. Prints each launch's ms/step, peak memory
     per rank, the gradient all-reduce's ms and MiB, and B's evaluation
     pairs/s: two processes sharing one card over host-staged gloo, not a
     scaling figure. Each launch has a timeout; a rank that fails or hangs
     fails the phase.
Phases 11-13 and 15 run right after phase 7, while the eval model is on the
card; phases 14 and 16 run after phase 10, phase 17 after phase 14.
Phases 6, 7 and 12 hold the card to the CPU, or the fused path to the
unfused one, as the CPU is held to JAX in tests/test_torch_slice.py: valid
planes equal, labels agree on >= 99.9% of pixels, log-scores within 1.5e-3
and every camera within 1e-3; phase 10 does the same with the tolerances of
tests/test_torch_train.py.
Then one JSON line with every kernel's launches, error and times, and, last,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The launches of B1 and B2 are those of the eval path (phase 5), those of B3
those of the train path (phase 9), those of B4 those of the fused-tail eval
path (phase 12); phases 13-16 check their own. B4's times are per eval
batch: the sum over its 24 calls. The entries of B3 and B4 carry a "bf16"
object with the same keys for their bf16 variant (B4's launches those of
phase 15's fused path, B3's the bf16-logit launches counted apart in
phase 16's REMAT-on run, where the model sends f32 logits and phase 16
requires 0).

Kernel times are CUDA-event means over many warm launches. `bound_ms` is the
larger of bytes moved / 3.35 TB/s and operations / the peak rate of their
type: 67 TFLOP/s f32, 989 TFLOP/s dense bf16 on the tensor cores (H100 SXM
published peaks).

    python3 chip_smoke.py --time-tree DIR

times B1 and B2 of the port in DIR (a checkout of any of its commits, e.g. a
parent unpacked with `git archive`) on phase 3's and 4's inputs, through the
functions the eval path calls, with this script's timing code, and prints
one JSON line; run it for a parent and a change in turns in one call.

    python3 chip_smoke.py --ranks N

runs phases 1, 2 and 17 alone on a machine with N cards, with a launch C
of N ranks over NCCL, one per card, 16 / N pairs each, in B's place, held
to A as B is: the NCCL path across cards.
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
BF16_TC_FLOP_PER_S = 989e12
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
# losses held at their decoder levels' bf16 noise where their own lies under
# the floor (tests/test_torch_bf16_train.py:LEVEL_NOISE gives the reasons)
LEVEL_NOISE = ("loss_ce", "loss_param_cos")
ENTRY_PAIRS = 16
TRAINER_PAIRS = 32       # the training split of phase 14
TRAINER_TEST_PAIRS = 8   # its test split: two eval batches
TRAINER_STEPS = 4
TRAINER_HW = (480, 640)
TRAINER_SPLIT = "chip_smoke_trainer_test"
RANK_PAIRS = 16        # phase 17's global batch and evaluation split
RANK_STEPS = 3         # a warm-up step and 2 timed ones
RANK_TIMEOUT_S = 300   # per launch: a rank that fails or hangs fails the phase
BN_TOL = 5e-5          # tests/test_torch_train.py
CAM_TOL = 1e-3         # tests/test_torch_eval.py
CAMERA_ERRORS = ("T median err", "T mean err", "R median err", "R mean err")
PLANE_ERRORS = ("mean_normal", "median_normal", "mean_offset", "median_offset")


class SmokeFailure(Exception):
    pass


def bound_ms(n_bytes, n_ops, op_rate=F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / op_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x):
    """One bf16 ulp at magnitude x: 2^(e - 7) for 2^e <= x < 2^(e + 1); 0 at 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def launches_want(**counts):
    """The launch counts a run should leave: `counts` for the kernels named,
    0 for every other kernel of the port."""
    from nopesac_torch.utils.device import KERNEL_NAMES

    if not set(counts) <= set(KERNEL_NAMES):
        raise SmokeFailure(f"no such kernels: {sorted(set(counts) - set(KERNEL_NAMES))}")
    return {n: counts.get(n, 0) for n in KERNEL_NAMES}


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


def check_outputs(torch, out, b, h, w, nq, cam_dtype=None):
    """Shapes, dtypes and finiteness of the eval outputs; the cameras and the
    refinement's hypotheses in `cam_dtype` (MODEL.COMPUTE_DTYPE, default
    f32), the rest as under every policy."""
    cam_dtype = cam_dtype or torch.float32
    expect = {
        "view0.valid": ((b, nq), torch.bool), "view0.score": ((b, nq), torch.float32),
        "view0.params": ((b, nq, 3), torch.float32), "view0.seg_gated": ((b, h, w), torch.int8),
        "view0.centers": ((b, nq, 2), torch.float32),
        "log_scores": ((b, nq + 1, nq + 1), torch.float32),
        "assignment": ((b, nq, nq), torch.float32),
        "assignment_beforeRef": ((b, nq, nq), torch.float32),
        "num_matches": ((b,), torch.int32),
        "camera_onePP.rot": ((b, nq + 1, 4), cam_dtype),
        "camera_onePP.score_rot": ((b, nq + 1), cam_dtype),
        "camera_onePP.hyp_valid": ((b, nq + 1), torch.bool),
    }
    for cam in ("camera_zero", "camera_init", "camera_initRec", "camera_avgRef0",
                "camera_softRef0", "camera"):
        expect[f"cameras.{cam}.tran"] = ((b, 3), cam_dtype)
        expect[f"cameras.{cam}.rot"] = ((b, 4), cam_dtype)
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
    unit_tol = 1e-4 if cam_dtype == torch.float32 else 2.0 ** -6  # bf16 components
    for cam in ("camera", "camera_softRef0"):
        norm = out["cameras"][cam]["rot"].float().norm(dim=-1)
        if not bool(((norm - 1).abs() < unit_tol).all()):
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
    want = launches_want(select_maps=N_BATCHES, sinkhorn=N_BATCHES)
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
    bf16 = check_mask_loss_bf16(torch, src, masks, tgt, matched, weights, idx, grad3)
    common = {"route": "cuda", "source": "nopesac_torch/ops/csrc/mask_loss.cu",
              "library_ms": None}
    return [dict(common, name="mask_loss_fwd", replaces="nopesac_tpu/ops/mask_loss_pallas.py:199",
                 max_abs_err=sum_err, ms=ms_fwd, plain_ms=plain_fwd_ms, bound_ms=fwd_bms,
                 bound_by=fwd_by, bf16=bf16["fwd"]),
            dict(common, name="mask_loss_bwd", replaces="nopesac_tpu/ops/mask_loss_pallas.py:235",
                 max_abs_err=grad_err, ms=ms_bwd, plain_ms=plain_bwd_ms, bound_ms=bwd_bms,
                 bound_by=bwd_by, bf16=bf16["bwd"])]


def check_mask_loss_bf16(torch, src32, masks, tgt, matched, weights, idx, grad3):
    """Phase 8 with the logits rounded to bf16: kernel against the plain
    version on the same bf16 values (f32 sums, a bf16 d src), then timed."""
    from nopesac_torch.ops import mask_loss

    src = src32.to(torch.bfloat16)
    b, nq, h, w = src.shape

    def sums_and_grad(fn, m):
        x = src.clone().requires_grad_(True)
        sums = fn(x, masks, tgt, m)
        torch.autograd.backward(torch.stack(sums, dim=-1), weights)
        return torch.stack(sums, dim=-1).detach(), x.grad

    k_sums, k_grad = sums_and_grad(mask_loss.fused_focal_dice, matched)
    p_sums, p_grad = sums_and_grad(mask_loss.focal_dice_plain, matched)
    torch.cuda.synchronize()
    if k_grad.dtype != torch.bfloat16 or k_sums.dtype != torch.float32:
        raise SmokeFailure(f"B3 bf16: d src {k_grad.dtype}, sums {k_sums.dtype}")
    sum_rel = float(((k_sums - p_sums).abs() / p_sums.abs().clamp_min(1e-30))[matched].max())
    sum_err = float((k_sums - p_sums).abs().max())
    scale = float(p_grad.float().abs().max())
    grad_err = float((k_grad.float() - p_grad.float()).abs().max())
    zeros_ok = bool((k_sums[~matched] == 0).all()) and bool((k_grad[~matched] == 0).all())
    print(f"[B3 mask_loss] bf16 logits: sums max rel err {sum_rel:.3e}, d src max err "
          f"{grad_err:.3e} of max |d src| {scale:.3e} (one bf16 ulp: {BF16_ULP * scale:.3e}); "
          f"unmatched exact zeros: {zeros_ok}")
    if not (sum_rel <= 1e-4 and grad_err <= BF16_ULP * scale and zeros_ok):
        raise SmokeFailure("B3 kernel (bf16 logits) disagrees with its plain version")
    ms_fwd = cuda_ms(torch, lambda: mask_loss.mask_loss_fwd_cuda(src, masks, idx), iters=50)
    ms_bwd = cuda_ms(torch, lambda: mask_loss.mask_loss_bwd_cuda(src, masks, idx, grad3), iters=50)

    def plain_fwd():
        return mask_loss.focal_dice_plain(src.detach().requires_grad_(True), masks, tgt, matched)

    def plain_fwd_bwd():
        torch.autograd.backward(torch.stack(plain_fwd(), dim=-1), weights)

    plain_fwd_ms = cuda_ms(torch, plain_fwd, warm=2, iters=5)
    plain_bwd_ms = cuda_ms(torch, plain_fwd_bwd, warm=2, iters=5) - plain_fwd_ms
    n_m, n_px = int(matched.sum()), 16 * h * w
    read = n_m * (h * w * 2 + n_px) + b * nq * 4  # matched bf16 logits, masks, index
    fwd_bms, fwd_by = bound_ms(read + b * nq * 4 * 4, n_m * n_px * MASK_FWD_OPS)
    bwd_bms, bwd_by = bound_ms(read + b * nq * 3 * 4 + b * nq * h * w * 2,
                               n_m * n_px * MASK_BWD_OPS)
    print(f"[B3 mask_loss] bf16 logits: forward kernel {ms_fwd:.4f} ms (bound {fwd_bms:.4f} ms, "
          f"{fwd_by}), plain {plain_fwd_ms:.3f} ms; backward kernel {ms_bwd:.4f} ms (bound "
          f"{bwd_bms:.4f} ms, {bwd_by}), plain {plain_bwd_ms:.3f} ms")
    common = {"route": "cuda", "source": "nopesac_torch/ops/csrc/mask_loss.cu",
              "library_ms": None, "dtype": "bfloat16"}  # launches: phase 16's
    return {"fwd": dict(common, name="mask_loss_fwd", max_abs_err=sum_err, ms=ms_fwd,
                        plain_ms=plain_fwd_ms, bound_ms=fwd_bms, bound_by=fwd_by,
                        replaces="nopesac_tpu/ops/mask_loss_pallas.py:199"),
            "bwd": dict(common, name="mask_loss_bwd", max_abs_err=grad_err, ms=ms_bwd,
                        plain_ms=plain_bwd_ms, bound_ms=bwd_bms, bound_by=bwd_by,
                        replaces="nopesac_tpu/ops/mask_loss_pallas.py:235")}


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
# phases 9 and 14 train in f32 without REMAT, the settings of their earlier
# measurements (the port ignored MODEL.REMAT before it had the bf16 policy)
F32_TRAIN = ["MODEL.COMPUTE_DTYPE", "float32", "MODEL.BACKBONE_TRAIN_DTYPE", "float32",
             "MODEL.REMAT", "False"]


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


def timed_train_steps(torch, cfg, batches, card, what):
    """A fresh seeded model of `cfg`, a warm-up step on batches[0], then one
    timed step per further batch: every loss of the JAX train_forward
    present and finite, no skipped step, a finite positive gradient norm in
    each module, B3 at 3 launches per step and nothing else. Returns the
    launch counts, the mean ms per step and the peak allocated bytes of the
    timed steps."""
    from nopesac_torch.engine.train import TrainStep, build_train_model
    from nopesac_torch.utils.device import LAUNCHES

    model = build_train_model(cfg, device=batches[0]["image0"].device, seed=0)
    step = TrainStep(model, cfg, seed=0)
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
            raise SmokeFailure(f"train step {k} ({what}): loss keys differ from the JAX "
                               f"train_forward's: {sorted(set(losses) ^ set(TRAIN_LOSS_KEYS))}")
        bad = sorted(n for n, v in losses.items() if not math.isfinite(v))
        if bad or float(metrics["skipped_nonfinite"]) != 0.0:
            raise SmokeFailure(f"train step {k} ({what}): non-finite losses {bad}, skipped "
                               f"{float(metrics['skipped_nonfinite'])}")
        if not all(math.isfinite(v) and v > 0 for v in norms.values()):
            raise SmokeFailure(f"train step {k} ({what}): gradient norms per module {norms}")
        print(f"[train] {what} step {k}: total {float(metrics['total_loss']):.4f}, grad norm "
              f"{float(metrics['grad_norm']):.4f}, per module "
              f"{ {m: round(v, 4) for m, v in norms.items()} }, {times[k] * 1e3:.1f} ms")
    ms = statistics.mean(times) * 1e3
    print(f"[train] {what}: {ms:.2f} ms/step of {TRAIN_PAIRS} pairs at 480x640, "
          f"{TRAIN_PAIRS / ms * 1e3:.2f} pairs/s, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) on {card}; launches {counts}")
    # the model sends B3 f32 logits under every policy: no bf16-logit launch
    want = launches_want(mask_loss_fwd=3 * TRAIN_STEPS, mask_loss_bwd=3 * TRAIN_STEPS)
    if counts != want:
        raise SmokeFailure(f"train path ({what}) launches {counts}, want {want}")
    del model, step
    torch.cuda.empty_cache()
    return counts, ms, peak


def run_train_path(torch, dev, card):
    from nopesac_torch.engine.train import synthetic_batches

    cfg = load_train_cfg(TRAIN_CONFIG, F32_TRAIN + [
        "SOLVER.IMS_PER_BATCH", str(TRAIN_PAIRS), "INPUT.IMAGE_SIZE", "(480, 640)"])
    t0 = time.perf_counter()
    batches = list(synthetic_batches(cfg, TRAIN_STEPS + 1, seed=1, n_planes=TRAIN_PLANES,
                                     device=dev))
    torch.cuda.synchronize()
    print(f"[train] {TRAIN_STEPS + 1} batches of {TRAIN_PAIRS} pairs ({TRAIN_PLANES} planes per "
          f"view) built in {time.perf_counter() - t0:.2f} s")
    counts, ms, peak = timed_train_steps(torch, cfg, batches, card, "f32, REMAT off")
    return counts, ms, peak, batches


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


def run_bf16_train_path(torch, dev, card, batches, f32_ms, f32_peak):
    """Phase 16: train_mp3d_step3.yaml as shipped (bf16 keys, REMAT on) on
    phase 9's batches, then the same with REMAT off."""
    size = ["SOLVER.IMS_PER_BATCH", str(TRAIN_PAIRS), "INPUT.IMAGE_SIZE", "(480, 640)"]
    cfg = load_train_cfg(TRAIN_CONFIG, size)
    m = cfg.MODEL
    if (m.COMPUTE_DTYPE, m.BACKBONE_TRAIN_DTYPE, m.FPN_TRAIN_DTYPE, m.REMAT) != (
            "bfloat16", "bfloat16", "float32", True):
        raise SmokeFailure("train_mp3d_step3.yaml no longer ships the bf16 policy with REMAT")
    counts, ms, peak = timed_train_steps(torch, cfg, batches, card, "bf16, REMAT on")
    cfg_off = load_train_cfg(TRAIN_CONFIG, size + ["MODEL.REMAT", "False"])
    _, ms_off, peak_off = timed_train_steps(torch, cfg_off, batches, card, "bf16, REMAT off")
    print(f"[train bf16] ms/step: bf16 REMAT on {ms:.2f}, bf16 REMAT off {ms_off:.2f}, f32 REMAT "
          f"off (phase 9) {f32_ms:.2f}; peak memory GiB: {peak / 2**30:.2f}, "
          f"{peak_off / 2**30:.2f}, {f32_peak / 2**30:.2f}; {TRAIN_PAIRS} pairs at 480x640 on "
          f"{card}")
    return counts


def train_grads(torch, model, batch, aim, matches=None, capture=None):
    """One train_forward and backward: the losses as floats, their dtypes and
    each module's gradient as one f64 host vector. `matches` replace the
    Hungarian solve; `capture` (a list) receives the solve's result."""
    from nopesac_torch.models import nopesac

    solve = nopesac.match_planes_multi

    def patched(*args):
        if matches is not None:
            return [m.to(args[1]["gt_valid"].device) for m in matches]
        out = solve(*args)
        if capture is not None:
            capture.extend(o.cpu() for o in out)
        return out

    nopesac.match_planes_multi = patched
    try:
        losses = model.train_forward(batch, None, *aim)
        torch.stack([v.float() for v in losses.values()]).sum().backward()
    finally:
        nopesac.match_planes_multi = solve
    grads = {}
    for mod in TRAIN_MODULES:
        grads[mod] = torch.cat([p.grad.detach().reshape(-1).double().cpu()
                                for n, p in model.named_parameters()
                                if n.startswith(mod) and p.grad is not None])
    return ({k: float(v.detach()) for k, v in losses.items()}, {k: v.dtype for k, v in losses.items()},
            grads)


def check_bf16_train_reference(torch, dev):
    """Phase 16's reference: one step of one pair at 96x128 of
    train_mp3d_step3.yaml, bf16 on the CPU (its Hungarian match captured)
    and in f32, and on the card in bf16 and f32 with that match injected:
    each loss by tests/test_torch_bf16_train.py's loss rule with the larger
    of the card's and the CPU's own bf16-vs-f32 deviations in place of
    JAX's (neither side is the reference: a loss of a few numbers can land
    near its f32 value on one of them), the rounding ratio against the
    card's; each module's gradient by the gradient rule with the card's
    own deviation."""
    from nopesac_torch.engine.train import build_train_model, synthetic_batches
    from nopesac_torch.losses import camera_losses
    from nopesac_torch.models.nopesac import AIM_RAND_POSES

    base = ["MODEL.SEM_SEG_HEAD.DROPOUT", "0.0", "SOLVER.IMS_PER_BATCH", "1",
            "INPUT.IMAGE_SIZE", "(96, 128)", "MODEL.WEIGHTS", ""]
    cfg16 = load_train_cfg(TRAIN_CONFIG, base)
    cfg32 = load_train_cfg(TRAIN_CONFIG, base + F32_TRAIN[:4])
    cpu = build_train_model(cfg16, device="cpu", seed=0)
    separate_queries(torch, cpu, seed=1)
    batch = next(iter(synthetic_batches(cfg16, 1, seed=5, n_planes=6, device="cpu")))
    card_batch = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                      else v.to(dev)) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    aim = [camera_losses.rand_aim_rot(gen, AIM_RAND_POSES), camera_losses.rand_aim_trans(
        gen, AIM_RAND_POSES)]
    matches = []
    ref, ref_dt, ref_g = train_grads(torch, cpu, batch, aim, capture=matches)
    cpu32 = build_train_model(cfg32, device="cpu")
    cpu32.load_state_dict(cpu.state_dict())
    ref32 = train_grads(torch, cpu32, batch, aim, matches)[0]
    del cpu32
    runs = {}
    for name, cfg in (("bf16", cfg16), ("f32", cfg32)):
        model = build_train_model(cfg, device=dev)
        model.load_state_dict(cpu.state_dict())
        runs[name] = train_grads(torch, model, card_batch, [a.to(dev) for a in aim], matches)
        del model
    (got, got_dt, got_g), (own, _, own_g) = runs["bf16"], runs["f32"]
    if got_dt != ref_dt:
        raise SmokeFailure("bf16 train reference: the losses' dtypes differ between card and CPU")
    rel, bad, ratios = {}, {}, {}
    for k in ref:
        scale = max(abs(own[k]), 1e-30)
        rel[k] = (abs(got[k] - ref[k]) / scale, abs(got[k] - own[k]) / scale,
                  abs(ref[k] - ref32[k]) / scale, bf16_ulp(scale) / scale)
    for k, (err, d_card, d_cpu, ulp) in rel.items():
        # both sides are the port, each with its own bf16 draw: the larger bounds
        noise = max(d_card, d_cpu)
        floor = max(1e-3, ulp) if ref_dt[k] == torch.bfloat16 else 1e-3
        if k in LEVEL_NOISE and noise < floor:  # as tests/test_torch_bf16_train.py
            noise = max(max(rel[f][1:3]) for f in (k, f"{k}_0", f"{k}_1") if f in rel)
        if not err <= max(1.5 * noise, floor):
            bad[k] = (err, noise, floor)
    for k, (_, d_card, d_cpu, ulp) in rel.items():
        if d_card > ulp / 2:
            ratios[k] = d_cpu / d_card
            if not 0.25 <= ratios[k] <= 4.0:
                bad[k] = ("rounding", d_cpu, d_card)
    if bad or not ratios:
        raise SmokeFailure(f"bf16 train reference, losses card vs CPU (err, the larger own bf16 "
                           f"noise, floor): {bad}; all (err, card noise, CPU noise, ulp): {rel}")
    worst = max(rel.items(), key=lambda kv: kv[1][0])
    grad = {}
    for mod in TRAIN_MODULES:
        rel = float((got_g[mod] - ref_g[mod]).norm() / ref_g[mod].norm())
        gap = float((got_g[mod] - own_g[mod]).norm() / own_g[mod].norm())
        grad[mod] = (rel, gap)
        if not rel <= max(2 * gap, 1e-2):
            raise SmokeFailure(f"bf16 train reference: {mod} gradient card vs CPU {rel:.3e}, "
                               f"the card's own bf16-vs-f32 gap {gap:.3e}")
    print(f"[train bf16 reference 96x128] card vs CPU (bf16, the CPU's match injected): worst "
          f"relative loss difference {worst[0]} (err, the card's own noise, the CPU's, one ulp) "
          f"{worst[1]}; the CPU's over the card's bf16 deviation where above half an ulp "
          f"{ {k: round(v, 3) for k, v in ratios.items()} }; per module gradient relative "
          f"difference and the card's own bf16-vs-f32 gap {grad}")


def trainer_cfg(path, out_dir, opts=()):
    """A curriculum config in f32 without REMAT at 480x640 with 16 pairs per step, seeded
    weights unless `opts` name MODEL.WEIGHTS, and phase 14's loop settings."""
    return load_train_cfg(path, F32_TRAIN + [
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
    want = launches_want(mask_loss_fwd=3 * TRAINER_STEPS, mask_loss_bwd=3 * TRAINER_STEPS,
                         select_maps=n_eval, sinkhorn=n_eval)
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


def rank_cfg(out_dir):
    """Phase 17's config: phase 9's (train_mp3d_step3.yaml, f32, REMAT off,
    16 pairs of 480x640) with dropout 0, seeded weights, the evaluation
    artifacts on and BASE_LR 1e-7. AdamW's first updates are about lr *
    sign(g), and where a gradient entry sits at the rounding noise its sign
    differs between A and B (tests/test_torch_trainer.py:LOOP_OPTS); at
    1e-6 the pose head's initial rotations moved by up to 6e-2 per step and
    A's and B's by 3e-2 apart after two, which carried one pair's across
    w = 0, where the AIM auto-encoder's input flips its sign
    (loss_rot_initCamRec 8% apart at the third step; NVIDIA H100 80GB HBM3,
    700 W). Each step moves them ten times less at 1e-7."""
    return load_train_cfg(TRAIN_CONFIG, F32_TRAIN + [
        "SOLVER.IMS_PER_BATCH", str(RANK_PAIRS), "INPUT.IMAGE_SIZE", "(480, 640)",
        "MODEL.SEM_SEG_HEAD.DROPOUT", "0.0", "MODEL.WEIGHTS", "", "SOLVER.BASE_LR", "1e-7",
        "TEST.EVAL_FULL_SCENE", "True",
        "OUTPUT_DIR", out_dir])


def rank_batch(cfg, lo, hi, dev):
    """Pairs lo..hi-1 of phase 17's global batch (phase 9's generator, 12
    planes per view), each from a seed of its own, so that a rank makes only
    its own pairs."""
    import numpy as np

    from nopesac_torch.data.mapper import PairMapper, collate
    from nopesac_torch.data.packing import batch_to_device
    from nopesac_torch.data.synthetic import make_pair

    h, w = cfg.INPUT.IMAGE_SIZE
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, (h, w), cfg.MODEL.PIXEL_MEAN,
                        cfg.MODEL.PIXEL_STD)
    pairs = [make_pair(np.random.default_rng([17, i]), n_planes=TRAIN_PLANES, h=h, w=w,
                       pair_id=i) for i in range(lo, hi)]
    return batch_to_device(collate([mapper(p) for p in pairs]), dev)


def ranks_rank(out_dir):
    """One rank of phase 17 (spawned by `parallel/dist.py:launch`): a
    `Trainer` from the seeded weights (queries pulled apart as in phase 10),
    this rank's share of the 16 pairs and of the AIM random poses, a warm-up
    step and 2 timed ones of its `TrainStep`, the gradient all-reduce timed
    on its own, then `Trainer.test` over 16 synthetic pairs. Returns what
    the parent holds the launches to."""
    import hashlib

    import torch
    import torch.distributed as tdist

    from nopesac_torch.data.synthetic import make_dataset
    from nopesac_torch.engine.train import reduce_gradients
    from nopesac_torch.engine.trainer import Trainer
    from nopesac_torch.losses import camera_losses
    from nopesac_torch.models.layers import BatchNorm2d
    from nopesac_torch.models.nopesac import AIM_RAND_POSES
    from nopesac_torch.parallel.dist import rank, world_size
    from nopesac_torch.utils.device import LAUNCHES, set_f32_parity

    set_f32_parity()
    r, world = rank(), world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    if tdist.get_backend() == "nccl":  # the group's own collective, at any world size
        one = torch.ones(1, device=dev)
        tdist.all_reduce(one)
        if float(one) != world:
            raise RuntimeError(f"NCCL all-reduce of ones gave {float(one)} on {world} ranks")
    cfg = rank_cfg(out_dir)
    trainer = Trainer(cfg, device=dev)
    separate_queries(torch, trainer.model, seed=1)
    t0 = time.perf_counter()
    per = RANK_PAIRS // world
    batch = rank_batch(cfg, r * per, (r + 1) * per, dev)
    gen = torch.Generator().manual_seed(3)
    n_aim = RANK_PAIRS * max(AIM_RAND_POSES // RANK_PAIRS, 1)
    k = n_aim // world
    aim = [a[r * k:(r + 1) * k].to(dev) for a in (camera_losses.rand_aim_rot(gen, n_aim),
                                                 camera_losses.rand_aim_trans(gen, n_aim))]
    data_s = time.perf_counter() - t0
    step = trainer.train_step
    LAUNCHES.reset()
    metrics, times = [], []
    for i in range(RANK_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row = step(batch, *aim)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({name: float(v) for name, v in row.items()})
    train_counts = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    n_bytes = reduce_gradients(step.params)  # the last step's gradients once more
    torch.cuda.synchronize()
    reduce_s = time.perf_counter() - t0
    del batch
    test_pairs = make_dataset(n_pairs=RANK_PAIRS, n_planes=TRAIN_PLANES, seed=23,
                              h=cfg.INPUT.IMAGE_SIZE[0], w=cfg.INPUT.IMAGE_SIZE[1])
    LAUNCHES.reset()
    results = trainer.test(test_pairs)
    eval_counts = LAUNCHES.snapshot()
    trainer.close()
    params = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()]).cpu()
    out = {"rank": r, "world": world, "backend": tdist.get_backend(), "metrics": metrics,
           "step_ms": statistics.mean(times[1:]) * 1e3, "peak": peak,
           "reduce_ms": reduce_s * 1e3, "reduce_mb": n_bytes / 2**20, "data_s": data_s,
           "train_counts": train_counts, "eval_counts": eval_counts,
           "results": {name: float(v) for name, v in results.items()},
           "eval_stats": trainer.last_eval_stats,
           "bn": {n: (m.running_mean.cpu(), m.running_var.cpu())
                  for n, m in trainer.model.named_modules() if isinstance(m, BatchNorm2d)},
           "params_digest": hashlib.sha256(params.numpy().tobytes()).hexdigest()}
    if r == 0:
        out["params"] = params
    return out


def launch_ranks(torch, card, what, n, backend):
    """One launch of phase 17: `n` ranks of `ranks_rank` over `backend`,
    their times printed and their launch counts, skip guard and artifacts
    checked. Returns the ranks' results."""
    import pickle
    import shutil

    from nopesac_torch.parallel.dist import launch

    out_dir = os.path.join(REPO, "output", f"ranks_{what}")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        ranks = launch(ranks_rank, n, device="cuda", backend=backend, args=(out_dir,),
                       timeout_s=RANK_TIMEOUT_S)
    except Exception as e:  # a rank that raised, exited or hung
        raise SmokeFailure(f"ranks {what}: the launch failed: {e!r}")
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "continuous.pkl"), "rb") as f:
        n_art = len(pickle.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    lead = ranks[0]
    reduce = (f"gradient all-reduce {lead['reduce_ms']:.2f} ms for {lead['reduce_mb']:.1f} MiB"
              if n > 1 else "gradient all-reduce: none at world size 1")
    print(f"[ranks] {what}: {n} rank(s) over {lead['backend']} on "
          f"{min(n, torch.cuda.device_count())} card(s), {RANK_PAIRS // n} pairs of 480x640 per "
          f"rank: {[round(x['step_ms'], 2) for x in ranks]} ms/step (steps 2-3), peak memory per "
          f"rank {[round(x['peak'] / 2**30, 2) for x in ranks]} GiB, {reduce}; evaluation of "
          f"{RANK_PAIRS} pairs {lead['eval_stats']}; launch {wall:.1f} s (pairs made in "
          f"{[round(x['data_s'], 1) for x in ranks]} s); on {card}")
    train_want = launches_want(mask_loss_fwd=3 * RANK_STEPS, mask_loss_bwd=3 * RANK_STEPS)
    n_eval = RANK_PAIRS // n // N_PAIRS
    eval_want = launches_want(select_maps=n_eval, sinkhorn=n_eval)
    for x in ranks:
        if x["train_counts"] != train_want or x["eval_counts"] != eval_want:
            raise SmokeFailure(f"ranks {what}: rank {x['rank']} launches {x['train_counts']} "
                               f"in training, {x['eval_counts']} in evaluation; want "
                               f"{train_want}, {eval_want}")
        if any(m["skipped_nonfinite"] for m in x["metrics"]):
            raise SmokeFailure(f"ranks {what}: rank {x['rank']} skipped a step")
    if n_art != RANK_PAIRS:
        raise SmokeFailure(f"ranks {what}: continuous.pkl holds {n_art} pairs")
    return ranks


def hold_ranks(torch, a, ranks, what):
    """Phase 17's checks of a multi-rank launch against A's one rank: its
    ranks equal to each other (losses, parameters bit for bit, BN
    statistics, metrics), rank 0 within phase 10's limits of A (every loss
    of every step, the gradient norm, the parameters), the BN statistics
    within 5e-5, the evaluation within phase 13's."""
    lead, others = ranks[0], ranks[1:]
    bad, worst = {}, 0.0
    for i in range(RANK_STEPS):
        ref, got = a["metrics"][i], lead["metrics"][i]
        if any(x["metrics"][i] != got for x in others):
            raise SmokeFailure(f"ranks {what}: the ranks logged different losses at step {i}")
        for key, v in ref.items():
            if key in ("grad_norm", "skipped_nonfinite"):
                continue
            worst = max(worst, abs(got[key] - v) / max(LOSS_ABS, LOSS_REL * abs(v)))
            if not abs(got[key] - v) <= max(LOSS_ABS, LOSS_REL * abs(v)):
                bad[f"{key}@{i}"] = (got[key], v)
    gn_rel = max(abs(lead["metrics"][i]["grad_norm"] - a["metrics"][i]["grad_norm"])
                 / a["metrics"][i]["grad_norm"] for i in range(RANK_STEPS))
    param_rel = float((lead["params"] - a["params"]).double().norm()
                      / a["params"].double().norm())
    params_equal = all(x["params_digest"] == lead["params_digest"] for x in others)
    bn_worst = max(float(((got - ref).abs() / (BN_TOL + BN_TOL * ref.abs())).max())
                   for name in a["bn"] for ref, got in zip(a["bn"][name], lead["bn"][name]))
    bn_equal = all(torch.equal(y, z) for x in others for name in lead["bn"]
                   for y, z in zip(x["bn"][name], lead["bn"][name]))
    ra, rb = a["results"], lead["results"]
    if list(ra) != list(rb) or any(x["results"] != rb for x in others):
        raise SmokeFailure(f"ranks {what}: the evaluation's metric keys differ from A's "
                           f"({sorted(set(ra) ^ set(rb))}) or the ranks disagree")
    ev_bad, plane_diff = {}, {}
    for key, v in ra.items():
        if key in PLANE_ERRORS or key.startswith(("%normal", "%offset")):
            plane_diff[key] = rb[key] - v  # plane parameter errors: reported, not held
        elif key in CAMERA_ERRORS:
            if not abs(rb[key] - v) <= CAM_TOL:
                ev_bad[key] = (rb[key], v)
        elif rb[key] != v:  # AP, matching and the camera accuracies
            ev_bad[key] = (rb[key], v)
    print(f"[ranks] {what} against A over {RANK_STEPS} steps: {len(bad)} losses outside max(1e-4, "
          f"1e-3 rel) (worst at {worst:.3f} of it), grad norm rel {gn_rel:.2e}, parameters rel "
          f"{param_rel:.2e}, BN statistics at {bn_worst:.3f} of 5e-5; on {what}'s ranks the BN "
          f"statistics {'equal' if bn_equal else 'DIFFERENT'} and the parameters "
          f"{'bit-equal' if params_equal else 'DIFFERENT'}; evaluation: {len(ra)} metrics, "
          f"{len(ev_bad)} outside phase 13's limits, plane parameter errors {what} - A "
          f"{ {k: round(d, 4) for k, d in plane_diff.items()} }")
    if (bad or gn_rel > 1e-3 or param_rel > 1e-5 or bn_worst > 1 or not bn_equal
            or not params_equal or ev_bad):
        raise SmokeFailure(f"ranks: {what} disagrees with A: losses {bad}, evaluation {ev_bad}")


def run_ranks(torch, card, nccl_ranks=0):
    """Phase 17: training and evaluation across ranks through
    `parallel/dist.py:launch`, A (one rank over NCCL) and B (two ranks over
    gloo on the one card), B held to A; with `nccl_ranks`, C in B's place:
    that many ranks over NCCL, one per card."""
    torch.cuda.empty_cache()
    a = launch_ranks(torch, card, "A", 1, "nccl")[0]
    if nccl_ranks:
        hold_ranks(torch, a, launch_ranks(torch, card, "C", nccl_ranks, "nccl"), "C")
        return
    b = launch_ranks(torch, card, "B", 2, "gloo")
    print(f"[ranks] B's times are two processes sharing one card over host-staged gloo, not a "
          f"scaling figure; evaluation {b[0]['eval_stats']['pairs_per_sec']} pairs/s")
    hold_ranks(torch, a, b, "B")


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
    bf16 = check_bottleneck_bf16(torch, dev, card)
    # bf16 at the JAX test's shape (P 300, not a multiple of the 128-pixel
    # tile), with and without residual and ReLU; within one bf16 ulp
    bf16_rel = bf16["max_diff_over_limit"]
    for bb, cin, co, h, w, residual, relu in ((2, 64, 256, 15, 20, True, True),
                                              (2, 64, 256, 15, 20, False, False)):
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
            "bf16_max_diff_over_limit": bf16_rel, "per_shape": rows,
            "bf16": {k: v for k, v in bf16.items() if k != "max_diff_over_limit"}}


def check_bottleneck_bf16(torch, dev, card):
    """B4 in bf16 at the eight eval shapes: within one bf16 ulp of its plain
    version (2^-7 |ref| + 1e-6), timed beside the bf16 sequence the unfused
    backbone runs (cuDNN 1x1 conv, then the ATen affine, add and ReLU), its
    bound at bf16 bytes and the dense bf16 tensor-core rate."""
    from nopesac_torch.ops import bottleneck

    F = torch.nn.functional
    bf = torch.bfloat16
    b = 2 * N_PAIRS
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "unfused_ms": 0.0}
    by_count = {"bytes": 0, "operations": 0}
    worst, worst_ulps, rows = 0.0, 0.0, []
    for stage, h, w, cout, mid, n_blocks in B4_STAGES:
        for cin, co, residual in ((cout, mid, False), (mid, cout, True)):
            x, wt, scale, shift, res = b4_inputs(torch, dev, 200 + len(rows), b, cin, co, h, w,
                                                 residual, bf)
            got = bottleneck.conv1x1_bn_act_cuda(x, wt, scale, shift, residual=res)
            cfg = dict(bottleneck.last_config)
            ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res)
            torch.cuda.synchronize()
            diff, lim = (got.float() - ref.float()).abs(), BF16_ULP * ref.float().abs() + 1e-6
            over, ulps = int((diff > lim).sum()), float((diff / lim).max())
            worst, worst_ulps = max(worst, float(diff.max())), max(worst_ulps, ulps)
            if over:
                raise SmokeFailure(f"B4 kernel (bf16) disagrees with its plain version at {stage} "
                                   f"{cin}->{co}: {over} outside one bf16 ulp")
            w16, s16, t16 = wt.to(bf), scale.to(bf)[None, :, None, None], shift.to(bf)[
                None, :, None, None]

            def unfused():  # the bf16 backbone without B4: ConvNorm, then add and ReLU
                y = F.conv2d(x, w16) * s16 + t16
                return F.relu(y + res) if residual else F.relu(y)

            ms = cuda_ms(torch, lambda: bottleneck.conv1x1_bn_act_cuda(
                x, wt, scale, shift, residual=res), iters=20)
            plain_ms = cuda_ms(torch, lambda: bottleneck.conv1x1_bn_act_plain(
                x, wt, scale, shift, residual=res), warm=2, iters=5)
            unfused_ms = cuda_ms(torch, unfused, iters=20)
            bms, by = bound_ms(*b4_cost(b, cin, co, h * w, residual, elem=2), BF16_TC_FLOP_PER_S)
            rows.append({"shape": f"{stage} {cin}->{co}{' +res' if residual else ''}",
                         "ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                         "bound_ms": bms, "bound_by": by, "max_ulps": ulps,
                         "variant": cfg["variant"]})
            print(f"[B4 bottleneck_tail] bf16 {rows[-1]['shape']} (x{n_blocks} per batch): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, unfused cuDNN+ATen {unfused_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by}); max |diff| / (2^-7 |ref| + 1e-6) {ulps:.3f}; "
                  f"variant {cfg['variant']}, {cfg['blocks']} blocks")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("unfused_ms", unfused_ms),
                           ("bound_ms", bms)):
                total[key] += n_blocks * v
            by_count[by] += n_blocks
            del x, wt, res, got, ref
    by = "bytes" if by_count["bytes"] > by_count["operations"] else "operations"
    print(f"[B4 bottleneck_tail] bf16 per eval batch ({B4_LAUNCHES} calls): kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, unfused cuDNN+ATen "
          f"{total['unfused_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, on {card}")
    return {"name": "bottleneck_tail", "route": "cuda", "dtype": "bfloat16",
            "source": "nopesac_torch/ops/csrc/bottleneck.cu",
            "replaces": "nopesac_tpu/ops/bottleneck_pallas.py:88", "max_abs_err": worst,
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": by, "library_ms": None, "unfused_ms": total["unfused_ms"],
            "launches": 0, "per_shape": rows, "max_diff_over_limit": worst_ulps}


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
        want = launches_want(select_maps=N_BATCHES, sinkhorn=N_BATCHES,
                             bottleneck_tail=B4_LAUNCHES * N_BATCHES)
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


def run_bf16_eval_path(torch, dev, model, fused, batches, card):
    """Phase 15: the eval step with MODEL.COMPUTE_DTYPE bfloat16 on phase 5's
    weights and batches, unfused and fused; returns the fused path's
    launch counts."""
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_cfg()
    cfg.MODEL.COMPUTE_DTYPE = "bfloat16"
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    steps = {}
    for name, fuse in (("unfused", False), ("fused", True)):
        m16 = build_model_from_cfg(cfg, device=dev, fuse_tail=fuse)
        m16.load_state_dict(model.state_dict(), strict=True)
        step = make_eval_step(m16, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        with torch.inference_mode():
            step(*batches[0])  # warm-up
            torch.cuda.synchronize()
            LAUNCHES.reset()
            t0 = time.perf_counter()
            outs16 = [step(*pair) for pair in batches[1:]]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = LAUNCHES.snapshot()
        want = launches_want(select_maps=N_BATCHES, sinkhorn=N_BATCHES,
                             bottleneck_tail=B4_LAUNCHES * N_BATCHES if fuse else 0)
        print(f"[bf16 eval] {name}: {secs / N_BATCHES * 1e3:.2f} ms/batch of {N_PAIRS} pairs "
              f"(wall), launches {counts}")
        if counts != want:
            raise SmokeFailure(f"bf16 eval path ({name}) launches {counts}, want {want}")
        for o in outs16:
            check_outputs(torch, o, N_PAIRS, h, w, nq, cam_dtype=torch.bfloat16)
        steps[name] = step
    f32 = {"unfused": make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD),
           "fused": make_eval_step(fused, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)}
    order = [("f32", "unfused"), ("bf16", "unfused"), ("f32", "fused"), ("bf16", "fused")]
    fns = [(lambda s=(f32 if dt == "f32" else steps)[k]: s(*batches[1])) for dt, k in order]
    with torch.inference_mode():
        times = alternating_ms(torch, fns)
    print("[bf16 eval] eval step, median (min-max) ms per batch of {} pairs over 10 alternating "
          "rounds on {}: ".format(N_PAIRS, card) + ", ".join(
              "{} {} {:.2f} ({:.2f}-{:.2f})".format(dt, k, *t) for (dt, k), t in zip(order, times)))
    check_bf16_small_reference(torch, dev)
    return counts


def check_bf16_small_reference(torch, dev):
    """The bf16 eval step at 96x128 on the card against the CPU, by the rule
    of tests/test_torch_bf16_eval.py with the card's own bf16-vs-f32
    deviation in place of JAX's."""
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step, synthetic_pairs

    images = synthetic_pairs(2, 96, 128, seed=7, device="cpu")
    outs = {}
    for d in ("cpu", dev):
        for dt in ("float32", "bfloat16"):
            cfg = load_cfg((96, 128))
            cfg.MODEL.COMPUTE_DTYPE = dt
            model = build_model_from_cfg(cfg, device=d, seed=0)
            out = make_eval_step(model, 96, 128, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)(*images)
            outs[(str(d), dt)] = flat_tree(to_host(out))
    card = str(dev)
    c32, c16, p32, p16 = (outs[(card, "float32")], outs[(card, "bfloat16")],
                          outs[("cpu", "float32")], outs[("cpu", "bfloat16")])
    for key in ("view0.valid", "view1.valid", "num_matches"):
        if not torch.equal(c16[key], p16[key]):
            raise SmokeFailure(f"bf16 reference 96x128: {key} differs between card and CPU")
    errs, ratios = {}, {}
    for key in [k for k in c16 if k.startswith("cameras.")] + ["log_scores"]:
        keep = p32[key].abs() < 1e4
        a16, a32, b16, b32 = (t.float()[keep] for t in (c16[key], c32[key], p16[key], p32[key]))
        u = bf16_ulp(float(b32.abs().max()))
        d_card = float((a16 - a32).abs().max())
        err = float((a16 - b16).abs().max())
        if not err <= max(1.5 * d_card, u):
            raise SmokeFailure(f"bf16 reference 96x128: {key} card vs CPU {err:.3e}, the card's "
                               f"own bf16 deviation {d_card:.3e}, one ulp {u:.3e}")
        errs[key] = err
        if d_card > u / 2:  # beyond one final rounding: the CPU must round as the card does
            ratios[key] = float((b16 - b32).abs().max()) / d_card
            if not 0.25 <= ratios[key] <= 4.0:
                raise SmokeFailure(f"bf16 reference 96x128: {key}: the CPU's bf16 deviation is "
                                   f"{ratios[key]:.2f} times the card's")
    if not ratios:
        raise SmokeFailure("bf16 reference 96x128: no output with the card's bf16 deviation "
                           "above half an ulp: the rounding check held nothing")
    labels = {}
    for view in ("view0", "view1"):
        k = f"{view}.seg_gated"
        ours = float((c16[k] != p16[k]).float().mean())
        own = float((c16[k] != c32[k]).float().mean())
        labels[view] = (ours, own)
        if ours > 2 * own + 0.005:
            raise SmokeFailure(f"bf16 reference 96x128: {view} labels disagree on {ours:.4f} of "
                               f"pixels, the card's own bf16 disagreement {own:.4f}")
    print(f"[bf16 eval reference 96x128] card vs CPU: worst camera/log-score difference "
          f"{max(errs.values()):.3e}; the CPU's over the card's own bf16 deviation per output "
          f"{ {k: round(v, 3) for k, v in ratios.items()} }; labels (card vs CPU, card bf16 vs "
          f"f32) {labels}")


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


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
    want = launches_want(select_maps=n_batches, sinkhorn=n_batches,
                         bottleneck_tail=B4_LAUNCHES * n_batches)
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
    ap.add_argument("--ranks", type=int, default=0, metavar="N",
                    help="only phases 1, 2 and 17, with N ranks over NCCL, one per card, "
                         "in place of the two over gloo (see above)")
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
    if args.ranks:
        try:
            name, card = phase_device(torch)
            if torch.cuda.device_count() < args.ranks:
                raise SmokeFailure(f"--ranks {args.ranks}: {torch.cuda.device_count()} card(s)")
            phase_build()
            run_ranks(torch, card, nccl_ranks=args.ranks)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}))
        return 0
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
        bf16_counts = run_bf16_eval_path(torch, dev, model, fused, batches, card)
        b4["bf16"]["launches"] = bf16_counts["bottleneck_tail"]
        del model, fused, batches, outs, planar_out
        torch.cuda.empty_cache()
        kernels += check_mask_loss(torch, dev)
        train_counts, step_ms, step_peak, train_batches = run_train_path(torch, dev, card)
        counts.update({k: v for k, v in train_counts.items() if k.startswith("mask_loss")})
        check_train_reference(torch, dev)
        bf16_train_counts = run_bf16_train_path(torch, dev, card, train_batches, step_ms,
                                                step_peak)
        del train_batches
        torch.cuda.empty_cache()
        check_bf16_train_reference(torch, dev)
        run_trainer(torch, dev, card, step_ms)
        run_ranks(torch, card)
        kernels.append(b4)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["name"].startswith("mask_loss"):  # the bf16-logit variant on phase 16's path
            k["bf16"]["launches"] = bf16_train_counts[k["name"] + "_bf16"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
