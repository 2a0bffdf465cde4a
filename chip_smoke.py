#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`nopesac_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. device: name, capability (>= 9.0) and nvidia-smi's name and power limit;
  2. build: every `nopesac_torch/ops/csrc/*.cu` with nvcc, in parallel;
  3. B1 (select_maps) at the main-path shapes, held to its plain PyTorch
     version by `nopesac_torch/utils/kernel_checks.py` (the card tests'
     rules) in its vec variant; its registers, shared memory, spills and
     blocks per SM; one device kernel per call (torch.profiler); the kernel
     and its plain version timed;
  4. B2 (sinkhorn) at [4, 50, 50], 200 iterations, masked, from the scores
     to the log coupling: held to its plain version by the same rules in
     its register variant; one device kernel per call; timed from scores to
     output, the kernel's own device time beside it, its plain version, and
     an estimate of its dependency floor (assumed latencies, not measured;
     printed, not in the kernels line);
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
  8. B3 (mask_loss_fwd, mask_loss_bwd) at one supervision level of the train
     step: [32, 50, 120, 160] logits, [32, 50, 480, 640] uint8 masks, 12
     matched queries per view: held to the plain version by the same rules
     with f32 and with bf16 logits, and with no query matched; each
     kernel's registers, shared memory, spill bytes and resident blocks per
     SM (cudaFuncGetAttributes); the kernels and their plain versions timed
     with f32 and with bf16 logits;
  9. train path: the train step of configs/train_mp3d_step3.yaml (f32 and
     MODEL.REMAT off, 16 pairs of 480x640, seeded random weights) on
     synthetic pairs of 12
     planes per view from the port's generator, a warm-up step, then 3
     steps: every loss of the JAX train_forward present and finite, no
     skipped step, a finite positive gradient norm in each of the four
     modules, each B3 counter at 3 per step, H1 (the matcher) at 1 per
     step, B1 and B2 not launched;
 10. train reference: one train step of one pair at 96x128
     (configs/smoke_synthetic.yaml, dropout 0, AIM random poses injected)
     on the card and on the CPU from the same weights and batch: the match
     of every supervision level equal, every loss within max(1e-4, 1e-3
     relative), the gradient norm within 1e-3 relative, the parameters
     after the AdamW step within 1e-5 relative (norm over the model);
 11. B4 (bottleneck_tail) at the eight shapes of the fused-tail eval path
     (8 images of 480x640: res2..res5, conv1 Cin -> Cout/4 with ReLU, conv3
     Cout/4 -> Cout with the residual and ReLU), in f32 and in bf16 (its
     bound at bf16 bytes and the dense bf16 tensor-core rate), each held to
     its plain version by the same rules (bf16 also two runs bit-equal) and timed
     beside its plain version and the unfused sequence the backbone runs
     without B4 in that dtype (cuDNN 1x1 conv, then the ATen affine, add and
     ReLU); every f32 eval shape must take the vec variant and every bf16
     one the wgmma variant (`ops/csrc/bottleneck_wgmma.cu`), whose walk
     must span the blocks the card holds at once; the config (BM, BN, X's
     load path, Cin split, blocks) is printed per shape with each variant's
     registers, shared memory and spills, and the HGMMA count of the wgmma
     library's SASS (cuobjdump -sass), which must be > 0; the bf16
     wrapper's host time with an f32 and with a bf16 weight;
 12. fused-tail eval path: the phase-5 model and batches with
     MODEL.RESNETS.FUSE_TAIL True: B4's counter rises by exactly 24 per batch (12
     identity blocks, two calls each), res2..res5 match the unfused backbone
     within 1e-4 of max |ref|, the outputs match phase 5's at phase 6's
     limits, and the two eval steps are timed in alternating rounds;
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
     last_checkpoint; B3 launched 3 times and H1 once per step, B1/B2 once per eval
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
     per fused batch; the fused bf16 backbone against the unfused f32 one per
     stage (res2..res5) at full width, seeded and with trained-like BN
     statistics: max |fused bf16 - f32| <= max(1.5 max |unfused bf16 - f32|,
     one bf16 ulp of max |f32|); the card against the CPU at 96x128 at the
     bf16 rule of tests/test_torch_bf16_eval.py with the card's own
     bf16-vs-f32 deviation in place of JAX's; the bf16 eval steps timed
     against phase 5's and 12's f32 ones in alternating rounds;
 16. bf16 train path: configs/train_mp3d_step3.yaml as shipped (bf16 compute
     and block interiors, REMAT on) on phase 9's batches, a warm-up and 3
     steps: every loss finite, no skipped step, B3 3 f32-logit launches per
     step and no bf16-logit one (the model sends f32 logits), B1 and B2
     none; ms per step and peak memory, then again with REMAT off,
     beside phase 9's f32 step.
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
     parameters' errors printed); each rank's B3 at 3 launches and H1 at 1 per step and
     B1/B2 at one per evaluation batch, no skipped step, continuous.pkl
     written once with 16 pairs. Prints each launch's ms/step, peak memory
     per rank, the gradient all-reduce's ms and MiB, and B's evaluation
     pairs/s: two processes sharing one card over host-staged gloo, not a
     scaling figure. Each launch has a timeout; a rank that fails or hangs
     fails the phase.
 18. the eval ablations at full width: configs/inference_mp3d.yaml (phase
     5's weights) at 480x640, 4 pairs per batch of synthetic pairs with 12
     planes per view and their correspondences (the port's generator): (a)
     TEST.POSE_REFINEMENT_WITH_GT_MATCHERS with the GT planes' noise
     (`engine/test.py:gt_geo_from_samples`), (b) the SparsePlanes top-1
     camera from a table of the pairs' GT poses, one quaternion negated,
     (c) MODEL.DEPTH_ON (the depth branch seeded); each a warm-up and 3
     batches beside phase 5's eval step on the same batches: B1 and B2
     once per batch, the PixelCameraHead's decoder run once per batch but
     never under (b), num_matches the GT count under (a), camera_init the
     pickle's pose (normalised, w >= 0) under (b), depth0/depth1
     [4, 480, 640, 1] f32 under (c); (a) through the fused-tail backbone (B4
     24 times per batch), held to unfused (a); the three at 96x128 on the
     card against the CPU at phase 6's limits, depth0/depth1 within 1e-4 of
     max |CPU|; `EvalRunner.test` with (a) and (c) over 8 pairs: B1 and B2
     once per batch, depth_l1_dist and the camera metrics finite; and with
     (b) through a pickle file;
 19. the train branches: configs/train_mp3d_step3.yaml with MODEL.DEPTH_ON
     (f32, REMAT off) on phase 9's batches, a warm-up and 3 steps: every
     loss of the JAX train_forward and loss_depth_pixel finite, each B3
     counter at 3 and H1 at 1 per step, ms/step and peak memory beside phase 9's; one
     step of the shipped bf16 policy with DEPTH_ON and
     MODEL.FPN_TRAIN_DTYPE bfloat16 (as shipped the pixel path trains in
     f32): the depth head's output bf16, every loss finite; then phase 10's
     one-pair card-versus-CPU step with DEPTH_ON and SOLVER.OPTIMIZER SGD,
     at phase 10's limits.
 20. offline evaluation and visualisation, on phase 13's artifacts under
     output/eval_entry_point/ (16 pairs at 480x640) and their pairs written
     as a cached_set json: `python -m nopesac_torch.engine.offline_eval
     --evaluate AP --num-process 2` as a subprocess, as a user runs it
     (forked workers), and the CLI's main in process on camera and matching,
     each with its table; `Evaluator`'s camera medians and accuracies within
     1e-3 of phase 13's online ones and five finite AP rows; AP and camera
     again with --camera-cached-file (logits one-hot at the GT pose's bins)
     and no best_camera for the odd pairs, whose cameras must be the GT
     bins' centres. Then the visualisation of 4 of those pairs (their
     renders written as the views' image files; the GT-plane scenes too)
     and of the planar scene's postprocessed outputs (phase 6, 12 planes
     per view): `engine/vis.py:vis_pair` where matplotlib imports, else the
     matching figure and `scene_meshes`' OBJs written by the phase itself
     (an import check decides before the phase draws): every listed file
     written, each OBJ's vertex and face counts those of its mesh. No
     kernel is launched. Prints each mode's and vis's seconds per pair,
     host figures.
 21. the ScanNet path from raw scans (`nopesac_torch/tools/synthetic_scans.py`
     writes seeded 480x640 scenes in the ScanNet layout, 6-12 planes per
     frame, 3-7 shared by consecutive frames, sparse-view pose gaps): (a)
     `python -m nopesac_torch.tools.generate_scannetv2_data` once per split
     with a --split-file, at least 16 train and 8 test pairs, its s/pair;
     (b) `Trainer` on configs/train_scannet_step1.yaml as shipped (bf16) on
     the generated split (DATASETS.ROOT_DIR), 16 pairs of 480x640 per step, 4
     loader workers, 3 steps, from a seeded full model written as .pkl (the
     overlay: every shared tensor the file's, the rest of the file
     unexpected); (c) configs/train_scannet_step2.yaml (REFINE_ON) from step
     1's model_final.pth for 2 steps, the weight chain checked, the eval hook
     once over the 8 test pairs: in (b) and (c) every loss of the JAX
     train_forward of the step finite, no skipped step, B3 3 launches and H1
     1 per step and B1/B2 once per hook batch; (d) `engine/test.py --eval-only` on
     configs/inference_scannet.yaml (f32, unfused) with step 2's weights
     over scannet_test: the artifacts written, B1 and B2 once per batch, no
     B4; the offline evaluator's main in process in AP and camera modes
     (five AP rows, finite camera errors) and `GeoConsistencyLoss.inference`
     on the artifacts' planes and cameras (finite); (e) phase 10's one-pair
     train step, card against CPU, on the first generated train pair whose
     match does not tie on the CPU, through the ScanNet mapper at 96x128.
     Prints each Trainer's time_per_iter_recent, loader
     waits and peak memory, and the evaluation's pairs/s. Cut: the pairs (18
     train and 8 test of a split's thousands) and the steps (3 and 2 of 30 k
     and 10 k).
 22. H1 (hungarian, the matcher's batched Jonker-Volgenant assignment) on
     the costs [96, 50, 50] of a full-width train detect (phase 9's config
     and second batch: 3 supervision levels x 32 views, 12 planes per
     view): kernel against its plain version (on the card and on the CPU)
     bit for bit, two runs bit-equal, each GT plane matched once, the total
     cost within 1e-5 relative of scipy's optimum (`hungarian_host`);
     `match_planes_multi` under
     torch.cuda.set_sync_debug_mode("error") (no host sync, one launch);
     the host syncs left in one train forward and backward and in the
     update, counted in "warn" mode by site; one device kernel per call
     (under torch.profiler right after phase 4, at this shape on seeded
     costs: the profiler sees the card there);
     timed beside its plain version and the host path it replaced (the
     device-to-host copy, scipy per problem and the match back), with its
     bound and an estimate of its dependency floor (assumed latencies, not
     measured; printed, not in the kernels line).
Phases 11-13, 20, 15 and 18 run right after phase 6, while the eval model is
on the card; phase 22 right after phase 9; phases 14, 16 and 19 run after
phase 10, phase 17 after phase 14, phase 21 last.
Phases 6 and 12 hold the card to the CPU, or the fused path to the
unfused one, as the CPU is held to JAX in tests/test_torch_slice.py: valid
planes equal, labels agree on >= 99.9% of pixels, log-scores within 1.5e-3
and every camera within 1e-3; phase 10 does the same with the tolerances of
tests/test_torch_train.py.
The card holds each kernel to its plain version in tests/test_torch_gpu.py
(`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_gpu.py`); this script times the kernels and checks what
they launch. There is no phase 7: the eval step at 480x640 against the
plain reference is the benchmark's (cardbench, cell eval_entry_bs4), as is
the shipped bf16 train step (train_step3_bs16).
Then one JSON line with every kernel's launches and times, and, last,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The launches of B1 and B2 are those of the eval path (phase 5), those of B3
and H1 those of the train path (phase 9), those of B4 those of the fused-tail eval
path (phase 12); phases 13-16 check their own. B4's times are per eval
batch: the sum over its 24 calls. The entries of B3 and B4 carry a "bf16"
object with the same keys for their bf16 variant (B4's launches those of
phase 15's fused path, B3's the bf16-logit launches counted apart in
phase 16's REMAT-on run, where the model sends f32 logits and phase 16
requires 0). Each entry and its "bf16" object also carry "launches_scannet",
the launches over phase 21's (b)-(d).

Every kernel row (a kernel, its plain version, B4's cuDNN + ATen sequence)
is timed one way, by `kernel_ms`: "ms" is the CUDA-event mean over many warm
launches queued behind a sleep kernel, so that it times the device and not
the wrapper's host work; each kernel's entry also carries "unqueued_ms", the
mean as the host issues the launches, and its wrapper's "host_us" per call
(B4: "host_ms" per eval batch). `bound_ms` is the
larger of bytes moved / 3.35 TB/s and operations / the peak rate of their
type: 67 TFLOP/s f32, 989 TFLOP/s dense bf16 on the tensor cores (H100 SXM
published peaks).

    python3 chip_smoke.py --time-tree DIR

times B1 and B2 of the port in DIR (a checkout of any of its commits, e.g. a
parent unpacked with `git archive`) on phase 3's and 4's inputs, through the
functions the eval path calls, and B4 in f32 and bf16 at the eight eval
shapes on phase 11's inputs, with this script's timing code (queued and
unqueued), and prints one JSON line;
run it for a parent and a change in turns in one call.

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
import re
import shutil
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
# An estimate of H1's dependency floor, not a measurement: assumed latencies
# in cycles of one Dijkstra step's chain (the row's shared loads, three f32
# additions, the lane's 4-column argmin, five shuffle levels of a (value,
# index) argmin, the winner's row4col load) and of the work per solved row
# (the dual updates and a one-step augmenting walk, three warp barriers)
HUNGARIAN_LATENCY = {"lds": 30, "shfl": 25, "alu": 4, "syncwarp": 20}
# B4 at 480x640 with 8 images (4 pairs, both views): per stage the map size,
# the block's width and bottleneck width, and its identity blocks
B4_STAGES = (("res2", 120, 160, 256, 64, 2), ("res3", 60, 80, 512, 128, 3),
             ("res4", 30, 40, 1024, 256, 5), ("res5", 15, 20, 2048, 512, 2))
B4_LAUNCHES = 2 * sum(s[-1] for s in B4_STAGES)  # 24 per eval batch
QUEUE_CYCLES = 40_000_000  # the least sleep kernel before queued calls: ~20 ms at SM_CLOCK_HZ
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
ABLATIONS = ("gt_matcher", "sp_topcam", "depth")  # phase 18's variants (a), (b), (c)
ABLATION_PAIRS = 8     # phase 18's EvalRunner.test
DEPTH_TOL = 1e-4       # of max |ref|: depth0/depth1, tests/test_torch_ablations.py
VIS_PAIRS = 4          # phase 20's visualised pairs of each artifact set
AP_ROWS = ("all", "-offset", "-normal", "-mask", "-normal-offset")
SCANNET_DIR = os.path.join(REPO, "output", "scannet_smoke")
SCANNET_HW = (480, 640)
SCANNET_PAIRS = 16        # SOLVER.IMS_PER_BATCH of phase 21's steps
SCANNET_PLANES = (6, 12)  # planes per raw frame
# per split: scenes, frames per scene, frame step, first seed (18 train
# pairs, 8 test pairs: both orders of each test frame pair)
SCANNET_SCENES = {"train": (3, 12, 20, 40), "test": (2, 4, 40, 50)}
SCANNET_MIN_PAIRS = {"train": 16, "test": 8}
SCANNET_STEPS = (3, 2)    # ScanNet step 1 and step 2


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


def keep(tree):
    """A copy of an eval step's device outputs: the step returns its CUDA
    graphs' static buffers, which its next call with the same input
    signature overwrites."""
    if isinstance(tree, dict):
        return {k: keep(v) for k, v in tree.items()}
    return tree.clone()


def cuda_ms(torch, fn, warm=3, iters=20):
    """CUDA-event ms per call over `iters` warm calls, as the host issues them."""
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


def kernel_ms(torch, fn, warm=3, iters=20):
    """The times per call of one kernel row (a kernel, its plain version, a
    library sequence) over `iters` warm calls, by CUDA events: "ms" with
    the calls queued behind a sleep kernel that outlasts their enqueue, so
    that the events time the device's back-to-back work alone;
    "unqueued_ms" with the calls timed as the host issues them (above "ms"
    where the host's work per call outlasts the device's); "host_us" the
    host's time to issue one call while the queue is held. A call that
    waits on the device (a plain version's host sync) drains the queue, and
    its "ms" comes to its "unqueued_ms"."""
    t0 = time.perf_counter()
    unqueued = cuda_ms(torch, fn, warm, iters)
    wall = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(QUEUE_CYCLES, 2 * wall * SM_CLOCK_HZ)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / iters, "unqueued_ms": unqueued,
            "host_us": 1e6 * host / iters}


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


def time_select(torch, dev):
    from nopesac_torch.ops import select
    from nopesac_torch.utils.kernel_checks import hold_select
    prob16, score, valid = select_case(torch, dev)
    b, nq, h, w = prob16.shape
    out_h, out_w, thr = 4 * h, 4 * w, 0.5
    hold_select(prob16, score, valid, thr, out_h, out_w, "vec")
    print("[B1 select_maps] kernel holds to its plain version (utils/kernel_checks.py), vec")
    print(f"[B1 select_maps] kernel: {select.kernel_attributes('vec', nq)} (cudaFuncGetAttributes)")
    call = eval_path_calls(torch, dev)["select_maps"]
    prof = device_events(torch, call)
    print(f"[B1 select_maps] torch.profiler: {prof['per_call']:g} device events per call "
          f"({prof['names']}), {prof['device_ms']:.4f} device ms per call")
    if prof["per_call"] != 1:
        raise SmokeFailure("B1 must be one device kernel per call")
    t = kernel_ms(torch, call, iters=50)
    ms = t["ms"]
    plain_ms = kernel_ms(torch, lambda: select.select_maps_plain(
        prob16.float(), score, valid, thr, out_h, out_w), warm=2, iters=5)["ms"]
    n_bytes = (b * nq * h * w * 2 + b * nq * (4 + 1)        # prob bf16, score, valid
               + 2 * b * out_h * out_w * 4 + b * 7 * nq * 4)  # seg, max, stats
    # per output pixel and query: a row 2-tap (3), the score product (1) and
    # 3/4 of a column 2-tap (2.25), shared by the 4 output rows of a low-res pixel
    n_ops = b * nq * out_h * out_w * 6.25
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"[B1 select_maps] kernel {ms:.4f} ms (unqueued {t['unqueued_ms']:.4f}, host "
          f"{t['host_us']:.1f} us per call; variant {select.last_config}), plain {plain_ms:.4f} "
          f"ms, bound {bms:.4f} ms ({by}: {n_bytes} B, {n_ops:.0f} flop)")
    return {"name": "select_maps", "route": "cuda", "source": "nopesac_torch/ops/csrc/select.cu",
            "replaces": "nopesac_tpu/ops/select_pallas.py:213",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "unqueued_ms": t["unqueued_ms"], "host_us": t["host_us"],
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


def time_sinkhorn(torch, dev):
    from nopesac_torch.ops import sinkhorn
    from nopesac_torch.utils.kernel_checks import hold_sinkhorn
    scores, alpha, row, col = sinkhorn_case(torch, dev)
    (b, m, n), iters = scores.shape, SINKHORN_ITERS
    hold_sinkhorn(scores, alpha, iters, row, col, "register")
    print("[B2 sinkhorn] kernel holds to its plain version (utils/kernel_checks.py), register")
    # scores to output, through the wrapper the matching head calls
    call = eval_path_calls(torch, dev)["sinkhorn"]
    prof = device_events(torch, call)
    print(f"[B2 sinkhorn] torch.profiler: {prof['per_call']:g} device events per call "
          f"({prof['names']}), kernel {prof['device_ms']:.4f} device ms per call")
    if prof["per_call"] != 1:
        raise SmokeFailure("B2 must be one device kernel per call, from scores to output")
    t = kernel_ms(torch, call, iters=50)
    ms = t["ms"]
    plain_ms = kernel_ms(torch, lambda: sinkhorn.sinkhorn_plain(scores, alpha, iters, row, col),
                         warm=1, iters=3)["ms"]
    r, c = m + 1, n + 1
    n_bytes = 4 * b * m * n + b * (m + n) + 4 + 4 * b * r * c  # scores, masks, alpha, out
    n_ops = b * iters * 2 * r * c * 5                          # add, max, sub, exp, sum per entry and pass
    bms, by = bound_ms(n_bytes, n_ops)
    floor_ms, cycles = sinkhorn_floor_ms(iters, sinkhorn.GROUP)
    print(f"[B2 sinkhorn] scores to output {ms:.4f} ms (unqueued {t['unqueued_ms']:.4f}, host "
          f"{t['host_us']:.1f} us per call; {sinkhorn.GROUP} lanes per row), kernel "
          f"alone {prof['device_ms']:.4f} device ms, config {sinkhorn.last_config}, plain "
          f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}: {n_bytes} B, {n_ops} flop); dependency "
          f"floor estimate {floor_ms:.4f} ms ({cycles} cycles per half-iteration at assumed "
          f"latencies, not measured)")
    return {"name": "sinkhorn", "route": "cuda", "source": "nopesac_torch/ops/csrc/sinkhorn.cu",
            "replaces": "nopesac_tpu/ops/sinkhorn_pallas.py:87",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "unqueued_ms": t["unqueued_ms"], "host_us": t["host_us"],
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
        outs = [keep(step(*pair)) for pair in batches[1:]]
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


def time_mask_loss(torch, dev):
    """Phase 8: B3 held to its plain version with f32 and with bf16 logits,
    and on an all-unmatched batch; its kernels' attributes; the kernels and
    their plain versions timed with f32 and with bf16 logits."""
    from nopesac_torch.ops import mask_loss
    from nopesac_torch.utils.kernel_checks import hold_mask_loss

    b, nq, h, w, n_matched = 2 * TRAIN_PAIRS, 50, 120, 160, TRAIN_PLANES
    src, masks, tgt, matched = (t.to(dev) for t in mask_loss_inputs(torch, 3, b, nq, h, w,
                                                                       n_matched))
    weights = torch.randn((b, nq, 4), generator=torch.Generator().manual_seed(4)).to(dev)
    for logits, m in ((src, matched), (src.to(torch.bfloat16), matched),
                      (src, torch.zeros_like(matched))):
        hold_mask_loss(logits, masks, tgt, m, weights)
    print(f"[B3 mask_loss] kernels hold to their plain versions (utils/kernel_checks.py) at "
          f"[{b}, {nq}, {h}, {w}] with {n_matched} matched per view, f32 and bf16 logits, and "
          f"with none matched")
    for which in ("fwd", "bwd"):
        print(f"[B3 mask_loss] {which} kernel at w {w}: {mask_loss.kernel_attributes(which, w)} "
              f"(cudaFuncGetAttributes)")
    idx = mask_loss._flat_index(masks, tgt, matched)
    grad3 = weights[..., :3].reshape(-1, 3).contiguous()
    f32 = mask_loss_rows(torch, src, masks, tgt, matched, weights, idx, grad3)
    bf16 = mask_loss_rows(torch, src.to(torch.bfloat16), masks, tgt, matched, weights, idx, grad3)
    # the bf16 rows' launches: phase 16's
    return [dict(f32[k], bf16=dict(bf16[k], dtype="bfloat16")) for k in ("fwd", "bwd")]


def mask_loss_rows(torch, src, masks, tgt, matched, weights, idx, grad3):
    """B3's forward and backward kernels and their plain versions timed on
    `src`, f32 or bf16 logits: their rows of the kernels line."""
    from nopesac_torch.ops import mask_loss

    b, nq, h, w = src.shape
    elem = src.element_size()
    t_fwd = kernel_ms(torch, lambda: mask_loss.mask_loss_fwd_cuda(src, masks, idx), iters=50)
    t_bwd = kernel_ms(torch, lambda: mask_loss.mask_loss_bwd_cuda(src, masks, idx, grad3),
                      iters=50)
    ms_fwd, ms_bwd = t_fwd["ms"], t_bwd["ms"]

    def plain_fwd():
        return mask_loss.focal_dice_plain(src.detach().requires_grad_(True), masks, tgt, matched)

    def plain_fwd_bwd():
        torch.autograd.backward(torch.stack(plain_fwd(), dim=-1), weights)

    plain_fwd_ms = kernel_ms(torch, plain_fwd, warm=2, iters=5)["ms"]
    plain_bwd_ms = kernel_ms(torch, plain_fwd_bwd, warm=2, iters=5)["ms"] - plain_fwd_ms
    n_m, n_px = int(matched.sum()), 16 * h * w
    read = n_m * (h * w * elem + n_px) + b * nq * 4  # matched logits, matched masks, index
    fwd_bms, fwd_by = bound_ms(read + b * nq * 4 * 4, n_m * n_px * MASK_FWD_OPS)
    bwd_bms, bwd_by = bound_ms(read + b * nq * 3 * 4 + b * nq * h * w * elem,
                               n_m * n_px * MASK_BWD_OPS)
    print(f"[B3 mask_loss] {str(src.dtype)[6:]} logits: forward kernel {ms_fwd:.4f} ms "
          f"(unqueued {t_fwd['unqueued_ms']:.4f}; bound {fwd_bms:.4f} ms, {fwd_by}), plain "
          f"{plain_fwd_ms:.3f} ms; backward kernel {ms_bwd:.4f} ms (unqueued "
          f"{t_bwd['unqueued_ms']:.4f}; bound {bwd_bms:.4f} ms, {bwd_by}), plain "
          f"{plain_bwd_ms:.3f} ms")
    common = {"route": "cuda", "source": "nopesac_torch/ops/csrc/mask_loss.cu",
              "library_ms": None}
    return {"fwd": dict(common, name="mask_loss_fwd",
                        replaces="nopesac_tpu/ops/mask_loss_pallas.py:199", ms=ms_fwd,
                        plain_ms=plain_fwd_ms, bound_ms=fwd_bms, bound_by=fwd_by,
                        unqueued_ms=t_fwd["unqueued_ms"], host_us=t_fwd["host_us"]),
            "bwd": dict(common, name="mask_loss_bwd",
                        replaces="nopesac_tpu/ops/mask_loss_pallas.py:235", ms=ms_bwd,
                        plain_ms=plain_bwd_ms, bound_ms=bwd_bms, bound_by=bwd_by,
                        unqueued_ms=t_bwd["unqueued_ms"], host_us=t_bwd["host_us"])}


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
# curriculum step 2 (train_mp3d_step2.yaml, train_scannet_step1.yaml): every
# loss but the refinement's
STEP2_LOSS_KEYS = sorted(k for k in TRAIN_LOSS_KEYS if not any(k.endswith(f"_{b}") for b in (
    "initCamRef", "initRecCamRef", "initCamRef_Aux", "initRecCamRef_Aux")))
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


def timed_train_steps(torch, cfg, batches, card, what, loss_keys=TRAIN_LOSS_KEYS):
    """A fresh seeded model of `cfg`, a warm-up step on batches[0], then one
    timed step per further batch: every loss of the JAX train_forward
    (`loss_keys`) present and finite, no skipped step, a finite positive gradient norm in
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
        if sorted(losses) != loss_keys:
            raise SmokeFailure(f"train step {k} ({what}): loss keys differ from the JAX "
                               f"train_forward's: {sorted(set(losses) ^ set(loss_keys))}")
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
    want = launches_want(mask_loss_fwd=3 * TRAIN_STEPS, mask_loss_bwd=3 * TRAIN_STEPS,
                         hungarian=TRAIN_STEPS)
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


def hungarian_floor_ms(steps, rows):
    """An estimate of H1's dependency floor: its warps run side by side, so
    the problem with the longest chain, `steps` Dijkstra steps and `rows`
    solved rows, at the assumed latencies of HUNGARIAN_LATENCY and
    SM_CLOCK_HZ."""
    lat = HUNGARIAN_LATENCY
    step = (2 * lat["lds"] + 3 * lat["alu"] + 4 * 4 * lat["alu"]
            + 5 * (lat["shfl"] + 4 * lat["alu"]) + 2 * lat["alu"])
    row = 3 * lat["syncwarp"] + 4 * lat["lds"] + 2 * lat["alu"] + 4 * lat["lds"]
    return (steps * step + rows * row) / SM_CLOCK_HZ * 1e3, step, row


def sync_sites(torch, fn):
    """Run fn under torch.cuda.set_sync_debug_mode("warn"): the host syncs
    it makes, counted by the innermost frame of this repository's code that
    made them ("path:line function")."""
    import traceback
    import warnings

    sites = {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = "outside the repository"
        for fr in reversed(traceback.extract_stack()[:-1]):
            path = os.path.abspath(fr.filename)
            if path.startswith(REPO + os.sep) and path != os.path.abspath(__file__):
                site = f"{os.path.relpath(path, REPO)}:{fr.lineno} {fr.name}"
                break
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def hungarian_events(torch, dev):
    """H1's device events per call under torch.profiler (one device kernel,
    no copy or cast around it), at phase 22's shape: seeded costs [96, 50,
    50], 12 GT planes per problem. Taken right after phase 4, where the
    profiler sees the card: in one run it recorded no device event at all
    in phase 22's place, after the phases between."""
    from nopesac_torch.ops import hungarian as h1

    gen = torch.Generator(device=dev).manual_seed(22)
    cost = torch.randn((3 * 2 * TRAIN_PAIRS, 50, 50), generator=gen, device=dev) * 5
    num_gt = torch.full((cost.shape[0],), TRAIN_PLANES, dtype=torch.int64, device=dev)
    prof = device_events(torch, lambda: h1.hungarian_cuda(cost, num_gt))
    print(f"[H1 hungarian] torch.profiler: {prof['per_call']:g} device events per call "
          f"({prof['names']}), {prof['device_ms']:.4f} device ms per call")
    if prof["per_call"] != 1:
        raise SmokeFailure("H1 must be one device kernel per call")
    return prof


def check_hungarian(torch, dev, card, batches, prof):
    """Phase 22: kernel H1 (the matcher) against its plain version, bit for
    bit, on the card's own costs from a full-width train detect (3 levels x
    32 views: [96, 50, 50]; tests/test_torch_gpu.py holds it on the seeded
    families of `losses/hungarian_cases.py`); optimal against
    `hungarian_host` (scipy); `match_planes_multi` with no host sync; the
    remaining syncs of one train step by site; times and bound."""
    from nopesac_torch.data.packing import unpack_targets
    from nopesac_torch.engine.train import TrainStep, build_train_model
    from nopesac_torch.losses import hungarian as H
    from nopesac_torch.losses.criterion import compute_match_cost, match_planes_multi
    from nopesac_torch.ops import hungarian as h1
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_train_cfg(TRAIN_CONFIG, F32_TRAIN + [
        "SOLVER.IMS_PER_BATCH", str(TRAIN_PAIRS), "INPUT.IMAGE_SIZE", "(480, 640)"])
    model = build_train_model(cfg, device=dev, seed=0)
    batch = batches[1]
    weights = model.train_settings.match_cost_weights()
    t0, t1 = unpack_targets(batch["targets0"]), unpack_targets(batch["targets1"])
    targets = {k: torch.cat([t0[k], t1[k]]) for k in t0}
    with torch.no_grad():
        images = torch.cat([batch["image0"], batch["image1"]]).permute(0, 3, 1, 2).contiguous()
        _, out, _ = model.detect(images)
        levels = [out] + list(out["aux_outputs"])
        cost = torch.cat([compute_match_cost(o, targets, weights) for o in levels])
        num_gt = targets["gt_valid"].to(torch.int64).sum(dim=-1).repeat(len(levels))
    p, nq, ng = cost.shape
    if (p, nq, ng) != (3 * 2 * TRAIN_PAIRS, 50, 50) or cost.dtype != torch.float32:
        raise SmokeFailure(f"H1: the train step's costs are {cost.dtype} {(p, nq, ng)}, want "
                           f"f32 {(3 * 2 * TRAIN_PAIRS, 50, 50)}")

    # the card's costs: kernel, plain version on the card and on the CPU, scipy
    got = h1.hungarian_cuda(cost, num_gt)
    again = h1.hungarian_cuda(cost, num_gt)
    plain_card = H.hungarian_plain(cost, num_gt)
    plain_cpu = H.hungarian_plain(cost.cpu(), num_gt.cpu())
    host = H.hungarian_host(cost, num_gt)
    steps = torch.zeros(p, dtype=torch.int64)  # the Dijkstra steps of each problem, for the bound
    H.lap_jv_rect(H.pad_and_sanitize(cost.cpu()).transpose(1, 2), num_gt.cpu().clamp(0, ng), steps)
    torch.cuda.synchronize()
    n_bad = int((got.cpu() != plain_cpu).sum()) + int((got != plain_card).sum())
    sane = H.pad_and_sanitize(cost).double().cpu()

    def total(match):
        m = match.cpu()
        return [float(sane[b][m[b] >= 0, m[b][m[b] >= 0]].sum()) for b in range(p)]

    mine, best = total(got), total(host)
    gap = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(mine, best))
    once = all(sorted(got[b][got[b] >= 0].tolist()) == list(range(int(num_gt[b])))
               for b in range(p))
    same_as_host = int((got == host).all(dim=1).sum())
    print(f"[H1 hungarian] the train step's costs {(p, nq, ng)} f32, num_gt "
          f"{sorted(set(num_gt.tolist()))}: mismatches against the plain version (card and "
          f"CPU) {n_bad}; two runs bit-equal {torch.equal(got, again)}; "
          f"each GT once {once}; total cost against scipy's optimum, worst relative gap "
          f"{gap:.3e}; {same_as_host} of {p} matches equal scipy's; Dijkstra steps per problem "
          f"max {int(steps.max())}, total {int(steps.sum())}; kernel {h1.kernel_attributes()}")
    if n_bad or not torch.equal(got, again) or not once or not gap <= 1e-5:
        raise SmokeFailure("H1 disagrees with its plain version, or its match is not optimal")

    # the profiler here, after the phases between 4 and 22: printed, not held
    # (PERF.md §7: in one run it saw no device event in this place)
    late = device_events(torch, lambda: h1.hungarian_cuda(cost, num_gt))
    print(f"[H1 hungarian] torch.profiler in phase 22's place: {late['per_call']:g} device "
          f"events per call ({late['names']}); right after phase 4: {prof['per_call']:g}")

    # the call site makes no host sync, and launches H1 once
    LAUNCHES.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        matches = match_planes_multi(levels, targets, weights)
    except RuntimeError as e:
        raise SmokeFailure(f"match_planes_multi synchronises with the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if LAUNCHES["hungarian"] != 1 or not torch.equal(torch.cat(matches), got):
        raise SmokeFailure(f"match_planes_multi: {LAUNCHES['hungarian']} H1 launches, or its "
                           f"match differs from the kernel's")
    print("[H1 hungarian] match_planes_multi under set_sync_debug_mode('error'): no host sync, "
          "one H1 launch")

    # the syncs left in one train step, by site
    step = TrainStep(model, cfg, seed=0)
    step(batch)  # warm-up
    sites = {}

    def fwd_bwd():
        step.optimizer.zero_grad(set_to_none=True)
        sites["result"] = step.forward_backward(batch)

    fb = sync_sites(torch, fwd_bwd)
    upd = sync_sites(torch, lambda: step.apply_gradients(
        finite_total=torch.isfinite(sites["result"][1])))
    print(f"[H1 hungarian] host syncs of one train forward and backward (f32, {TRAIN_PAIRS} "
          f"pairs), by site: {fb or 'none'}; of the update that follows (apply_gradients): "
          f"{upd or 'none'}")
    del step, model
    torch.cuda.empty_cache()

    # times: the kernel, its plain version on the card, the host path it replaces
    t = kernel_ms(torch, lambda: h1.hungarian_cuda(cost, num_gt), iters=50)
    plain_ms = kernel_ms(torch, lambda: H.hungarian_plain(cost, num_gt), warm=1, iters=3)["ms"]
    host_ms = kernel_ms(torch, lambda: H.hungarian_host(cost, num_gt), warm=1, iters=5)["ms"]
    with torch.no_grad():  # the rest of the "matcher" span: the three levels' costs
        costs = kernel_ms(torch, lambda: torch.cat(
            [compute_match_cost(o, targets, weights) for o in levels]), iters=10)
    n_bytes = cost.numel() * 4 + num_gt.numel() * 8 + p * nq * 8  # costs, num_gt, match
    n_ops = int(steps.sum()) * nq * 4  # per Dijkstra step and column: 3 additions, a compare
    bms, by = bound_ms(n_bytes, n_ops)
    worst = int(torch.argmax(steps))
    floor_ms, step_cycles, row_cycles = hungarian_floor_ms(int(steps[worst]),
                                                           int(num_gt[worst]))
    print(f"[H1 hungarian] kernel {t['ms']:.4f} ms (unqueued {t['unqueued_ms']:.4f}, host "
          f"{t['host_us']:.1f} us per call); plain version on the card "
          f"{plain_ms:.4f} ms; the host path it replaces (device-to-host copy, scipy per "
          f"problem, the match back: hungarian_host) {host_ms:.4f} ms; the costs it solves "
          f"(compute_match_cost of 3 levels) {costs['ms']:.4f} ms (unqueued "
          f"{costs['unqueued_ms']:.4f}); bound {bms:.6f} ms ({by}: "
          f"{n_bytes} B, {n_ops} operations); dependency floor estimate {floor_ms:.4f} ms "
          f"(problem {worst}: {int(steps[worst])} Dijkstra steps x {step_cycles} cycles + "
          f"{int(num_gt[worst])} rows x {row_cycles} cycles at assumed latencies, not "
          f"measured); on {card}")
    return {"name": "hungarian", "route": "cuda", "source": "nopesac_torch/ops/csrc/hungarian.cu",
            "replaces": "nopesac_tpu/losses/hungarian.py:213",
            "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "unqueued_ms": t["unqueued_ms"], "host_us": t["host_us"],
            "host_path_ms": host_ms, "costs_ms": costs["ms"],
            "dijkstra_steps_max": int(steps.max()), "device_events_per_call": prof["per_call"],
            "kernel_device_ms": prof["device_ms"]}


def check_train_reference(torch, dev, opts=(), what="train reference 96x128", batches=None):
    """Phase 10 (and, with `opts`, phase 19's variant of it; with `batches`,
    collated CPU batches of one pair each, phase 21's: the first whose match
    does not tie on the CPU): one train step of one pair on the card and on
    the CPU from the same weights and batch."""
    from nopesac_torch.engine.train import TrainStep, build_train_model, synthetic_batches
    from nopesac_torch.losses import camera_losses
    from nopesac_torch.models.nopesac import AIM_RAND_POSES

    # one pair, as tests/test_torch_train.py: at 96x128 the pose stacks end
    # at 1x1, where BN over two pairs' two values amplifies rounding noise
    cfg = load_train_cfg(SMOKE_CONFIG, ["MODEL.SEM_SEG_HEAD.DROPOUT", "0.0",
                                        "SOLVER.IMS_PER_BATCH", "1"] + list(opts))
    cpu_model = build_train_model(cfg, device="cpu", seed=0)
    separate_queries(torch, cpu_model, seed=1)
    card_model = build_train_model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    if batches is None:
        batches = [next(iter(synthetic_batches(cfg, 1, seed=5, n_planes=6, device="cpu")))]
    gaps = []
    for batch in batches:
        ref_match, costs, n_gt = detect_matches(torch, copy.deepcopy(cpu_model), batch)
        gaps.append(min(assignment_gap(c[i], int(n_gt[i])) for c in costs
                        for i in range(c.shape[0])))
        if gaps[-1] >= MATCH_GAP:
            break
    else:
        raise SmokeFailure(f"{what}: the optimal assignment's gaps {gaps} are below "
                           f"{MATCH_GAP}, so the match can tie")
    gap = gaps[-1]
    card_batch = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                      else v.to(dev)) for k, v in batch.items()}
    b = batch["image0"].shape[0]
    gen = torch.Generator().manual_seed(3)
    n_aim = b * max(AIM_RAND_POSES // b, 1)
    aim = [camera_losses.rand_aim_rot(gen, n_aim), camera_losses.rand_aim_trans(gen, n_aim)]

    got_match, _, _ = detect_matches(torch, copy.deepcopy(card_model), card_batch)
    if not all(torch.equal(g.cpu(), r) for g, r in zip(got_match, ref_match)):
        raise SmokeFailure(f"{what}: the match differs between the card and the CPU")

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
    print(f"[{what}] card vs CPU: batch {len(gaps) - 1} of {len(batches)} (the gaps before it "
          f"tie: {[f'{g:.2e}' for g in gaps[:-1]]}), match equal on {len(ref_match)} levels (gap "
          f"{gap:.2e}), {len(ref) - 3} losses, {len(bad)} outside tolerance, grad norm rel "
          f"{gn_rel:.2e}, params after {cfg.SOLVER.OPTIMIZER} rel {param_rel:.2e} (max |diff| "
          f"{param_max:.2e})")
    if bad or not gn_rel <= 1e-3 or not param_rel <= 1e-5:
        raise SmokeFailure(f"{what}: the card disagrees with the CPU: {bad}")
    return sorted(k for k in ref if k not in ("total_loss", "grad_norm", "skipped_nonfinite"))


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
                         hungarian=TRAINER_STEPS, select_maps=n_eval, sinkhorn=n_eval)
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


def scannet_generate(card):
    """Phase 21 (a): seeded raw scenes in the ScanNet layout, then the port's
    generator CLI once per split, as a user runs it. Returns the data root."""
    import shutil

    from nopesac_torch.tools.synthetic_scans import write_scene

    shutil.rmtree(SCANNET_DIR, ignore_errors=True)
    scans, root = os.path.join(SCANNET_DIR, "scans"), os.path.join(SCANNET_DIR, "data")
    t0 = time.perf_counter()
    n_frames = 0
    for split, (n_scenes, frames, step, seed) in SCANNET_SCENES.items():
        names = [f"scene{seed + i:04d}_00" for i in range(n_scenes)]
        for i, name in enumerate(names):
            write_scene(scans, name, frames, step, seed + i, size=SCANNET_HW,
                        planes=SCANNET_PLANES)
        n_frames += n_scenes * frames
        with open(os.path.join(SCANNET_DIR, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    print(f"[scannet] {n_frames} raw frames of {SCANNET_HW[0]}x{SCANNET_HW[1]} written in "
          f"{time.perf_counter() - t0:.2f} s")
    for split, want in SCANNET_MIN_PAIRS.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nopesac_torch.tools.generate_scannetv2_data",
             "--scans-dir", scans, "--output-dir", root, "--split", split,
             "--split-file", os.path.join(SCANNET_DIR, f"{split}.txt")],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeFailure(f"generator --split {split}: exit {proc.returncode}\n"
                               f"{proc.stderr[-3000:]}")
        with open(os.path.join(root, "scannet_json", f"cached_set_{split}V2.json")) as f:
            n = len(json.load(f)["data"])
        print(f"[scannet] generator --split {split}: {n} pairs, {secs:.2f} s, "
              f"{secs / max(n, 1):.3f} s/pair (process start included), host CPU of {card}; "
              f"{' | '.join(proc.stdout.splitlines()[-3:])}")
        if n < want:
            raise SmokeFailure(f"generator --split {split}: {n} pairs, fewer than {want}")
    return root


def scannet_cfg(path, out_dir, root, steps, eval_period, weights):
    """A ScanNet curriculum config as shipped (the bf16 policy) at
    SCANNET_HW with SCANNET_PAIRS pairs per step and 4 loader workers, on
    the generated splits."""
    return load_train_cfg(path, [
        "SOLVER.IMS_PER_BATCH", str(SCANNET_PAIRS), "INPUT.IMAGE_SIZE", str(SCANNET_HW),
        "DATASETS.ROOT_DIR", root, "DATALOADER.NUM_WORKERS", "4", "MODEL.WEIGHTS", weights,
        "SOLVER.MAX_ITER", str(steps), "TEST.EVAL_PERIOD", str(eval_period),
        "OUTPUT_DIR", out_dir])


def scannet_train(torch, card, trainer, loss_keys, want, what):
    """`trainer.train()` of phase 21 (b, c): every loss of `loss_keys` finite
    in each metrics.json row, no skipped step, the eval hook (if any)
    without error, model_final.pth written, and the launches `want` over the
    whole run. Returns the launches."""
    from nopesac_torch.utils.device import LAUNCHES

    cfg = trainer.cfg
    t0 = time.perf_counter()
    trainer.loader  # the spawn pool: each worker is sent the mapper and the split
    print(f"[scannet] {what}: {cfg.DATALOADER.NUM_WORKERS} loader workers over "
          f"{len(trainer.loader.dataset)} pairs started in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        trainer.train()
    finally:
        trainer.close()
    secs = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    if trainer.last_eval_error is not None:
        raise SmokeFailure(f"{what}: the evaluation hook failed: {trainer.last_eval_error!r}")
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    loss_rows = [r for r in rows if "eval" not in r]
    eval_rows = [r["eval"] for r in rows if "eval" in r]
    last = cfg.SOLVER.MAX_ITER - 1
    if [r["iteration"] for r in loss_rows] != [0, last]:
        raise SmokeFailure(f"{what}: metrics.json loss rows {[r['iteration'] for r in loss_rows]}")
    for r in loss_rows:
        losses = {k: v for k, v in r.items() if k.startswith("loss")}
        bad = sorted(k for k, v in r.items() if not math.isfinite(v))
        if sorted(losses) != loss_keys or bad or r["skipped_nonfinite"] != 0:
            raise SmokeFailure(f"{what}: row {r['iteration']} has non-finite {bad}, skipped "
                               f"{r['skipped_nonfinite']}, or the loss keys "
                               f"{sorted(set(losses) ^ set(loss_keys))} differ")
    n_hooks = last // cfg.TEST.EVAL_PERIOD + 1 if cfg.TEST.EVAL_PERIOD > 0 else 0
    if len(eval_rows) != n_hooks or not all(math.isfinite(v) for e in eval_rows
                                            for v in e.values()):
        raise SmokeFailure(f"{what}: {len(eval_rows)} eval rows (want {n_hooks}) or not finite")
    if not os.path.exists(os.path.join(cfg.OUTPUT_DIR, "model_final.pth")):
        raise SmokeFailure(f"{what}: model_final.pth not written")
    waits = trainer.loop_times["loader_wait_s"]
    hook = (f"evaluation hook {trainer.loop_times['eval_s'][0] * 1e3:.2f} ms over "
            f"{trainer.last_eval_stats['pairs']} pairs ({trainer.last_eval_stats}); "
            if n_hooks else "")
    print(f"[scannet] {what}: {cfg.SOLVER.MAX_ITER} steps of {cfg.SOLVER.IMS_PER_BATCH} pairs "
          f"at {cfg.INPUT.IMAGE_SIZE[0]}x{cfg.INPUT.IMAGE_SIZE[1]}, {secs:.2f} s in all; "
          f"time_per_iter_recent {loss_rows[-1]['time_per_iter_recent'] * 1e3:.2f} ms/step; "
          f"next(loader) blocked {[round(t * 1e3, 2) for t in waits]} ms per step; {hook}"
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated); total loss "
          f"{loss_rows[-1]['total_loss']:.4f} at step {last}; launches {counts}; on {card}")
    if counts != want:
        raise SmokeFailure(f"{what}: launches {counts}, want {want}")
    return counts


def scannet_geo_consistency(pth, opt):
    """GeoConsistencyLoss.inference on the evaluation's plane predictions
    and best cameras: both distances finite."""
    import pickle

    import numpy as np
    import torch

    from nopesac_torch.tools.sparseplane_planeloss import GeoConsistencyLoss

    preds = torch.load(pth, weights_only=False)
    with open(opt, "rb") as f:
        cont = pickle.load(f)
    cams = [{k: np.asarray(v, np.float64) for k, v in cont[i]["best_camera"].items()}
            for i in range(len(preds))]
    loss = GeoConsistencyLoss()
    for distance in ("l2", "normal"):
        out, n1, n2 = loss.inference([p["0"] for p in preds], [p["1"] for p in preds], cams,
                                     distance)
        finite = {k: bool(np.isfinite(v).all()) for k, v in out.items()}
        print(f"[scannet] GeoConsistencyLoss.inference {distance} over {len(preds)} pairs "
              f"(planes per view {n1}, {n2}): { {k: v.shape for k, v in out.items()} } finite "
              f"{finite}")
        if not all(finite.values()):
            raise SmokeFailure(f"GeoConsistencyLoss {distance}: non-finite distances")


def run_scannet(torch, dev, card):
    """Phase 21: the ScanNet path from raw scans, through the curriculum, to
    the offline evaluation. Returns the launches of (b)-(d)."""
    import contextlib
    import io
    import shutil

    from nopesac_torch.data import datasets
    from nopesac_torch.data.mapper import PairMapper, collate
    from nopesac_torch.data.packing import batch_to_device
    from nopesac_torch.data.registry import DatasetCatalog
    from nopesac_torch.engine import test as test_entry
    from nopesac_torch.engine.predict import build_model_from_cfg
    from nopesac_torch.engine.trainer import Trainer
    from nopesac_torch.utils.device import LAUNCHES

    # (a) the splits
    root = scannet_generate(card)
    datasets.register_builtin(root)  # what the CLIs do with DATASETS.ROOT_DIR
    n_test = len(DatasetCatalog.get("scannet_test"))
    n_eval = math.ceil(n_test / N_PAIRS)
    total = launches_want()

    # (b) ScanNet step 1 from a seeded full (MP3D) model written as .pkl
    mp3d = load_train_cfg(CONFIG, ["MODEL.WEIGHTS", "", "INPUT.IMAGE_SIZE", str(SCANNET_HW)])
    sd = build_model_from_cfg(mp3d, device="cpu", seed=21).state_dict()
    pkl = os.path.join(SCANNET_DIR, "mp3d_NopeSAC.pkl")
    torch.save({"model": {**sd, "criterion.empty_weight": torch.tensor([1.0, 0.1])}}, pkl)
    step_cfg = os.path.join(REPO, "configs", "train_scannet_step{}.yaml")
    one = Trainer(scannet_cfg(step_cfg.format(1), os.path.join(SCANNET_DIR, "step1"), root,
                              SCANNET_STEPS[0], 0, pkl), device=dev)
    sd1 = one.model.state_dict()
    check_weight_chain(torch, one, pkl, sd, [], sorted(k for k in sd if k not in sd1),
                       "MP3D .pkl -> ScanNet step 1")
    steps = SCANNET_STEPS[0]
    counts = scannet_train(torch, card, one, STEP2_LOSS_KEYS,
                           launches_want(mask_loss_fwd=3 * steps, mask_loss_bwd=3 * steps,
                                         hungarian=steps), "ScanNet step 1")
    total = {k: total[k] + counts[k] for k in total}
    step1 = os.path.join(one.cfg.OUTPUT_DIR, "model_final.pth")
    del one, sd1
    torch.cuda.empty_cache()

    # (c) ScanNet step 2 (REFINE_ON) from step 1's model_final.pth, the eval
    # hook at its last step over the test split
    sd1 = torch.load(step1, map_location="cpu", weights_only=False)["model"]
    steps = SCANNET_STEPS[1]
    two = Trainer(scannet_cfg(step_cfg.format(2), os.path.join(SCANNET_DIR, "step2"), root,
                              steps, steps, step1), device=dev)
    new = sorted(k for k in two.model.state_dict() if k not in sd1)
    check_weight_chain(torch, two, step1, sd1, new, [], "ScanNet step 1 -> step 2")
    counts = scannet_train(torch, card, two, TRAIN_LOSS_KEYS,
                           launches_want(mask_loss_fwd=3 * steps, mask_loss_bwd=3 * steps,
                                         hungarian=steps, select_maps=n_eval, sinkhorn=n_eval),
                           "ScanNet step 2")
    total = {k: total[k] + counts[k] for k in total}
    step2 = os.path.join(two.cfg.OUTPUT_DIR, "model_final.pth")
    del two, sd1
    torch.cuda.empty_cache()

    # (d) `engine/test.py --eval-only` on inference_scannet.yaml (f32,
    # unfused) with step 2's weights, then the offline evaluator and the
    # GeoConsistency tool on its artifacts
    eval_dir = os.path.join(SCANNET_DIR, "eval")
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = test_entry.main([
            "--config-file", os.path.join(REPO, "configs", "inference_scannet.yaml"),
            "--eval-only", "--device", dev.type, "MODEL.WEIGHTS", step2,
            "DATASETS.ROOT_DIR", root, "INPUT.IMAGE_SIZE", str(SCANNET_HW),
            "TEST.EVAL_FULL_SCENE", "True",
            "OUTPUT_DIR", eval_dir])
    secs = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    total = {k: total[k] + counts[k] for k in total}
    line = json.loads(out.getvalue().splitlines()[-1])
    pth = os.path.join(eval_dir, "NopeSAC_instances_predictions.pth")
    opt = os.path.join(eval_dir, "continuous.pkl")
    print(f"[scannet] engine/test.py --eval-only on inference_scannet.yaml over {n_test} pairs: "
          f"{secs:.2f} s with the model build and load; eval_stats {line['eval_stats']}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}; on "
          f"{card}")
    want = launches_want(select_maps=n_eval, sinkhorn=n_eval)
    if rc != 0 or counts != want or not (os.path.exists(pth) and os.path.exists(opt)):
        raise SmokeFailure(f"ScanNet evaluation: exit {rc}, launches {counts} (want {want}), "
                           f"or the artifacts are not written")
    bad = sorted(k for k, v in line["results"].items() if not math.isfinite(v))
    if bad or line["eval_stats"]["pairs"] != n_test:
        raise SmokeFailure(f"ScanNet evaluation: non-finite {bad} or {line['eval_stats']}")
    flags = ["--rcnn-cached-file", pth, "--optimized-dict-path", opt,
             "--dataset-phase", "scannet_test"]
    offline_eval_main(flags + ["--evaluate", "AP", "--num-process", "1"], "ScanNet AP", card,
                      n_test)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        offline_eval_main(flags + ["--evaluate", "camera"], "ScanNet camera", card, n_test)
    print(out.getvalue(), end="")
    med = re.search(r"Median Error \[tran, rot\]:\s*([^,;\s]+),\s*([^,;\s]+)", out.getvalue())
    errs = [float(x) for x in med.groups()] if med else []
    if len(errs) != 2 or not all(math.isfinite(e) for e in errs):
        raise SmokeFailure(f"ScanNet offline camera errors {errs} not finite")
    scannet_geo_consistency(pth, opt)

    # (e) one generated pair at 96x128 through the mapper: the card against the CPU
    cfg = load_train_cfg(SMOKE_CONFIG, [])
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, tuple(cfg.INPUT.IMAGE_SIZE),
                        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, root_dir=root,
                        dataset_kind="scannet")
    batches = [batch_to_device(collate([mapper(pair)]), "cpu")
               for pair in DatasetCatalog.get("scannet_train")]
    check_train_reference(torch, dev, what="ScanNet pair 96x128", batches=batches)
    shutil.rmtree(SCANNET_DIR, ignore_errors=True)  # ~0.9 GB per checkpoint
    print(f"[scannet] launches over (b)-(d): {total}")
    return total


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
    train_want = launches_want(mask_loss_fwd=3 * RANK_STEPS, mask_loss_bwd=3 * RANK_STEPS,
                               hungarian=RANK_STEPS)
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


# B4's per-shape times summed over the 24 calls of an eval batch
B4_TOTALS = ("ms", "unqueued_ms", "host_ms", "plain_ms", "plain_unqueued_ms", "unfused_ms",
             "unfused_unqueued_ms", "bound_ms")


def b4_times(torch, bottleneck, unfused, x, wt, scale, shift, res):
    """One B4 shape's kernel row (`kernel_ms`): the kernel's, its plain
    version's and the unfused cuDNN + ATen sequence's queued and unqueued
    ms per call, and the kernel wrapper's host ms per call."""
    t = kernel_ms(torch, lambda: bottleneck.conv1x1_bn_act_cuda(x, wt, scale, shift,
                                                                residual=res))
    plain = kernel_ms(torch, lambda: bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift,
                                                                     residual=res),
                      warm=2, iters=5)
    lib = kernel_ms(torch, unfused)
    return {"ms": t["ms"], "unqueued_ms": t["unqueued_ms"], "host_ms": t["host_us"] / 1e3,
            "plain_ms": plain["ms"], "plain_unqueued_ms": plain["unqueued_ms"],
            "unfused_ms": lib["ms"], "unfused_unqueued_ms": lib["unqueued_ms"]}


def b4_times_text(t, per="call"):
    """`b4_times`' numbers, queued / unqueued, for a print line."""
    return (f"kernel {t['ms']:.4f} / {t['unqueued_ms']:.4f} ms (queued / unqueued; the "
            f"wrapper's host {1e3 * t['host_ms']:.1f} us per {per}), plain {t['plain_ms']:.4f} "
            f"/ {t['plain_unqueued_ms']:.4f} ms, unfused cuDNN+ATen {t['unfused_ms']:.4f} / "
            f"{t['unfused_unqueued_ms']:.4f} ms")


def time_bottleneck(torch, dev, card):
    """Phase 11: B4 at the eight eval shapes, f32 then bf16, each held to its
    plain version (utils/kernel_checks.py) in the variant the shape must
    take, then timed."""
    from nopesac_torch.ops import bottleneck
    from nopesac_torch.utils.kernel_checks import hold_bottleneck

    F = torch.nn.functional
    b = 2 * N_PAIRS
    rows, total = [], dict.fromkeys(B4_TOTALS, 0.0)
    by_count = {"bytes": 0, "operations": 0}
    for stage, h, w, cout, mid, n_blocks in B4_STAGES:
        for cin, co, residual in ((cout, mid, False), (mid, cout, True)):
            x, wt, scale, shift, res = b4_inputs(torch, dev, len(rows), b, cin, co, h, w, residual)
            _, cfg = hold_bottleneck(x, wt, scale, shift, res, variant="vec")

            def unfused():  # models/resnet.py without B4: ConvNorm, then add and ReLU
                y = F.conv2d(x, wt) * scale[None, :, None, None] + shift[None, :, None, None]
                return F.relu(y + res) if residual else F.relu(y)

            t = b4_times(torch, bottleneck, unfused, x, wt, scale, shift, res)
            bms, by = bound_ms(*b4_cost(b, cin, co, h * w, residual))
            rows.append(dict(t, shape=f"{stage} {cin}->{co}{' +res' if residual else ''}",
                             P=b * h * w, bound_ms=bms, bound_by=by, config=cfg))
            print(f"[B4 bottleneck_tail] {rows[-1]['shape']} (P {b * h * w}, x{n_blocks} per "
                  f"batch): {b4_times_text(t)}, bound {bms:.4f} ms ({by}); holds to its plain "
                  f"version; variant {cfg['variant']}, BM {cfg['bm']}, split {cfg['split']}, "
                  f"{cfg['blocks']} blocks")
            for key in B4_TOTALS:
                total[key] += n_blocks * rows[-1][key]
            by_count[by] += n_blocks
            del x, wt, res
    bf16 = time_bottleneck_bf16(torch, dev, card)
    for dtype, bm, variant in ((torch.float32, 128, "vec"), (torch.float32, 64, "vec"),
                               (torch.bfloat16, 128, "scalar")):
        print(f"[B4 bottleneck_tail] {variant} {str(dtype)[6:]} BM {bm}: "
              f"{bottleneck.kernel_attributes(dtype, bm, variant)} (cudaFuncGetAttributes)")
    for x_load in ("tma", "cp.async"):
        print(f"[B4 bottleneck_tail] wgmma bfloat16 BM 64, X by {x_load}: "
              f"{bottleneck.kernel_attributes(torch.bfloat16, 64, 'wgmma', x_load)} "
              f"(cudaFuncGetAttributes)")
    by = "bytes" if by_count["bytes"] > by_count["operations"] else "operations"
    print(f"[B4 bottleneck_tail] per eval batch ({B4_LAUNCHES} calls): "
          f"{b4_times_text(total, 'batch')}, bound {total['bound_ms']:.4f} ms, on {card}")
    return {"name": "bottleneck_tail", "route": "cuda",
            "source": "nopesac_torch/ops/csrc/bottleneck.cu",
            "replaces": "nopesac_tpu/ops/bottleneck_pallas.py:88",
            **total, "bound_by": by, "library_ms": None, "per_shape": rows, "bf16": bf16}


def hgmma_count():
    """HGMMA instructions (Hopper's warpgroup MMA) in the SASS of the built
    bf16 B4 library, by the toolkit's cuobjdump."""
    from nopesac_torch.ops import _build

    lib = _build._build_dir() / "libbottleneck_wgmma.so"
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SmokeFailure(f"cuobjdump -sass {lib} failed: {out.stderr.strip()[:500]}")
    return len(re.findall(r"\bHGMMA\.", out.stdout))


def time_bottleneck_bf16(torch, dev, card):
    """B4 in bf16 at the eight eval shapes: the wgmma variant, within one bf16
    ulp of its plain version and bit-equal on a second run, its config and
    attributes, timed beside the bf16 sequence the unfused backbone runs
    (cuDNN 1x1 conv, then the ATen affine, add and ReLU), its bound at bf16
    bytes and the dense bf16 tensor-core rate; the HGMMA count of the built
    library."""
    from nopesac_torch.ops import bottleneck
    from nopesac_torch.utils.kernel_checks import hold_bottleneck

    F = torch.nn.functional
    bf = torch.bfloat16
    b = 2 * N_PAIRS
    hgmma = hgmma_count()
    print(f"[B4 bottleneck_tail] bf16 wgmma variant: {hgmma} HGMMA instructions in the SASS of "
          f"libbottleneck_wgmma.so (cuobjdump -sass)")
    if hgmma == 0:
        raise SmokeFailure("the bf16 B4 library has no HGMMA instruction: no tensor-core product")
    total = dict.fromkeys(B4_TOTALS, 0.0)
    by_count = {"bytes": 0, "operations": 0}
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stage, h, w, cout, mid, n_blocks in B4_STAGES:
        for cin, co, residual in ((cout, mid, False), (mid, cout, True)):
            x, wt, scale, shift, res = b4_inputs(torch, dev, 200 + len(rows), b, cin, co, h, w,
                                                 residual, bf)
            _, cfg = hold_bottleneck(x, wt, scale, shift, res, variant="wgmma", twice=True)
            shape = f"{stage} {cin}->{co}{' +res' if residual else ''}"
            w16, s16, t16 = wt.to(bf), scale.to(bf)[None, :, None, None], shift.to(bf)[
                None, :, None, None]

            def unfused():  # the bf16 backbone without B4: ConvNorm, then add and ReLU
                y = F.conv2d(x, w16) * s16 + t16
                return F.relu(y + res) if residual else F.relu(y)

            t = b4_times(torch, bottleneck, unfused, x, wt, scale, shift, res)
            bms, by = bound_ms(*b4_cost(b, cin, co, h * w, residual, elem=2), BF16_TC_FLOP_PER_S)
            attrs = bottleneck.kernel_attributes(bf, cfg["bm"], "wgmma", cfg["x_load"])
            resident = sms * attrs["blocks_per_sm"]
            if cfg["x_load"] == "tma" and cfg["split"] == 1 and cfg["blocks"] != min(
                    cfg["tiles"], resident):
                raise SmokeFailure(f"B4 bf16 at {shape}: {cfg['blocks']} walking blocks, but the "
                                   f"card holds {resident} at once")
            rows.append(dict(t, shape=shape, bound_ms=bms, bound_by=by, config=cfg,
                             attributes=attrs))
            print(f"[B4 bottleneck_tail] bf16 {shape} (x{n_blocks} per batch): "
                  f"{b4_times_text(t)}, bound {bms:.4f} ms ({by}); holds to its plain version, "
                  f"two runs bit-equal; {cfg['variant']} BM {cfg['bm']} BN "
                  f"{bottleneck.TILE_COLS}, X by {cfg['x_load']}, split {cfg['split']}, {cfg['blocks']} blocks (the card holds "
                  f"{resident}); registers {attrs['registers']}, shared {attrs['dynamic_smem']} B, "
                  f"spills {attrs['local_bytes']} B")
            for key in B4_TOTALS:
                total[key] += n_blocks * rows[-1][key]
            by_count[by] += n_blocks
            del x, wt, res
    weight_cast = time_b4_weight_cast(torch, dev, bottleneck)
    by = "bytes" if by_count["bytes"] > by_count["operations"] else "operations"
    print(f"[B4 bottleneck_tail] bf16 per eval batch ({B4_LAUNCHES} calls): "
          f"{b4_times_text(total, 'batch')}, bound {total['bound_ms']:.4f} ms, on {card}")
    return {"name": "bottleneck_tail", "route": "cuda", "dtype": "bfloat16", "variant": "wgmma",
            "source": "nopesac_torch/ops/csrc/bottleneck_wgmma.cu",
            "replaces": "nopesac_tpu/ops/bottleneck_pallas.py:88",
            **total, "bound_by": by, "library_ms": None, "launches": 0, "hgmma": hgmma,
            "per_shape": rows, "weight_cast": weight_cast}


def time_b4_weight_cast(torch, dev, bottleneck):
    """The bf16 B4 wrapper's host time per call at res4 conv1, the shortest
    call of the batch, with the f32 weight the model passes (cast per call)
    and with a bf16 one, and the device's time per call."""
    x, wt, scale, shift, _ = b4_inputs(torch, dev, 3, 2 * N_PAIRS, 1024, 256, 30, 40, False,
                                       torch.bfloat16)
    w16 = wt.to(torch.bfloat16)
    t32 = kernel_ms(torch, lambda: bottleneck.conv1x1_bn_act_cuda(x, wt, scale, shift))
    t16 = kernel_ms(torch, lambda: bottleneck.conv1x1_bn_act_cuda(x, w16, scale, shift))
    print(f"[B4 bottleneck_tail] bf16 res4 1024->256: the wrapper's host {t32['host_us']:.1f} us "
          f"per call with the f32 weight (cast per call), {t16['host_us']:.1f} with a bf16 one, "
          f"the device {1e3 * t16['ms']:.1f} us")
    return {"host_us_f32_weight": t32["host_us"], "host_us_bf16_weight": t16["host_us"],
            "device_ms": t16["ms"]}


def run_fused_path(torch, dev, model, batches, outs, card):
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
    from nopesac_torch.utils import graphs
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_cfg()
    cfg.MODEL.RESNETS.FUSE_TAIL = True
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    fused = build_model_from_cfg(cfg, device=dev)
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
    graphs.drop(fused)  # the counted calls capture and replay: launches count at each replay
    with torch.inference_mode():
        step(*batches[0])  # warm-up
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        fused_outs = [keep(step(*pair)) for pair in batches[1:]]
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
    steps, backbones = {}, {"f32": model.backbone}
    for name, fuse in (("unfused", False), ("fused", True)):
        cfg.MODEL.RESNETS.FUSE_TAIL = fuse
        m16 = build_model_from_cfg(cfg, device=dev)
        m16.load_state_dict(model.state_dict(), strict=True)
        backbones[name] = m16.backbone
        step = make_eval_step(m16, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        with torch.inference_mode():
            step(*batches[0])  # warm-up
            torch.cuda.synchronize()
            LAUNCHES.reset()
            t0 = time.perf_counter()
            outs16 = [keep(step(*pair)) for pair in batches[1:]]
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
    check_bf16_backbone(torch, dev, backbones, batches[1], cfg)
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


def check_bf16_backbone(torch, dev, backbones, pairs, cfg):
    """The fused bf16 backbone (B4's wgmma variant on its 24 identity-block
    tails) against the unfused f32 one at full width, per stage, by the bf16
    rule: max |fused bf16 - f32| <= max(1.5 max |unfused bf16 - f32|, one
    bf16 ulp of max |f32|); with phase 5's seeded weights (FrozenBN at its
    identity statistics) and with trained-like statistics as in phase 12."""
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, device=dev)
    std = torch.tensor(cfg.MODEL.PIXEL_STD, device=dev)
    x = ((torch.cat(pairs).float() - mean) / std).permute(0, 3, 1, 2).contiguous()
    gen = torch.Generator().manual_seed(6)
    stats = {}
    for name, buf in backbones["f32"].state_dict().items():
        if buf.dim() == 1:
            stats[name] = (torch.rand(buf.shape, generator=gen) + 0.5
                           if name.endswith(("weight", "var")) else
                           torch.randn(buf.shape, generator=gen) * 0.1)
    for what in ("seeded", "BN statistics"):
        nets = backbones if what == "seeded" else {
            k: copy.deepcopy(m) for k, m in backbones.items()}
        if what != "seeded":
            for m in nets.values():
                for name, new in stats.items():
                    m.state_dict()[name].copy_(new.to(dev))
        with torch.inference_mode():
            feats = {k: {s: v.float() for s, v in m(x).items()} for k, m in nets.items()}
        rows = {}
        for stage, ref in feats["f32"].items():
            d_fused = float((feats["fused"][stage] - ref).abs().max())
            d_unfused = float((feats["unfused"][stage] - ref).abs().max())
            limit = max(1.5 * d_unfused, bf16_ulp(float(ref.abs().max())))
            rows[stage] = (d_fused, d_unfused, limit)
            if not d_fused <= limit:
                raise SmokeFailure(f"bf16 fused backbone ({what}) at {stage}: max |fused bf16 - "
                                   f"f32| {d_fused:.4e} over the limit {limit:.4e} (unfused bf16 "
                                   f"{d_unfused:.4e})")
        print(f"[bf16 eval] backbone per stage ({what}), max |fused bf16 - f32|, max |unfused bf16 "
              f"- f32|, limit: " + ", ".join(f"{k} {a:.4e} {b:.4e} {c:.4e}"
                                             for k, (a, b, c) in rows.items()))
        del feats, nets


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
    from nopesac_torch.utils import graphs
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
    graphs.drop(fused)  # the split's batches run eagerly, capture and replay: each counts
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
    return out_dir, pairs, results


def write_pairs_json(pairs, path):
    """The pairs as a cached_set json (no in-memory depth or image, no dense
    annotation masks), as tests/test_torch_eval.py writes them."""
    strip = ("depth", "image")
    data = [{k: ({vk: vv for vk, vv in v.items() if vk not in strip}
                 | {"annotations": [{ak: av for ak, av in a.items() if ak != "mask"}
                                    for a in v["annotations"]]}
                 if k in ("0", "1") else v) for k, v in p.items()} for p in pairs]
    with open(path, "w") as f:
        json.dump({"categories": [{"name": "plane", "id": 1}], "data": data}, f)
    return path


OFFLINE_TABLES = {"camera": ["Median Error [tran, rot]:", "Accuracy     [tran(1m), rot(30')]:"],
                  "matching": ["precision2 = ", "recall2 = ", "F-score = "],
                  "AP": [f"{name:>20s}: " for name in AP_ROWS]}


def check_offline_table(stdout, mode, what, card, secs, n_pairs, where):
    """The mode's table printed; its lines and s/pair shown."""
    table = OFFLINE_TABLES[mode]
    lines = stdout.splitlines()
    missing = [t for t in table if not any(line.startswith(t) for line in lines)]
    if missing:
        raise SmokeFailure(f"offline_eval {what}: no {missing} in\n{stdout[-3000:]}")
    print(f"[offline] {what}: " + "; ".join(
        line.strip() for line in lines if any(line.startswith(t) for t in table)))
    print(f"[offline] {what}: {secs / n_pairs:.4f} s/pair ({secs:.2f} s for {n_pairs} pairs, "
          f"{where}), host CPU of {card}")


def offline_eval_cli(flags, what, card, n_pairs):
    """`python -m nopesac_torch.engine.offline_eval` as a user runs it: exit
    0 and its table printed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nopesac_torch.engine.offline_eval"] + flags,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f"offline_eval {what}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    check_offline_table(proc.stdout, flags[flags.index("--evaluate") + 1], what, card, secs,
                        n_pairs, "CLI, process start included")


def offline_eval_main(flags, what, card, n_pairs):
    """The CLI's `main` in this process on the same flags, its output
    captured: exit 0 and its table printed."""
    import contextlib
    import io

    from nopesac_torch.engine import offline_eval

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = offline_eval.cli(flags)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"offline_eval {what}: main returned {rc}\n{out.getvalue()[-3000:]}")
    check_offline_table(out.getvalue(), flags[flags.index("--evaluate") + 1], what, card, secs,
                        n_pairs, "main in process")


def obj_counts(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return (sum(line.startswith("v ") for line in lines),
            sum(line.startswith("f ") for line in lines))


def check_vis_files(out_dir, idx, pred, meshes, affinity, gt_planes):
    """Every file of the pair that the vis CLI lists exists, and each OBJ
    holds the vertices and faces of the mesh it was written from."""
    import numpy as np

    names = [f"{idx}_matching.png"]
    if affinity and pred.get("pred_aff") is not None:
        names.append(f"{idx}_affinity_pred.png")
    for tag, mesh in meshes.items():
        parts = mesh if tag == "scene_textured" else [mesh]
        names.append(f"{idx}_{tag}.obj")
        if tag == "scene_textured":
            names += [f"{idx}_{tag}.mtl"] + [f"{idx}_{tag}_tex{k}.png" for k in range(len(parts))]
        want = (sum(len(p["verts"]) for p in parts), sum(len(p["faces"]) for p in parts))
        got = obj_counts(os.path.join(out_dir, f"{idx}_{tag}.obj"))
        if got != want:
            raise SmokeFailure(f"vis pair {idx}: {tag}.obj has {got} vertices and faces, "
                               f"the mesh {want}")
    n_hyp = len(np.asarray(pred["camera_onePP"]["pred"]["rot"]).reshape(-1, 4))
    want_tags = {"scene", "scene_gt", "scene_textured", "cam_final"} | {
        f"cam_onePP{k}" for k in range(n_hyp)} | ({"scene_gtplanes"} if gt_planes else set())
    missing = [n for n in names if not os.path.exists(os.path.join(out_dir, n))]
    if missing or not want_tags <= set(meshes):
        raise SmokeFailure(f"vis pair {idx}: missing {missing}, meshes {sorted(meshes)}")
    return len(names)


def vis_pair_without_affinity(idx, pred, od, out_dir, h, w, gt_pair):
    """`engine/vis.py:vis_pair` but for its stitched-affinity figure, the one
    file that needs matplotlib: the matching figure, then every mesh."""
    import numpy as np
    from PIL import Image

    from nopesac_torch.engine import vis
    from nopesac_torch.utils.mesh import save_obj, save_obj_textured
    from nopesac_torch.visualization.vis2d import draw_match

    images = tuple(vis.load_image(pred[v].get("file_name", ""), h, w) for v in ("0", "1"))
    match_img = draw_match(images[0][0], images[1][0],
                           [ins["segmentation"] for ins in pred["0"]["instances"]],
                           [ins["segmentation"] for ins in pred["1"]["instances"]],
                           np.argwhere(np.asarray(od["best_assignment"])))
    Image.fromarray(match_img).save(os.path.join(out_dir, f"{idx}_matching.png"))
    meshes = vis.scene_meshes(pred, od, h, w, images, gt_pair, one_plane_cams=True)
    for tag, mesh in meshes.items():
        if tag == "scene_textured":
            save_obj_textured(out_dir, f"{idx}_{tag}", mesh)
        else:
            save_obj(out_dir, f"{idx}_{tag}", mesh)
    return meshes


def run_offline_eval_and_vis(card, entry, planar_out):
    """Phase 20: the offline evaluator and the visualisation on phase 13's
    artifacts, and the visualisation of the planar scene's outputs."""
    import importlib.util
    import pickle
    import shutil
    import types

    import numpy as np

    from nopesac_torch.data.cam_bins import CameraBins
    from nopesac_torch.engine import offline_eval, vis
    from nopesac_torch.evaluation.postprocess import postprocess_batch
    from nopesac_torch.utils.device import LAUNCHES

    out_dir, pairs, online = entry
    h, w = pairs[0]["0"]["height"], pairs[0]["0"]["width"]
    n = len(pairs)
    work = os.path.join(REPO, "output", "offline_eval_vis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pth = os.path.join(out_dir, "NopeSAC_instances_predictions.pth")
    cont = os.path.join(out_dir, "continuous.pkl")
    dsjson = write_pairs_json(pairs, os.path.join(work, "pairs.json"))
    LAUNCHES.reset()

    # the offline evaluator, three modes: AP with forked workers as a user
    # runs the CLI, the others through its main in this process
    base = ["--rcnn-cached-file", pth, "--dataset-json", dsjson, "--dataset-phase", "synthetic"]
    offline_eval_cli(base + ["--optimized-dict-path", cont, "--evaluate", "AP",
                             "--num-process", "2"], "AP, 2 workers", card, n)
    for mode in ("camera", "matching"):
        offline_eval_main(base + ["--optimized-dict-path", cont, "--evaluate", mode], mode, card, n)
    args = types.SimpleNamespace(config_file="", rcnn_cached_file=pth, evaluate="AP",
                                 num_process=1, camera_cached_file="", num_data=-1,
                                 dataset_phase="synthetic", optimized_dict_path=cont,
                                 dataset_json=dsjson, opts=[])
    ev = offline_eval.Evaluator(args)
    if not offline_eval.load_optimized_dict(ev, cont):
        raise SmokeFailure("offline_eval: continuous.pkl not read")
    t0 = time.perf_counter()
    cam = ev.evaluate_camera(ev.optimized_dict)
    cam_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aps = offline_eval.ap_table(ev, 1)
    ap_s = time.perf_counter() - t0
    errs = {"T median err": abs(cam["median_tran_err"] - online["T median err"]),
            "R median err": abs(cam["median_rot_err"] - online["R median err"]),
            "T err < 1.0": abs(cam["tran_acc"] * 100 - online["T err < 1.0"]),
            "R err < 30": abs(cam["rot_acc"] * 100 - online["R err < 30"])}
    print(f"[offline] camera against phase 13's online numbers: {errs} (limit {CAM_TOL})")
    print(f"[offline] AP rows {aps}")
    print(f"[offline] Evaluator in process: camera {cam_s / n:.4f} s/pair, AP (one process) "
          f"{ap_s / n:.4f} s/pair, host CPU of {card}")
    if not all(e <= CAM_TOL for e in errs.values()):
        raise SmokeFailure(f"offline camera numbers differ from the online ones: {errs}")
    if list(aps) != list(AP_ROWS) or not all(math.isfinite(v) for v in aps.values()):
        raise SmokeFailure(f"offline AP rows {aps}")

    # the cached-camera branch: logits one-hot at the GT pose's bins, no
    # best_camera for the odd pairs: their cameras are the bins' centres
    bins = CameraBins(dataset="mp3d")
    keys, tls, rls = [], [], []
    for p in pairs:
        keys.append(p["0"]["file_name"] + p["1"]["file_name"])
        tls.append(np.eye(32)[bins.xyz2class(*p["rel_pose"]["position"])])
        rls.append(np.eye(32)[bins.quat2class(*p["rel_pose"]["rotation"])])
    cam_file = os.path.join(work, "cached_camera_logits.pkl")
    with open(cam_file, "wb") as f:
        pickle.dump({"keys": keys, "logits_sms": {"tran": np.stack(tls), "rot": np.stack(rls)},
                     "gts": {"tran": [p["rel_pose"]["position"] for p in pairs],
                             "rot": [p["rel_pose"]["rotation"] for p in pairs]}}, f)
    with open(cont, "rb") as f:
        half = pickle.load(f)
    for idx in half:
        if idx % 2:
            half[idx]["best_camera"] = None
    half_path = os.path.join(work, "continuous_half.pkl")
    with open(half_path, "wb") as f:
        pickle.dump(half, f)
    for mode in ("AP", "camera"):  # one process: no fork of this process, which holds the card
        offline_eval_main(base + ["--optimized-dict-path", half_path, "--camera-cached-file",
                                  cam_file, "--evaluate", mode, "--num-process", "1"],
                          f"{mode} cached camera", card, n)
    ev = offline_eval.Evaluator(types.SimpleNamespace(**{**vars(args), "camera_cached_file":
                                                         cam_file}))
    for idx in range(1, n, 2):
        got = ev.get_camera_info(idx, 0, 0)
        gt = pairs[idx]["rel_pose"]
        if not (np.array_equal(got["position"], bins.class2xyz(bins.xyz2class(*gt["position"])))
                and np.array_equal(got["rotation"],
                                   bins.class2quat(bins.quat2class(*gt["rotation"])))):
            raise SmokeFailure(f"cached camera of pair {idx}: {got}, not the GT bins' centres")
    print(f"[offline] cached camera: the {n // 2} pairs without best_camera decode the GT "
          f"bins' centres")

    # the visualisation: phase 13's artifacts and the planar scene's outputs,
    # the synthetic renders written as the views' image files
    for lib in ("PIL", "cv2"):
        if importlib.util.find_spec(lib) is None:
            raise SmokeFailure(f"the visualisation needs {lib}, which does not import here")
    from PIL import Image

    drawing = importlib.util.find_spec("matplotlib") is not None
    print("[vis] PIL and OpenCV import; matplotlib "
          + ("imports: engine/vis.py:vis_pair writes every file" if drawing else
             "does not import: the phase writes the matching figure and the meshes "
             "itself, without vis_pair's stitched-affinity figure (the one file that "
             "needs matplotlib)"))
    images = {}
    for p in pairs[:VIS_PAIRS]:
        for v in ("0", "1"):
            images[p[v]["image_id"]] = os.path.join(work, f"{p[v]['image_id']}.png")
            Image.fromarray(p[v]["image"]).save(images[p[v]["image_id"]])
    preds = vis.load_predictions(pth)[:VIS_PAIRS]
    with open(cont, "rb") as f:
        ods = [od for _, od in sorted(pickle.load(f).items())][:VIS_PAIRS]
    for p in preds:
        for v in ("0", "1"):
            p[v]["file_name"] = images[p[v]["image_id"]]
    metas = [{"image_id0": f"planar{b}_0", "image_id1": f"planar{b}_1",
              "file_name0": images[pairs[b]["0"]["image_id"]],
              "file_name1": images[pairs[b]["1"]["image_id"]]} for b in range(VIS_PAIRS)]
    planar_preds, planar_ods = [], []
    for r in postprocess_batch(numpy_tree(planar_out), metas, h, w):
        planar_preds.append({"0": r["0"], "1": r["1"], "pred_aff": r["pred_aff"],
                             "camera_onePP": {"pred": r["camera_onePP"]}})
        planar_ods.append({"best_camera": {"position": r["camera"]["tran"],
                                           "rotation": r["camera"]["rot"]},
                           "gt_camera": {"position": np.zeros(3),
                                         "rotation": np.array([1.0, 0, 0, 0])},
                           "best_assignment": r["pred_assignment"]})
    sets = (("entry point", preds, ods, pairs), ("planar scene", planar_preds, planar_ods, None))
    for what, ps, odicts, gts in sets:
        out = os.path.join(work, "vis_" + what.replace(" ", "_"))
        os.makedirs(out)
        t0 = time.perf_counter()
        n_files, planes = 0, []
        for idx, (pred, od) in enumerate(zip(ps, odicts)):
            gt_pair = None if gts is None else gts[idx]
            if drawing:
                meshes = vis.vis_pair(idx, pred, od, out, h, w, gt_pair=gt_pair,
                                      one_plane_cams=True)
            else:
                meshes = vis_pair_without_affinity(idx, pred, od, out, h, w, gt_pair)
            n_files += check_vis_files(out, idx, pred, meshes, drawing, gts is not None)
            planes.append(len(meshes["scene_textured"]))
        secs = time.perf_counter() - t0
        print(f"[vis] {what}: {n_files} files for {len(ps)} pairs, textured planes per pair "
              f"{planes}; {secs / len(ps):.3f} s/pair, host CPU of {card}")
        if what == "planar scene" and min(planes) <= 2:
            raise SmokeFailure(f"the planar scene's meshes hold {planes} planes per pair")
    counts = LAUNCHES.snapshot()
    if any(counts.values()):
        raise SmokeFailure(f"phase 20 launched kernels: {counts}")


def ablation_batches(cfg, n_batches, n_pairs, seed):
    """`n_batches` batches of `n_pairs` synthetic pairs of the config's size
    with 12 planes per view and their correspondences (the port's
    generator): (pairs, eval samples) per batch."""
    from nopesac_torch.data.mapper import PairMapper
    from nopesac_torch.data.synthetic import make_dataset

    h, w = cfg.INPUT.IMAGE_SIZE
    pairs = make_dataset(n_pairs=n_pairs * n_batches, n_planes=TRAIN_PLANES, seed=seed, h=h, w=w)
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, (h, w), is_train=False)
    chunks = [pairs[k * n_pairs:(k + 1) * n_pairs] for k in range(n_batches)]
    return [(chunk, [mapper(p) for p in chunk]) for chunk in chunks]


def sp_topcam_table(pairs):
    """A SparsePlanes top-1 table of the pairs' GT poses, the first pair's
    quaternion negated (the sign canonicalisation must undo it)."""
    import numpy as np

    table = {}
    for i, d in enumerate(pairs):
        q = np.asarray(d["rel_pose"]["rotation"], np.float32) * (-1.0 if i == 0 else 1.0)
        table[d["0"]["image_id"] + "-" + d["1"]["image_id"]] = {
            "position": np.asarray(d["rel_pose"]["position"], np.float32), "rotation": q}
    return table


def ablation_args(torch, variant, batches, nq, seed):
    """The eval step's keyword arguments of each batch for `variant`: the
    uint8 images, and with (a) `gt_geo`, the GT geometry with its noise
    (`engine/test.py`'s functions, one generator over the batches), with (b)
    `init_cam`, the pickle's poses. On the host; the eval step moves them."""
    import numpy as np

    from nopesac_torch.engine.test import gt_geo_from_samples, sp_topcam_of

    rng = np.random.default_rng(seed)
    table = sp_topcam_table([p for chunk, _ in batches for p in chunk])
    out = []
    for chunk, samples in batches:
        args = {f"image{v}": torch.from_numpy(np.stack([s[f"image{v}"] for s in samples]))
                for v in "01"}
        if variant == "gt_matcher":
            args["gt_geo"] = gt_geo_from_samples(chunk, samples, nq, noise_rng=rng)
        elif variant == "sp_topcam":
            args["init_cam"] = sp_topcam_of(table, chunk)
        out.append(args)
    return out


def ablation_steps(torch, model, depth_model, h, w, cfg):
    from nopesac_torch.engine.predict import make_eval_step

    kw = dict(pixel_mean=cfg.MODEL.PIXEL_MEAN, pixel_std=cfg.MODEL.PIXEL_STD)
    step = make_eval_step(model, h, w, **kw)
    return {"gt_matcher": step, "sp_topcam": step,
            "depth": make_eval_step(depth_model, h, w, **kw)}


def depth_model_of(torch, cfg, model, dev):
    """The model of `cfg` with MODEL.DEPTH_ON on `dev`: `model`'s weights,
    the depth branch seeded."""
    from nopesac_torch.engine.predict import build_model_from_cfg

    cfg = cfg.clone()
    cfg.defrost()
    cfg.MODEL.DEPTH_ON = True
    depth_model = build_model_from_cfg(cfg, device=dev, seed=0)
    missing, unexpected = depth_model.load_state_dict(model.state_dict(), strict=False)
    if unexpected or not missing or not all(
            k.startswith(("sem_seg_head.top_down_depth.", "sem_seg_head.depth.")) for k in missing):
        raise SmokeFailure(f"the DEPTH_ON model's extra keys are not the depth branch: {missing}")
    return depth_model


def check_depth(torch, out, b, h, w, what):
    for v in ("depth0", "depth1"):
        d = out[v]
        if tuple(d.shape) != (b, h, w, 1) or d.dtype != torch.float32 or not bool(
                torch.isfinite(d).all()):
            raise SmokeFailure(f"{what}: {v} is {tuple(d.shape)} {d.dtype}, want ({b}, {h}, {w}, "
                               f"1) float32, finite")


def compare_depth(torch, ref, got, what):
    err = max(float((got[v].cpu() - ref[v].cpu()).abs().max()) / float(ref[v].abs().max())
              for v in ("depth0", "depth1"))
    print(f"[{what}] depth0/depth1 max |diff| / max |ref| {err:.2e}")
    if not err <= DEPTH_TOL:
        raise SmokeFailure(f"{what}: the depth maps disagree ({err:.2e} > {DEPTH_TOL})")


def run_ablations(torch, dev, model, fused, card):
    """Phase 18: the eval ablations (a) the noisy GT-matcher, (b) the
    SparsePlanes top-1 camera and (c) MODEL.DEPTH_ON at full width, each
    beside phase 5's eval step on the same batches; (a) again through the
    fused-tail backbone; the three at 96x128 on the card against the CPU;
    EvalRunner.test with (a) and (c) together."""
    import tempfile

    from nopesac_torch.config.config import get_cfg
    from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
    from nopesac_torch.engine.test import EvalRunner
    from nopesac_torch.utils import graphs
    from nopesac_torch.utils.device import LAUNCHES

    cfg = load_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    t0 = time.perf_counter()
    batches = ablation_batches(cfg, N_BATCHES + 1, N_PAIRS, seed=21)
    depth_model = depth_model_of(torch, cfg, model, dev)
    print(f"[ablations] {N_BATCHES + 1} batches of {N_PAIRS} synthetic pairs ({TRAIN_PLANES} "
          f"planes per view) and the DEPTH_ON model in {time.perf_counter() - t0:.2f} s")
    steps = ablation_steps(torch, model, depth_model, h, w, cfg)
    steps["plain (phase 5)"] = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN,
                                              cfg.MODEL.PIXEL_STD)
    pixel_camera_calls = []
    # a replay runs the head inside its graph and calls no hook: the capture's
    # call reports it at each replay
    hooks = [m.camera_head.pixel_decoder.register_forward_hook(
        lambda *_: graphs.on_replay(lambda: pixel_camera_calls.append(1)))
        for m in (model, depth_model, fused)]
    outs, times = {}, {}
    with torch.inference_mode():
        for variant, step in steps.items():
            args = ablation_args(torch, variant, batches, nq, seed=42)
            for m in (model, depth_model):
                graphs.drop(m)  # the counted calls capture and replay: each counts
            step(**args[0])  # warm-up
            torch.cuda.synchronize()
            LAUNCHES.reset()
            pixel_camera_calls.clear()
            t0 = time.perf_counter()
            outs[variant] = [keep(step(**a)) for a in args[1:]]
            torch.cuda.synchronize()
            times[variant] = (time.perf_counter() - t0) / N_BATCHES * 1e3
            counts = LAUNCHES.snapshot()
            want = launches_want(select_maps=N_BATCHES, sinkhorn=N_BATCHES)
            calls = len(pixel_camera_calls)
            print(f"[ablations] {variant}: {times[variant]:.2f} ms/batch of {N_PAIRS} pairs "
                  f"(wall), launches {counts}, PixelCameraHead calls {calls}, matches per pair "
                  f"{[int(x) for o in outs[variant] for x in o['num_matches']]}")
            if counts != want:
                raise SmokeFailure(f"ablation {variant}: launches {counts}, want {want}")
            if calls != (0 if variant == "sp_topcam" else N_BATCHES):
                raise SmokeFailure(f"ablation {variant}: the PixelCameraHead ran {calls} times")
            for o in outs[variant]:
                check_outputs(torch, o, N_PAIRS, h, w, nq)
                if variant == "depth":
                    check_depth(torch, o, N_PAIRS, h, w, "ablation depth")
        for (chunk, samples), o in zip(batches[1:], outs["gt_matcher"]):
            want = torch.tensor([int(s["corr_valid"].sum()) for s in samples], dtype=torch.int32)
            if not torch.equal(o["num_matches"].cpu(), want):
                raise SmokeFailure("ablation gt_matcher: num_matches is not the GT count")
        for (chunk, _), o in zip(batches[1:], outs["sp_topcam"]):
            rot = o["cameras"]["camera_init"]["rot"].cpu()
            want = torch.stack([torch.tensor(d["rel_pose"]["rotation"], dtype=torch.float32)
                                for d in chunk])
            want = want / want.norm(dim=1, keepdim=True)
            want = torch.where(want[:, :1] < 0, -want, want)
            if not float((rot - want).abs().max()) <= 1e-6:
                raise SmokeFailure("ablation sp_topcam: camera_init is not the pickle's pose")
        print("[ablations] ms/batch (wall, 3 warm batches each) on {}: {}".format(
            card, {k: round(v, 2) for k, v in times.items()}))

        # (a) through the fused-tail backbone
        step = make_eval_step(fused, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
        args = ablation_args(torch, "gt_matcher", batches, nq, seed=42)
        graphs.drop(fused)
        step(**args[0])
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        fused_outs = [keep(step(**a)) for a in args[1:]]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / N_BATCHES * 1e3
        counts = LAUNCHES.snapshot()
        want = launches_want(select_maps=N_BATCHES, sinkhorn=N_BATCHES,
                             bottleneck_tail=B4_LAUNCHES * N_BATCHES)
        print(f"[ablations] gt_matcher fused: {ms:.2f} ms/batch (wall), launches {counts}")
        if counts != want:
            raise SmokeFailure(f"ablation gt_matcher fused: launches {counts}, want {want}")
        for k, (o, r) in enumerate(zip(fused_outs, outs["gt_matcher"])):
            compare_with_cpu(torch, r, o, f"ablation gt_matcher fused batch {k}",
                             versus="fused vs unfused")
    for hook in hooks:
        hook.remove()
    del outs, fused_outs

    # the card against the CPU at 96x128
    small = load_cfg((96, 128))
    small_batches = ablation_batches(small, 1, 2, seed=22)
    per_device = {}
    for d in ("cpu", dev):
        m = build_model_from_cfg(small, device=d, seed=0)
        per_device[d] = ablation_steps(torch, m, depth_model_of(torch, small, m, d), 96, 128, small)
    for variant in ABLATIONS:
        args = ablation_args(torch, variant, small_batches, nq, seed=42)[0]
        ref = per_device["cpu"][variant](**args)
        got = per_device[dev][variant](**args)
        compare_with_cpu(torch, ref, got, f"ablation {variant} 96x128")
        if variant == "depth":
            compare_depth(torch, ref, got, "ablation depth 96x128")
    del per_device

    # the entry point with (a) and (c) together
    out_dir = os.path.join(REPO, "output", "ablation_entry_point")
    ecfg = get_cfg()
    ecfg.merge_from_file(CONFIG)
    ecfg.merge_from_list(["MODEL.WEIGHTS", "", "MODEL.DEPTH_ON", "True",
                          "TEST.POSE_REFINEMENT_WITH_GT_MATCHERS", "True",
                          "TEST.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS", "True",
                          "DATASETS.TEST", '("synthetic_test",)', "OUTPUT_DIR", out_dir])
    ecfg.freeze()
    pairs = [p for chunk, _ in ablation_batches(ecfg, 1, ABLATION_PAIRS, seed=23) for p in chunk]
    runner = EvalRunner(ecfg, depth_model)
    LAUNCHES.reset()
    results = runner.test(dataset_list=pairs)
    counts = LAUNCHES.snapshot()
    n = ABLATION_PAIRS // N_PAIRS
    want = launches_want(select_maps=n, sinkhorn=n)
    keys = ("depth_l1_dist", "T median err", "R median err", "T err < 1.0", "R err < 30")
    print(f"[ablations] EvalRunner.test (GT-matcher with noise + DEPTH_ON) over {ABLATION_PAIRS} "
          f"pairs: {runner.last_eval_stats}, launches {counts}, metrics "
          f"{ {k: round(float(results[k]), 4) for k in keys if k in results} } on {card}")
    if counts != want:
        raise SmokeFailure(f"ablation entry point launches {counts}, want {want}")
    bad = [k for k in keys if k not in results or not math.isfinite(float(results[k]))]
    if bad:
        raise SmokeFailure(f"ablation entry point: metrics missing or not finite: {bad}")
    with tempfile.TemporaryDirectory() as tmp:  # (b) through the entry point: the pickle read
        import pickle

        path = os.path.join(tmp, "sp_top1.pkl")
        with open(path, "wb") as f:
            pickle.dump(sp_topcam_table(pairs), f)
        scfg = ecfg.clone()
        scfg.defrost()
        scfg.merge_from_list(["MODEL.DEPTH_ON", "False",
                              "TEST.POSE_REFINEMENT_WITH_GT_MATCHERS", "False",
                              "MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON", "True",
                              "MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_PATH", path])
        sp_results = EvalRunner(scfg, model).test(dataset_list=pairs)
    print(f"[ablations] EvalRunner.test (SP top-1 camera): "
          f"{ {k: round(float(sp_results[k]), 4) for k in keys[1:]} }")
    if not all(math.isfinite(float(sp_results[k])) for k in keys[1:]):
        raise SmokeFailure("ablation entry point (SP top-1 camera): metrics not finite")


def run_depth_train_path(torch, dev, card, batches, f32_ms, f32_peak):
    """Phase 19: the DEPTH_ON train step (f32, REMAT off) on phase 9's
    batches, then one step of the shipped bf16 policy with DEPTH_ON and the
    pixel path in bf16, then phase 10's reference with DEPTH_ON and SGD."""
    from nopesac_torch.engine.train import TrainStep, build_train_model

    size = ["SOLVER.IMS_PER_BATCH", str(TRAIN_PAIRS), "INPUT.IMAGE_SIZE", "(480, 640)",
            "MODEL.DEPTH_ON", "True"]
    cfg = load_train_cfg(TRAIN_CONFIG, F32_TRAIN + size)
    keys = sorted(TRAIN_LOSS_KEYS + ["loss_depth_pixel"])
    _, ms, peak = timed_train_steps(torch, cfg, batches, card, "f32, REMAT off, DEPTH_ON",
                                    loss_keys=keys)
    print(f"[train depth] ms/step: DEPTH_ON {ms:.2f} against phase 9's {f32_ms:.2f}; peak memory "
          f"GiB {peak / 2**30:.2f} against {f32_peak / 2**30:.2f}; {TRAIN_PAIRS} pairs at "
          f"480x640 on {card}")

    # the shipped bf16 policy keeps the pixel path f32 in training
    # (FPN_TRAIN_DTYPE float32); with it bf16 the depth branch computes in bf16
    cfg = load_train_cfg(TRAIN_CONFIG, size + ["MODEL.FPN_TRAIN_DTYPE", "bfloat16"])
    model = build_train_model(cfg, device=dev, seed=0)
    step = TrainStep(model, cfg, seed=0)
    dtypes = []
    hook = model.sem_seg_head.depth.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
    metrics = step(batches[0])
    torch.cuda.synchronize()
    hook.remove()
    bad = sorted(k for k, v in metrics.items() if not math.isfinite(float(v)))
    print(f"[train depth] bf16 policy (FPN_TRAIN_DTYPE bfloat16), one step: depth head output "
          f"{dtypes}, loss_depth_pixel {float(metrics['loss_depth_pixel']):.4f}, total "
          f"{float(metrics['total_loss']):.4f}, skipped {float(metrics['skipped_nonfinite'])}")
    if dtypes != [torch.bfloat16] or bad or float(metrics["skipped_nonfinite"]) != 0.0:
        raise SmokeFailure(f"bf16 DEPTH_ON step: depth head {dtypes}, non-finite {bad}")
    del model, step
    torch.cuda.empty_cache()

    got = check_train_reference(torch, dev, ["MODEL.DEPTH_ON", "True", "SOLVER.OPTIMIZER", "SGD"],
                                "train reference 96x128, DEPTH_ON + SGD")
    if "loss_depth_pixel" not in got:
        raise SmokeFailure("train reference DEPTH_ON: no loss_depth_pixel")


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def time_tree(torch, tree):
    """`--time-tree`: B1 and B2 of the port in `tree` timed by this script
    (`kernel_ms` over 50 warm calls, device events under the profiler), and
    B4 in f32 and bf16 at the eight eval shapes on phase 11's inputs
    (`kernel_ms` over 20 calls, queued and unqueued, summed over the 24
    calls of an eval batch); one JSON line with the card's name and power
    limit."""
    from nopesac_torch.ops import bottleneck

    dev = torch.device("cuda", 0)
    _, card = phase_device(torch)
    result = {"tree": os.path.relpath(tree, REPO), "card": card}
    with torch.inference_mode():
        for name, call in eval_path_calls(torch, dev).items():
            prof = device_events(torch, call)
            result[name] = dict(kernel_ms(torch, call, iters=50),
                                device_events_per_call=prof["per_call"],
                                device_ms=prof["device_ms"])
        for dtype, seed, key in ((torch.float32, 0, "f32"), (torch.bfloat16, 200, "bf16")):
            b4 = {"ms": 0.0, "unqueued_ms": 0.0, "host_ms": 0.0, "per_shape": {}}
            for stage, h, w, cout, mid, n_blocks in B4_STAGES:
                for cin, co, residual in ((cout, mid, False), (mid, cout, True)):
                    x, wt, scale, shift, res = b4_inputs(torch, dev, seed + len(b4["per_shape"]),
                                                         2 * N_PAIRS, cin, co, h, w, residual,
                                                         dtype)
                    t = kernel_ms(torch, lambda: bottleneck.conv1x1_bn_act_cuda(
                        x, wt, scale, shift, residual=res))
                    b4["per_shape"][f"{stage} {cin}->{co}"] = t
                    b4["ms"] += n_blocks * t["ms"]
                    b4["unqueued_ms"] += n_blocks * t["unqueued_ms"]
                    b4["host_ms"] += n_blocks * t["host_us"] / 1e3
            result[f"bottleneck_tail_{key}"] = b4
    print(json.dumps(result))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-tree", default=None, metavar="DIR",
                    help="only time B1, B2 and B4 bf16 of the port in DIR (see above)")
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
        kernels = [time_select(torch, dev), time_sinkhorn(torch, dev)]
        h1_events = hungarian_events(torch, dev)
        counts, model, batches, outs, _ = run_main_path(torch, dev, card)
        planar_out = run_planar_scene(torch, dev, model, batches[0], card)
        b4 = time_bottleneck(torch, dev, card)
        fused_counts, fused = run_fused_path(torch, dev, model, batches, outs, card)
        counts["bottleneck_tail"] = fused_counts["bottleneck_tail"]
        entry = run_entry_point(torch, dev, fused, planar_out, card)
        run_offline_eval_and_vis(card, entry, planar_out)
        bf16_counts = run_bf16_eval_path(torch, dev, model, fused, batches, card)
        b4["bf16"]["launches"] = bf16_counts["bottleneck_tail"]
        run_ablations(torch, dev, model, fused, card)
        del model, fused, batches, outs, planar_out
        torch.cuda.empty_cache()
        kernels += time_mask_loss(torch, dev)
        train_counts, step_ms, step_peak, train_batches = run_train_path(torch, dev, card)
        counts.update({k: v for k, v in train_counts.items()
                       if k.startswith("mask_loss") or k == "hungarian"})
        kernels.append(check_hungarian(torch, dev, card, train_batches, h1_events))
        check_train_reference(torch, dev)
        bf16_train_counts = run_bf16_train_path(torch, dev, card, train_batches, step_ms,
                                                step_peak)
        run_depth_train_path(torch, dev, card, train_batches, step_ms, step_peak)
        del train_batches
        torch.cuda.empty_cache()
        run_trainer(torch, dev, card, step_ms)
        run_ranks(torch, card)
        scannet_counts = run_scannet(torch, dev, card)
        kernels.append(b4)
    except (SmokeFailure, AssertionError) as e:  # AssertionError: utils/kernel_checks.py
        print(f"chip_smoke: FAILED: {e!r}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["launches_scannet"] = scannet_counts[k["name"]]
        if k["name"] == "bottleneck_tail":  # one counter for both dtypes
            k["bf16"]["launches_scannet"] = scannet_counts["bottleneck_tail"]
        if k["name"].startswith("mask_loss"):  # the bf16-logit variant on phase 16's path
            k["bf16"]["launches"] = bf16_train_counts[k["name"] + "_bf16"]
            k["bf16"]["launches_scannet"] = scannet_counts[k["name"] + "_bf16"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
