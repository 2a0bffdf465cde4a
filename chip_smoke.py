#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`nopesac_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. device: name, capability (>= 9.0) and nvidia-smi's name and power limit;
  2. build: every `nopesac_torch/ops/csrc/*.cu` with nvcc, in parallel;
  3. B1 (select_maps) at the main-path shapes, kernel against its plain
     PyTorch version: seg, max and the counts bit-equal, sums to rtol 1e-5;
  4. B2 (sinkhorn) at [4, 50, 50], 200 iterations, masked: kernel against its
     plain version, atol 1e-4 where |ref| < 1e4;
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
     kernels) against the CPU (through their plain versions).
Phases 6 and 7 hold the card to the CPU as the CPU is held to JAX in
tests/test_torch_slice.py: valid planes equal, labels agree on >= 99.9% of
pixels, log-scores within 1.5e-3 and every camera within 1e-3.
Then one JSON line with every kernel's launches, error and times, and, last,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Kernel times are CUDA-event means over many warm launches. `bound_ms` is the
larger of bytes moved / 3.35 TB/s and f32 operations / 67 TFLOP/s (H100 SXM
published peaks).
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "inference_mp3d.yaml")
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
N_PAIRS = 4        # TEST.IMS_PER_BATCH
N_BATCHES = 3
SINKHORN_ITERS = 200


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


def check_select(torch, dev):
    from nopesac_torch.ops import select
    b, nq, h, w, out_h, out_w, thr = 2 * N_PAIRS, 50, 120, 160, 480, 640, 0.5
    gen = torch.Generator(device=dev).manual_seed(1)
    prob, score, valid = select_inputs(torch, gen, b, nq, h, w, dev)
    prob16 = prob.to(torch.bfloat16)
    seg_k, mx_k, st_k = select.select_maps_cuda(prob16, score, valid, thr, out_h, out_w)
    seg_p, mx_p, st_p = select.select_maps_plain(prob16.float(), score, valid, thr, out_h, out_w)
    torch.cuda.synchronize()
    n_seg = int((seg_k != seg_p).sum())
    n_mx = int((mx_k != mx_p).sum())
    err = float((mx_k - mx_p).abs().max())
    counts = [0, 3, 6]
    n_cnt = int((st_k[:, counts] != st_p[:, counts]).sum())
    sums = [1, 2, 4, 5]
    sum_ok = torch.allclose(st_k[:, sums], st_p[:, sums], rtol=1e-5, atol=0.0)
    print(f"[B1 select_maps] seg mismatches {n_seg}, max mismatches {n_mx} "
          f"(max |diff| {err:.3e}), count mismatches {n_cnt}, sums within rtol 1e-5: {sum_ok}; "
          f"all-invalid view labels all 0: {bool((seg_k[0] == 0).all())}")
    if n_seg or n_mx or n_cnt or not sum_ok or not bool((seg_k[0] == 0).all()):
        raise SmokeFailure("B1 kernel disagrees with its plain version")
    ms = cuda_ms(torch, lambda: select.select_maps_cuda(prob16, score, valid, thr, out_h, out_w),
                 iters=50)
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
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_sinkhorn(torch, dev):
    from nopesac_torch.core.sinkhorn import masked_ot_prologue
    from nopesac_torch.ops import sinkhorn
    b, m, n, iters = N_PAIRS, 50, 50, SINKHORN_ITERS
    gen = torch.Generator(device=dev).manual_seed(2)
    scores = torch.randn((b, m, n), generator=gen, device=dev) * 3.0
    row = torch.rand((b, m), generator=gen, device=dev) > 0.4
    col = torch.rand((b, n), generator=gen, device=dev) > 0.4
    z, mu, nu, norm = masked_ot_prologue(scores, torch.tensor(1.0, device=dev), row, col)
    got = sinkhorn.sinkhorn_cuda(z, mu, nu, norm, iters)
    ref = sinkhorn.sinkhorn_plain(z, mu, nu, norm, iters)
    torch.cuda.synchronize()
    # 200 dependent iterations compound ulp differences of expf/logf and of
    # the reduction order; the -1e5 masked band is left out
    keep = ref.abs() < 1e4
    err = float((got - ref).abs()[keep].max())
    print(f"[B2 sinkhorn] max |kernel - plain| {err:.3e} over {int(keep.sum())} entries "
          f"(finite: {bool(torch.isfinite(got).all())})")
    if not err <= 1e-4 or not bool(torch.isfinite(got).all()):
        raise SmokeFailure("B2 kernel disagrees with its plain version")
    ms = cuda_ms(torch, lambda: sinkhorn.sinkhorn_cuda(z, mu, nu, norm, iters), iters=50)
    plain_ms = cuda_ms(torch, lambda: sinkhorn.sinkhorn_plain(z, mu, nu, norm, iters),
                       warm=1, iters=3)
    r, c = m + 1, n + 1
    n_bytes = 4 * (2 * b * r * c + b * (r + c) + b)  # z in, out, marginals, norm
    n_ops = b * iters * 2 * r * c * 5                 # add, max, sub, exp, sum per entry and pass
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"[B2 sinkhorn] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
          f"({by}: {n_bytes} B, {n_ops} flop)")
    return {"name": "sinkhorn", "route": "cuda", "source": "nopesac_torch/ops/csrc/sinkhorn.cu",
            "replaces": "nopesac_tpu/ops/sinkhorn_pallas.py:87", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}


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
    for name, n in counts.items():
        if n != N_BATCHES:
            raise SmokeFailure(f"kernel {name} launched {n} times in {N_BATCHES} batches")
    return counts, model, batches[0]


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


def compare_with_cpu(torch, ref, got, what):
    """The card's outputs against the CPU's, at the slice's tolerances."""
    errs = {}
    for view in ("view0", "view1"):
        if not torch.equal(got[view]["valid"].cpu(), ref[view]["valid"]):
            raise SmokeFailure(f"{what}, {view}: valid planes differ between the card and the CPU")
        errs[f"{view}.seg_agree"] = float(
            (got[view]["seg_gated"].cpu() == ref[view]["seg_gated"]).float().mean())
    if not torch.equal(got["num_matches"].cpu(), ref["num_matches"]):
        raise SmokeFailure(f"{what}: the number of matches differs between the card and the CPU")
    keep = ref["log_scores"].abs() < 1e4
    errs["log_scores"] = float((got["log_scores"].cpu() - ref["log_scores"]).abs()[keep].max())
    errs["cameras"] = max(float((got["cameras"][c][k].cpu() - v).abs().max())
                          for c, d in ref["cameras"].items() for k, v in d.items())
    print(f"[{what}] card vs CPU: {errs}")
    if (min(errs["view0.seg_agree"], errs["view1.seg_agree"]) < 0.999
            or not errs["log_scores"] <= 1.5e-3 or not errs["cameras"] <= 1e-3):
        raise SmokeFailure(f"{what}: the card disagrees with the CPU reference")


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


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import nopesac_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the nopesac_torch package is missing next to this script ({e})",
              file=sys.stderr)
        return 2
    from nopesac_torch.utils.device import set_f32_parity
    set_f32_parity()
    dev = torch.device("cuda", 0)
    try:
        name, card = phase_device(torch)
        phase_build()
        kernels = [check_select(torch, dev), check_sinkhorn(torch, dev)]
        counts, model, images = run_main_path(torch, dev, card)
        run_planar_scene(torch, dev, model, images, card)
        check_small_reference(torch, dev)
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
