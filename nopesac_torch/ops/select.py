"""Kernel B1: fused mask upsample + per-pixel argmax + per-query plane stats.

Counterpart of the JAX package's `ops/select_pallas.py:fused_select_maps`.
On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/select.cu`); on a CPU tensor it runs `select_maps_plain`, which
materialises the full [B, NQ, H, W] maps the kernel avoids.

Outputs (everything select_planes needs downstream):
  seg_ids    [B, H, W] i32  — argmax_q of (valid ? score_q * up(prob_q) : -1)
  max_scaled [B, H, W] f32  — the corresponding max value
  stats      [B, 7, NQ] f32 — per query: cnt_gate, sumx_gate, sumy_gate,
             cnt_nogate, sumx_nogate, sumy_nogate, orig_count (see STAT_NAMES)
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import LAUNCHES, refuse_autograd
from . import _build

STAT_NAMES = ("cnt_gate", "sumx_gate", "sumy_gate",
              "cnt_nogate", "sumx_nogate", "sumy_nogate", "orig_count")
_NSTAT = len(STAT_NAMES)
KERNEL = "select_maps"


def select_maps_plain(mask_prob: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                      thr: float, out_h: int, out_w: int):
    """Plain PyTorch version: bilinear upsample (align_corners=False),
    argmax/max over queries and the 7 stats, as the JAX package's
    `_fused_select_maps_xla` computes them."""
    b, nq, h, w = mask_prob.shape
    f32 = torch.float32
    up = F.interpolate(mask_prob.to(f32), size=(out_h, out_w), mode="bilinear",
                       align_corners=False)
    scaled = up * score.to(f32)[:, :, None, None]
    gated = torch.where(valid[:, :, None, None], scaled, -1.0)
    seg = torch.argmax(gated, dim=1).to(torch.int32)
    mx = torch.amax(gated, dim=1)

    q_ids = torch.arange(nq, dtype=torch.int32, device=seg.device)[None, :, None, None]
    m_n = seg[:, None] == q_ids
    m_g = m_n & (mx[:, None] > thr)
    xs = (torch.arange(out_w, dtype=f32, device=seg.device) / out_w)[None, None, None, :]
    ys = (torch.arange(out_h, dtype=f32, device=seg.device) / out_h)[None, None, :, None]

    def sums(m):
        mf = m.to(f32)
        return mf.sum(dim=(2, 3)), (mf * xs).sum(dim=(2, 3)), (mf * ys).sum(dim=(2, 3))

    cg, sxg, syg = sums(m_g)
    cn, sxn, syn = sums(m_n)
    oc = (up >= thr).to(f32).sum(dim=(2, 3))
    stats = torch.stack([cg, sxg, syg, cn, sxn, syn, oc], dim=1)
    return seg, mx, stats


# 4x phase taps of `csrc/select.cu`: output 4i + d reads low-res (i + off,
# i + off + 1) with weights (w_lo, w_hi), the indices clamped to the map
PHASE_TAPS = ((-1, 0.375, 0.625), (-1, 0.125, 0.875), (0, 0.875, 0.125), (0, 0.625, 0.375))


def _phase_taps(n: int, device, low_edge: bool):
    d = torch.arange(4 * n, device=device) % 4
    off = torch.tensor([t[0] for t in PHASE_TAPS], device=device)[d]
    w_lo = torch.tensor([t[1] for t in PHASE_TAPS], dtype=torch.float64, device=device)[d]
    w_hi = torch.tensor([t[2] for t in PHASE_TAPS], dtype=torch.float64, device=device)[d]
    lo = torch.arange(4 * n, device=device) // 4 + off
    lo, hi = lo.clamp(0, n - 1), (lo + 1).clamp(0, n - 1)
    if low_edge:  # ATen's clamp at index 0: taps (0, 1), weights (1, 0)
        lo[:2], hi[:2], w_lo[:2], w_hi[:2] = 0, min(1, n - 1), 1.0, 0.0
    return lo, hi, w_lo, w_hi


def _tap(w_lo, lo, w_hi, hi):
    """fma(w_lo, lo, f32(w_hi * hi)) rounded once to f32: w_lo * lo is exact
    in f64 (an f32 times a multiple of 1/8) and so is the f64 sum."""
    return (w_lo * lo.double() + (w_hi * hi.double()).float().double()).float()


def upsample4_phase_plain(x: torch.Tensor) -> torch.Tensor:
    """[..., h, w] f32 -> [..., 4h, 4w]: the 4x bilinear upsample
    (align_corners=False) as the kernel computes it: the constant phase taps
    with clamped indices, column taps first, then row taps, each
    fma(w_lo, lower, w_hi * upper); at the low row edge ATen's clamped taps."""
    h, w = x.shape[-2:]
    xl, xh, axl, axh = _phase_taps(w, x.device, low_edge=False)
    yl, yh, ayl, ayh = _phase_taps(h, x.device, low_edge=True)
    cols = _tap(axl, x[..., xl], axh, x[..., xh])  # [..., h, 4w]
    return _tap(ayl[:, None], cols[..., yl, :], ayh[:, None], cols[..., yh, :])


# per (device, stream): [B] u32, zero between calls. Launches on one stream
# run in order, so no two calls share a ticket at once; the last block of
# each view resets its ticket
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
last_config: dict = {}  # the config of the latest CUDA launch


def _tickets(b: int, dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < b:
        t = torch.zeros(max(b, 16), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def kernel_attributes(variant: str, nq: int) -> dict:
    """Registers, static and dynamic shared memory, spill bytes and resident
    blocks per SM of the vec or scalar variant at nq queries
    (cudaFuncGetAttributes), for the record of a run on the card."""
    return _build.attributes("select", "nopesac_select_maps_attrs",
                             ("registers", "static_smem", "dynamic_smem", "local_bytes",
                              "blocks_per_sm"), int(variant == "vec"), nq)


# prob, score, valid, seg, max, stats, partials, tickets; b, nq, h, w, out_h,
# out_w; thr, vec, stream
_SIGNATURE = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def select_maps_cuda(mask_prob: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                     thr: float, out_h: int, out_w: int):
    """Launch `csrc/select.cu` on bf16 probabilities [B, NQ, h, w], f32
    scores and bool (or uint8) validity [B, NQ]: one launch per call."""
    b, nq, h, w = mask_prob.shape
    dev = mask_prob.device
    if dev.type != "cuda":
        raise ValueError(f"select kernel takes CUDA tensors, got {dev}")
    if mask_prob.dtype != torch.bfloat16:
        raise TypeError(f"select kernel takes bf16 probabilities, got {mask_prob.dtype}")
    if score.shape != (b, nq) or valid.shape != (b, nq):
        raise ValueError(f"score/valid must be [{b}, {nq}], got {tuple(score.shape)}, "
                         f"{tuple(valid.shape)}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"select kernel takes bool or uint8 validity, got {valid.dtype}")
    if not (score.device == dev and valid.device == dev):
        raise ValueError("prob, score and valid must lie on one device")
    refuse_autograd(KERNEL, mask_prob, score)
    if out_h != 4 * h or out_w != 4 * w:
        raise ValueError(f"select kernel is compiled for the 4x upsample of every config; got "
                         f"{h}x{w} -> {out_h}x{out_w}")
    if nq < 1:
        raise ValueError("select kernel needs at least one query")
    prob = mask_prob.contiguous()
    score = score.to(torch.float32).contiguous()
    valid = valid.contiguous()
    vec = w % 8 == 0 and prob.data_ptr() % 16 == 0
    per_view = _build.size("select", "nopesac_select_maps_partials", nq, h, w)
    seg = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    mx = torch.empty((b, out_h, out_w), dtype=torch.float32, device=dev)
    stats = torch.empty((b, _NSTAT, nq), dtype=torch.float32, device=dev)
    partials = torch.empty((b, per_view), dtype=torch.int32, device=dev)
    fn = _build.entry("select", "nopesac_select_maps", _SIGNATURE)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _tickets(b, dev, stream)
        fn(prob.data_ptr(), score.data_ptr(), valid.data_ptr(), seg.data_ptr(),
           mx.data_ptr(), stats.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
           b, nq, h, w, out_h, out_w, float(thr), int(vec), stream)
    LAUNCHES.bump(KERNEL)
    last_config.clear()
    last_config.update({"variant": "vec" if vec else "scalar",
                        "blocks": b * -(-w // 32) * -(-h // 8)})
    return seg, mx, stats


def fused_select_maps(mask_prob: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                      thr: float, out_h: int, out_w: int):
    """seg_ids [B,H,W] i32, max_scaled [B,H,W] f32, stats [B,7,NQ] f32.

    The probabilities are rounded to bf16 first on both paths, so threshold
    and argmax decisions near the boundary do not depend on the device. The
    upsample ratio must be an integer, as for the TPU kernel; the CUDA
    kernel takes the 4x ratio of every config."""
    b, nq, h, w = mask_prob.shape
    if out_h % h or out_w % w:
        raise ValueError(f"select needs integer upsample ratios, got {h}x{w} -> "
                         f"{out_h}x{out_w}")
    prob = mask_prob.to(torch.bfloat16)
    if prob.device.type == "cpu":
        return select_maps_plain(prob.to(torch.float32), score, valid, thr, out_h, out_w)
    return select_maps_cuda(prob, score, valid, thr, out_h, out_w)
