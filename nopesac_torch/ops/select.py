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
    gated = torch.where(valid[:, :, None, None], scaled, scaled.new_tensor(-1.0))
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


def select_maps_cuda(mask_prob: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                     thr: float, out_h: int, out_w: int):
    """Launch `csrc/select.cu` on bf16 probabilities [B, NQ, h, w]."""
    b, nq, h, w = mask_prob.shape
    dev = mask_prob.device
    if dev.type != "cuda":
        raise ValueError(f"select kernel takes CUDA tensors, got {dev}")
    if mask_prob.dtype != torch.bfloat16:
        raise TypeError(f"select kernel takes bf16 probabilities, got {mask_prob.dtype}")
    if score.shape != (b, nq) or valid.shape != (b, nq):
        raise ValueError(f"score/valid must be [{b}, {nq}], got {tuple(score.shape)}, "
                         f"{tuple(valid.shape)}")
    if not (score.device == dev and valid.device == dev):
        raise ValueError("prob, score and valid must lie on one device")
    refuse_autograd(KERNEL, mask_prob, score)
    if out_h != 4 * h or out_w != 4 * w:
        raise ValueError(f"select kernel is compiled for the 4x upsample of every config; got "
                         f"{h}x{w} -> {out_h}x{out_w}")
    lib = _build.load("select")
    prob = mask_prob.contiguous()
    score = score.to(torch.float32).contiguous()
    valid = valid.to(torch.uint8).contiguous()
    seg = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    mx = torch.empty((b, out_h, out_w), dtype=torch.float32, device=dev)
    stats = torch.empty((b, _NSTAT, nq), dtype=torch.float32, device=dev)
    acc = torch.empty((b, _NSTAT, nq), dtype=torch.int64, device=dev)
    fn = lib.nopesac_select_maps
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(prob.data_ptr(), score.data_ptr(), valid.data_ptr(), seg.data_ptr(),
                 mx.data_ptr(), stats.data_ptr(), acc.data_ptr(), b, nq, h, w, out_h, out_w,
                 float(thr), stream)
    _build.check(err, "nopesac_select_maps")
    LAUNCHES.bump(KERNEL)
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
