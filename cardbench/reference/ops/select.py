"""B1's operation in plain PyTorch (the port's `ops/select.py:select_maps_plain`):
fused mask upsample + per-pixel argmax + per-query plane stats, on the
probabilities rounded to bf16 as the port rounds them.

Outputs (everything select_planes needs downstream):
  seg_ids    [B, H, W] i32  — argmax_q of (valid ? score_q * up(prob_q) : -1)
  max_scaled [B, H, W] f32  — the corresponding max value
  stats      [B, 7, NQ] f32 — per query: cnt_gate, sumx_gate, sumy_gate,
             cnt_nogate, sumx_nogate, sumy_nogate, orig_count (see STAT_NAMES)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


STAT_NAMES = ("cnt_gate", "sumx_gate", "sumy_gate",
              "cnt_nogate", "sumx_nogate", "sumy_nogate", "orig_count")
_NSTAT = len(STAT_NAMES)


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
    return select_maps_plain(prob.to(torch.float32), score, valid, thr, out_h, out_w)
