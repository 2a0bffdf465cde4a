"""B3's operation in plain PyTorch (the port's `ops/mask_loss.py:focal_dice_plain`):
4x upsample + sigmoid-focal + dice sums of matched mask logits, differentiated
by autograd.

For each (batch, query) with a matched GT index it returns four [B, NQ] f32
sums over the full-resolution mask: sum alpha_t * BCE * (1 - p_t)^2,
sum sigmoid(z) * t, sum sigmoid(z) and sum t, where z is the 4x bilinear
upsample of the query's mask logits (half-pixel centres, taps clamped at the
edges) and t the matched uint8 GT mask. Unmatched queries give exact zeros.
bf16 logits are widened to f32; their gradient is rounded back to bf16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


RATIO = 4  # mask logits sit at 1/4 of the image in every config

# output index i of a 4x upsample reads inputs (lo, lo + 1), lo = i // 4 - 1
# for i % 4 < 2 and i // 4 otherwise, with weight 1 - frac and frac
_FRAC = (0.625, 0.875, 0.125, 0.375)


def _taps(n: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, w_lo, w_hi) of the 4n outputs of a 4x upsample of n inputs,
    the taps clamped to [0, n)."""
    i = torch.arange(RATIO * n, device=device)
    k, r = i // 4, i % 4
    lo = torch.where(r < 2, k - 1, k)
    frac = torch.tensor(_FRAC, dtype=torch.float32, device=device)[r]
    return lo.clamp(0, n - 1), (lo + 1).clamp(0, n - 1), 1.0 - frac, frac


def upsample4(x: torch.Tensor) -> torch.Tensor:
    """[..., h, w] -> [..., 4h, 4w] bilinear, half-pixel centres, taps clamped:
    columns first within each input row, then rows, as the kernel does."""
    h, w = x.shape[-2:]
    xl, xh, ax, bx = _taps(w, x.device)
    yl, yh, ay, by = _taps(h, x.device)
    cols = ax * x[..., xl] + bx * x[..., xh]  # [..., h, 4w]
    return ay[:, None] * cols[..., yl, :] + by[:, None] * cols[..., yh, :]


# the adjoint of the 4x upsample: src index k reads outputs 4k-2 .. 4k+5 with
# these weights; outputs past an edge do not exist, and the two outputs next
# to an edge carry weight 1 (their clamped tap adds the missing part)
ADJOINT_TAPS = (0.125, 0.375, 0.625, 0.875, 0.875, 0.625, 0.375, 0.125)


def _adjoint_1d(g: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., 4n, ...] -> [..., n, ...] along `dim` by the constant 8-tap table
    with the edge fix-ups, as `csrc/mask_loss.cu`'s backward applies it."""
    g = g.movedim(dim, -1)
    n = g.shape[-1] // RATIO
    pad = torch.nn.functional.pad(g, (2, 2))  # outputs -2, -1 and 4n, 4n+1 as zeros
    out = sum(wt * pad[..., a:a + 4 * n:4] for a, wt in enumerate(ADJOINT_TAPS))
    # edge fix-ups: outputs 0, 1 reach src 0 with weight 1, not 5/8, 7/8; outputs
    # 4n-2, 4n-1 reach src n-1 with weight 1, not 7/8, 5/8
    first = 0.375 * g[..., 0] + 0.125 * g[..., 1]
    last = 0.125 * g[..., 4 * n - 2] + 0.375 * g[..., 4 * n - 1]
    out = out.clone()
    out[..., 0] += first
    out[..., n - 1] += last
    return out.movedim(-1, dim)


def upsample4_adjoint(g: torch.Tensor) -> torch.Tensor:
    """The transpose of `upsample4`: [..., 4h, 4w] -> [..., h, w], columns
    then rows."""
    return _adjoint_1d(_adjoint_1d(g, -1), -2)


def elem_terms(z: torch.Tensor, t: torch.Tensor):
    """(prob, ce, p_t, alpha_t) with one shared exp for the sigmoid and the
    stable BCE, as `_elem_terms` of the TPU kernel. |z| and max(z, 0) are
    written as selects on z >= 0, so that autograd differentiates the z >= 0
    branch at z = 0 and gets the true derivatives there (sigmoid'(0) = 1/4,
    BCE'(0) = 1/2 - t) as the kernel's backward does; abs' (0) = 0 would
    give 0 and 1 - t. Bf16 logits put many z exactly on 0."""
    pos = z >= 0
    e = torch.exp(-torch.where(pos, z, -z))
    r = 1.0 / (1.0 + e)
    prob = torch.where(pos, r, e * r)
    ce = torch.where(pos, z, torch.zeros_like(z)) - z * t + torch.log1p(e)
    p_t = prob * t + (1.0 - prob) * (1.0 - t)
    alpha_t = 0.25 * t + 0.75 * (1.0 - t)
    return prob, ce, p_t, alpha_t


def _flat_index(gt_masks: torch.Tensor, tgt_idx: torch.Tensor,
                matched: Optional[torch.Tensor]) -> torch.Tensor:
    """[B*NQ] int32 row of the flattened [B*NG, gh, gw] masks each query
    reads (tgt_idx clamped to [0, NG)), or -1 where the query is unmatched."""
    b, ng = gt_masks.shape[:2]
    rows = torch.arange(b, dtype=torch.int64, device=tgt_idx.device)[:, None] * ng
    idx = rows + tgt_idx.to(torch.int64).clamp(0, ng - 1)
    if matched is not None:
        idx = torch.where(matched, idx, torch.full_like(idx, -1))
    return idx.reshape(-1).to(torch.int32)


def _check(src: torch.Tensor, gt_masks: torch.Tensor, tgt_idx: torch.Tensor,
           matched: Optional[torch.Tensor]) -> None:
    if src.dim() != 4 or gt_masks.dim() != 4:
        raise ValueError(f"mask loss takes src [B, NQ, h, w] and gt_masks [B, NG, H, W], got "
                         f"{tuple(src.shape)} and {tuple(gt_masks.shape)}")
    b, nq, h, w = src.shape
    if gt_masks.shape[0] != b:
        raise ValueError(f"batch {b} of src against {gt_masks.shape[0]} of gt_masks")
    if tuple(gt_masks.shape[2:]) != (RATIO * h, RATIO * w):
        raise ValueError(f"mask loss is compiled for the 4x upsample of every config; got "
                         f"{h}x{w} -> {tuple(gt_masks.shape[2:])}")
    if tuple(tgt_idx.shape) != (b, nq) or (matched is not None and tuple(matched.shape) != (b, nq)):
        raise ValueError(f"tgt_idx/matched must be [{b}, {nq}]")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mask loss takes f32 or bf16 logits, got {src.dtype}")
    if gt_masks.dtype != torch.uint8:
        raise TypeError(f"mask loss takes uint8 GT masks, got {gt_masks.dtype}")
    if matched is not None and matched.dtype != torch.bool:
        raise TypeError(f"matched must be bool, got {matched.dtype}")


def focal_dice_plain(src: torch.Tensor, gt_masks: torch.Tensor, tgt_idx: torch.Tensor,
                     matched: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel: gathers the matched queries and
    their GT masks, upsamples, and sums the elementwise chain; autograd
    differentiates it (through the widening of bf16 logits, whose gradient
    it rounds back to bf16). Returns (focal_sum, inter, prob_sum, tgt_sum),
    each [B, NQ] f32, zero for unmatched queries."""
    _check(src, gt_masks, tgt_idx, matched)
    b, nq, h, w = src.shape
    idx = _flat_index(gt_masks, tgt_idx, matched).to(torch.int64)
    sel = torch.nonzero(idx >= 0).reshape(-1)
    z = upsample4(src.reshape(b * nq, h, w)[sel].to(torch.float32))
    t = gt_masks.reshape(-1, RATIO * h, RATIO * w)[idx[sel]].to(torch.float32)
    prob, ce, p_t, alpha_t = elem_terms(z, t)
    sums = torch.stack([(alpha_t * ce * (1.0 - p_t) ** 2).sum(dim=(1, 2)),
                        (prob * t).sum(dim=(1, 2)), prob.sum(dim=(1, 2)), t.sum(dim=(1, 2))],
                       dim=1)  # [n_sel, 4]
    out = sums.new_zeros((b * nq, 4)).index_put((sel,), sums)
    return tuple(out[:, k].reshape(b, nq) for k in range(4))


def fused_focal_dice(src: torch.Tensor, gt_masks: torch.Tensor, tgt_idx: torch.Tensor,
                     matched: Optional[torch.Tensor] = None):
    """(focal_sum, inter, prob_sum, tgt_sum), each [B, NQ] f32 (`focal_dice_plain`)."""
    return focal_dice_plain(src, gt_masks, tgt_idx, matched)
