"""Kernel B3: fused 4x upsample + sigmoid-focal + dice sums of matched mask
logits, forward and backward.

Counterpart of the JAX package's `ops/mask_loss_pallas.py:fused_focal_dice`.
For each (batch, query) with a matched GT index it returns four [B, NQ] f32
sums over the full-resolution mask: sum alpha_t * BCE * (1 - p_t)^2,
sum sigmoid(z) * t, sum sigmoid(z) and sum t, where z is the 4x bilinear
upsample of the query's mask logits (half-pixel centres, taps clamped at the
edges) and t the matched uint8 GT mask. Unmatched queries give exact zeros.

On a CUDA tensor the sums come from `csrc/mask_loss.cu` through
`MaskLossFunction`, whose backward is the kernel's backward; on a CPU tensor
they come from `focal_dice_plain`, differentiated by autograd.

The logits may be f32 or bf16, as the TPU kernel takes either: bf16 logits
are widened to f32 for the upsample and the focal/dice chain, the sums are
f32, and d src comes back in bf16, the f32 gradient rounded once. (The
model's mask logits are f32 under every compute-dtype policy; the bf16
input belongs to the function's contract.)
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.device import LAUNCHES
from . import _build

KERNEL_FWD = "mask_loss_fwd"
KERNEL_BWD = "mask_loss_bwd"
BF16_SUFFIX = "_bf16"  # the launch count of the bf16-logit variant
RATIO = 4  # mask logits sit at 1/4 of the image in every config
MAX_WIDTH = 256  # 32 lanes x 8 columns per lane (csrc/mask_loss.cu)

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
    if w > MAX_WIDTH and src.device.type == "cuda":
        raise ValueError(f"the mask loss kernel holds up to {MAX_WIDTH} logit columns per "
                         f"warp, got w = {w}")
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


# src, masks, idx, work, and the forward's partials and out or the backward's
# grad and d src; n_pairs, h, w, bf16; stream
_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _work(n_pairs: int, dev) -> torch.Tensor:
    """Scratch of the device-side compaction: the matched pair ids, the
    unmatched ones and their two counts, filled by the kernel (no host
    sync)."""
    return torch.empty(2 * n_pairs + 2, dtype=torch.int32, device=dev)


def kernel_attributes(which: str, w: int) -> dict:
    """Registers, static and dynamic shared memory, spill bytes and resident
    blocks per SM of the forward or backward kernel at src width w."""
    return _build.attributes("mask_loss", "nopesac_mask_loss_attrs",
                             ("registers", "static_smem", "dynamic_smem", "local_bytes",
                              "blocks_per_sm"), int(which == "bwd"), w)


def mask_loss_fwd_cuda(src: torch.Tensor, gt_masks: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: src f32 or bf16 [B, NQ, h, w], gt_masks u8
    [B, NG, 4h, 4w], idx i32 [B*NQ] from `_flat_index` -> [B*NQ, 4] f32."""
    b, nq, h, w = src.shape
    dev = src.device
    src, masks, idx = src.contiguous(), gt_masks.contiguous(), idx.contiguous()
    if masks.data_ptr() % 4:
        raise ValueError("mask loss reads the GT masks as uchar4: their storage must be "
                         "4-byte aligned")
    tiles = _build.size("mask_loss", "nopesac_mask_loss_tiles", h)
    work = _work(b * nq, dev)
    partials = torch.empty((b * nq, tiles, 4), dtype=torch.float32, device=dev)
    out = torch.empty((b * nq, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.entry("mask_loss", "nopesac_mask_loss_fwd", _SIGNATURE)(
            src.data_ptr(), masks.data_ptr(), idx.data_ptr(), work.data_ptr(),
            partials.data_ptr(), out.data_ptr(), b * nq, h, w, int(src.dtype == torch.bfloat16),
            stream)
    LAUNCHES.bump(KERNEL_FWD + (BF16_SUFFIX if src.dtype == torch.bfloat16 else ""))
    return out


def mask_loss_bwd_cuda(src: torch.Tensor, gt_masks: torch.Tensor, idx: torch.Tensor,
                       grad: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: grad f32 [B*NQ, 3] (d/d focal, inter,
    prob_sum) -> d src [B, NQ, h, w] in src's dtype, zero for unmatched
    queries."""
    b, nq, h, w = src.shape
    dev = src.device
    src, masks = src.contiguous(), gt_masks.contiguous()
    grad = grad.to(torch.float32).contiguous()
    dsrc = torch.empty_like(src)  # the kernel writes the unmatched pairs' zeros
    work = _work(b * nq, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.entry("mask_loss", "nopesac_mask_loss_bwd", _SIGNATURE)(
            src.data_ptr(), masks.data_ptr(), idx.data_ptr(), work.data_ptr(), grad.data_ptr(),
            dsrc.data_ptr(), b * nq, h, w, int(src.dtype == torch.bfloat16), stream)
    LAUNCHES.bump(KERNEL_BWD + (BF16_SUFFIX if src.dtype == torch.bfloat16 else ""))
    return dsrc


class MaskLossFunction(torch.autograd.Function):
    """The kernel pair as an autograd function. The forward saves src, the
    masks and the flat index (which also says which queries are matched),
    not z; the backward recomputes z in the backward kernel."""

    @staticmethod
    def forward(ctx, src, gt_masks, idx):
        ctx.save_for_backward(src, gt_masks, idx)
        return mask_loss_fwd_cuda(src, gt_masks, idx)

    @staticmethod
    def backward(ctx, g_out):
        src, gt_masks, idx = ctx.saved_tensors
        return mask_loss_bwd_cuda(src, gt_masks, idx, g_out[:, :3]), None, None


def fused_focal_dice(src: torch.Tensor, gt_masks: torch.Tensor, tgt_idx: torch.Tensor,
                     matched: Optional[torch.Tensor] = None):
    """(focal_sum, inter, prob_sum, tgt_sum), each [B, NQ] f32.

    src [B, NQ, h, w] f32 or bf16 mask logits; gt_masks [B, NG, 4h, 4w] uint8;
    tgt_idx [B, NQ] matched GT index (clamped to [0, NG)); matched [B, NQ]
    bool or None (every query computed). Unmatched queries give zeros."""
    _check(src, gt_masks, tgt_idx, matched)
    if src.device.type == "cpu":
        return focal_dice_plain(src, gt_masks, tgt_idx, matched)
    if src.device.type != "cuda" or gt_masks.device != src.device:
        raise ValueError(f"mask loss kernel takes CUDA tensors on one device, got {src.device} "
                         f"and {gt_masks.device}")
    b, nq = src.shape[:2]
    out = MaskLossFunction.apply(src, gt_masks, _flat_index(gt_masks, tgt_idx, matched))
    return tuple(out[:, k].reshape(b, nq) for k in range(4))
