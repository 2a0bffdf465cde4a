"""The yardstick's peaks and the least time each kernel's operation needs
(the arithmetic of `chip_smoke.py`, copied): max(bytes / HBM bandwidth,
operations / peak rate), each input byte read once and each output byte
written once, counted from the operation's own shapes and inputs, whatever
implements it."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp8": 1979e12}
# B3 operations per full-resolution pixel of a matched query (chip_smoke.py:
# the 2x2 stencil, the shared-exp focal/dice terms and the sums; backward
# the same, dz from the three incoming gradients and the adjoint stencil)
MASK_FWD_OPS = 39
MASK_BWD_OPS = 55


def bound_s(n_bytes: float, n_ops: float, rate: float = PEAK_FLOP_PER_S["f32"]) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / rate)


def select_bound_s(b: int, nq: int, h: int, w: int, out_h: int, out_w: int,
                   prob_bytes: int) -> float:
    """B1 (`fused_select_maps`): probabilities [B, NQ, h, w], score and valid
    [B, NQ] in; seg and max [B, out_h, out_w], stats [B, 7, NQ] out; per
    output pixel and query a row 2-tap (3), the score product (1) and 3/4 of
    a column 2-tap (2.25)."""
    n_bytes = (b * nq * h * w * prob_bytes + b * nq * (4 + 1)
               + 2 * b * out_h * out_w * 4 + b * 7 * nq * 4)
    return bound_s(n_bytes, b * nq * out_h * out_w * 6.25)


def sinkhorn_bound_s(b: int, m: int, n: int, iters: int) -> float:
    """B2 (`log_optimal_transport_masked`): scores [B, M, N], masks, alpha in;
    [B, M+1, N+1] out; per entry and half-iteration an add, max, sub, exp and
    sum."""
    r, c = m + 1, n + 1
    n_bytes = 4 * b * m * n + b * (m + n) + 4 + 4 * b * r * c
    return bound_s(n_bytes, b * iters * 2 * r * c * 5)


def mask_loss_bound_s(b: int, nq: int, h: int, w: int, n_matched: int,
                      logit_bytes: int) -> float:
    """B3 (`fused_focal_dice`), forward and backward: the matched queries'
    logits [h, w] and their uint8 GT masks [4h, 4w] read, the [B, NQ] index;
    forward the four sums out, backward the three incoming gradients in and
    d src [B, NQ, h, w] out."""
    n_px = 16 * h * w
    read = n_matched * (h * w * logit_bytes + n_px) + b * nq * 4
    fwd = bound_s(read + b * nq * 4 * 4, n_matched * n_px * MASK_FWD_OPS)
    bwd = bound_s(read + b * nq * 3 * 4 + b * nq * h * w * logit_bytes,
                  n_matched * n_px * MASK_BWD_OPS)
    return fwd + bwd
