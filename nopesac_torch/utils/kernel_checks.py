"""The rules that hold each CUDA kernel of the port to its plain PyTorch
version on the same inputs, kept in one place: the card tests
(`tests/test_torch_gpu.py`) apply them over their cases, and `chip_smoke.py`
at the main-path shapes before it times the kernels.

Each `hold_*` calls the wrapper the model calls, the kernel's plain version
and, where the kernel promises it, the wrapper again; it raises
KernelMismatch naming what disagrees, and returns the kernel's output and
the config of its launch. They need a CUDA card (H1, the matcher's kernel,
is held by `losses/hungarian_cases.py`'s costs in the card tests)."""
from __future__ import annotations

import torch

from ..ops import bottleneck, mask_loss, select, sinkhorn

# B1: the stats' f32 sums over a view's pixels in another order; its seg,
# max and counts are bit-equal
SELECT_SUM_RTOL = 1e-5
# B2: another reduction order and expf/logf ulps, compounded over 200
# iterations, outside the -1e5 masked band
OT_KERNEL_TOL = 1e-4
# B3: f32 sums over up to 307200 pixels in another order than the plain
# version's; the gradient relative to its largest entry
MASK_SUM_RTOL = 1e-4
MASK_GRAD_TOL = 1e-4
# B4: f32 sums over Cin in another order than the plain version's matmul,
# relative to the largest output; bf16 outputs within one bf16 ulp
# (2^-7 |ref| + 1e-6)
B4_F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7


class KernelMismatch(AssertionError):
    """A kernel disagrees with its plain version, or takes another variant."""


def _need(ok, what: str) -> None:
    if not ok:
        raise KernelMismatch(what)


def _variant(name: str, cfg: dict, variant) -> None:
    _need(variant is None or cfg.get("variant") == variant,
          f"{name} took its {cfg.get('variant')} variant, not the {variant} one")


def hold_select(prob, score, valid, thr, out_h, out_w, variant=None):
    """B1: seg, max and the counts bit-equal to the plain version's, the
    sums within SELECT_SUM_RTOL, every label of a view without a valid
    query 0, two runs bit-equal."""
    got = select.fused_select_maps(prob, score, valid, thr, out_h, out_w)
    cfg = dict(select.last_config)
    again = select.fused_select_maps(prob, score, valid, thr, out_h, out_w)
    ref = select.select_maps_plain(prob.to(torch.bfloat16).float(), score, valid, thr,
                                   out_h, out_w)
    _variant("B1", cfg, variant)
    counts, sums = [0, 3, 6], [1, 2, 4, 5]
    for what, k, p in (("seg", got[0], ref[0]), ("max", got[1], ref[1]),
                       ("counts", got[2][:, counts], ref[2][:, counts])):
        _need(torch.equal(k, p), f"B1 {what}: {int((k != p).sum())} entries differ from the "
                                 f"plain version's")
    k, p = got[2][:, sums], ref[2][:, sums]
    _need(torch.allclose(k, p, rtol=SELECT_SUM_RTOL, atol=0),
          f"B1 sums: max |diff| {float((k - p).abs().max()):.3e} outside rtol {SELECT_SUM_RTOL}")
    _need(not got[0][~valid.any(dim=1)].any(), "B1: a view without a valid query has a label")
    _need(all(torch.equal(x, y) for x, y in zip(got, again)), "B1: two runs differ")
    return got, cfg


def assert_ot_close(got, ref):
    """Non-finite entries where the plain version's are, and equal; finite
    ones within OT_KERNEL_TOL outside the -1e5 masked band."""
    _need(torch.equal(torch.isnan(got), torch.isnan(ref)), "B2: NaNs other than the plain version's")
    inf = torch.isinf(ref)
    _need(torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], ref[inf]),
          "B2: infinities other than the plain version's")
    keep = torch.isfinite(ref) & (ref.abs() < 1e4)
    if keep.any():
        err = float((got - ref).abs()[keep].max())
        _need(err <= OT_KERNEL_TOL, f"B2: max |kernel - plain| {err:.3e} over {OT_KERNEL_TOL}")


def hold_sinkhorn(scores, alpha, iters, row=None, col=None, variant=None):
    """B2 from the scores to the log coupling: its config the one
    `sinkhorn_config` names, every entry finite and within `assert_ot_close`
    of the plain version's, two runs bit-equal."""
    b, m, n = scores.shape
    got = sinkhorn.log_optimal_transport_masked(scores, alpha, iters, row, col)
    cfg = dict(sinkhorn.last_config)
    again = sinkhorn.log_optimal_transport_masked(scores, alpha, iters, row, col)
    ref = sinkhorn.sinkhorn_plain(scores, alpha, iters, row, col)
    _variant("B2", cfg, variant)
    _need(cfg == sinkhorn.sinkhorn_config(m + 1, n + 1), f"B2 launched {cfg}")
    _need(got.shape == (b, m + 1, n + 1) and bool(torch.isfinite(got).all()),
          f"B2: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    assert_ot_close(got, ref)
    _need(torch.equal(got, again), "B2: two runs differ")
    return got, cfg


def mask_loss_both(src, masks, tgt, matched, weights):
    """Sums [B, NQ, 4] and d src of the kernel (through autograd) and of the
    plain version, for the loss sum(weights * sums); weights [4] or
    [B, NQ, 4]."""
    out = []
    for fn in (mask_loss.fused_focal_dice, mask_loss.focal_dice_plain):
        x = src.clone().requires_grad_(True)
        sums = torch.stack(fn(x, masks, tgt, matched), dim=-1)
        (sums * weights).sum().backward()
        out.append((sums.detach(), x.grad))
    return out


def hold_mask_loss(src, masks, tgt, matched, weights):
    """B3 forward and backward: f32 sums within MASK_SUM_RTOL of the plain
    version's, d src in src's dtype within MASK_GRAD_TOL (f32 logits) or one
    bf16 ulp (bf16 logits) of the plain version's largest entry, exact
    zeros for the unmatched queries."""
    (k_sums, k_grad), (p_sums, p_grad) = mask_loss_both(src, masks, tgt, matched, weights)
    _need(k_sums.dtype == torch.float32 and k_grad.dtype == src.dtype,
          f"B3: sums {k_sums.dtype}, d src {k_grad.dtype} for {src.dtype} logits")
    rel = float(((k_sums - p_sums).abs() / p_sums.abs().clamp_min(1e-30)).max())
    _need(torch.allclose(k_sums, p_sums, rtol=MASK_SUM_RTOL, atol=0),
          f"B3 sums: max rel err {rel:.3e} over {MASK_SUM_RTOL}")
    _need(not k_sums[~matched].any() and not k_grad[~matched].any(),
          "B3: an unmatched query has a sum or a d src")
    tol = BF16_ULP if src.dtype == torch.bfloat16 else MASK_GRAD_TOL
    scale = float(p_grad.float().abs().max())
    err = float((k_grad.float() - p_grad.float()).abs().max())
    _need(err <= tol * scale, f"B3 d src: max err {err:.3e} over {tol:g} of {scale:.3e}")
    return (k_sums, k_grad), (p_sums, p_grad)


def outside_one_ulp(got, ref):
    """Outputs of `got` outside one bf16 ulp (2^-7 |ref| + 1e-6) of `ref`,
    and the largest |diff| over that limit."""
    diff = (got.float() - ref.float()).abs()
    lim = BF16_ULP * ref.float().abs() + 1e-6
    return int((diff > lim).sum()), float((diff / lim).max())


def hold_bottleneck(x, wt, scale, shift, residual=None, relu=True, variant=None, twice=False):
    """B4: in x's dtype and the plain version's shape; f32 within
    B4_F32_TOL of the plain version's largest output, bf16 each output
    within one bf16 ulp of the plain version's; non-negative after the
    ReLU; with `twice`, two runs bit-equal."""
    got = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=residual, relu=relu)
    cfg = dict(bottleneck.last_config)
    ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=residual, relu=relu)
    _variant("B4", cfg, variant)
    _need(got.dtype == x.dtype and got.shape == ref.shape,
          f"B4: {got.dtype} {tuple(got.shape)} for {x.dtype} {tuple(ref.shape)}")
    if x.dtype == torch.bfloat16:
        over, ulps = outside_one_ulp(got, ref)
        _need(not over, f"B4 bf16: {over} outputs outside one bf16 ulp of the plain version's "
                        f"(max |diff| / limit {ulps:.3f})")
    else:
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        _need(err <= B4_F32_TOL * top, f"B4: max |diff| {err:.3e} over {B4_F32_TOL} of {top:.3e}")
    _need(not relu or bool((got >= 0).all()), "B4: a negative output after the ReLU")
    if twice:
        _need(torch.equal(got, bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=residual,
                                                         relu=relu)), "B4: two runs differ")
    return got, cfg
