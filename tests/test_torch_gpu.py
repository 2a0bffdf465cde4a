"""On the card: each CUDA kernel against its plain PyTorch version. The eval
and train steps through the kernels are held against their CPU runs by
`chip_smoke.py`.

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package, so they run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from nopesac_torch.models.resnet import ResNet
from nopesac_torch.ops import bottleneck, mask_loss, select, sinkhorn
from nopesac_torch.utils.device import LAUNCHES

pytestmark = pytest.mark.gpu

OT_KERNEL_TOL = 1e-4  # other reduction order and expf/logf ulps, compounded over 200 iterations
# B3: f32 sums over up to 307200 pixels in another order than the plain
# version's; the gradient is compared relative to its largest entry
MASK_SUM_RTOL = 1e-4
MASK_GRAD_TOL = 1e-4
# B4: f32 sums over Cin in another order than the plain version's matmul,
# relative to the largest output; bf16 outputs within one bf16 ulp
# (2^-7 |ref| + 1e-6)
B4_F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _select_inputs(dev, seed, b, nq, h, w):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 4, (b, nq, h, w)).astype(np.float32)
    prob = torch.sigmoid(torch.from_numpy(logits)).to(dev).to(torch.bfloat16)
    score = torch.from_numpy(rng.uniform(0.5, 1.0, (b, nq)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((b, nq)) > 0.5).to(dev)
    valid[0] = False  # a view with no valid query: every label is 0
    return prob, score, valid


@pytest.mark.parametrize("seed,b,nq,h,w,variant", [
    (0, 8, 50, 120, 160, "vec"),   # the eval batch: 4 pairs, both views
    (1, 3, 50, 120, 160, "vec"),
    (2, 2, 12, 24, 32, "vec"),
    (3, 2, 12, 24, 33, "scalar"),  # a ragged tile, w % 8 != 0
    (4, 2, 12, 1, 40, "vec"),      # h = 1
    (5, 2, 12, 24, 1, "scalar"),   # w = 1
    (6, 2, 12, 2, 16, "vec"),      # h = 2
    (7, 1, 150, 8, 16, "vec"),     # 150 queries: the last block sums the stats in one part
])
def test_select_kernel_bit_equal_to_plain(cuda, seed, b, nq, h, w, variant):
    prob, score, valid = _select_inputs(cuda, seed, b, nq, h, w)
    before = LAUNCHES["select_maps"]
    got = select.fused_select_maps(prob, score, valid, 0.5, 4 * h, 4 * w)
    assert LAUNCHES["select_maps"] == before + 1
    assert select.last_config["variant"] == variant
    ref = select.select_maps_plain(prob.float(), score, valid, 0.5, 4 * h, 4 * w)
    assert torch.equal(got[0], ref[0]), int((got[0] != ref[0]).sum())
    assert torch.equal(got[1], ref[1]), int((got[1] != ref[1]).sum())
    assert (got[0][0] == 0).all()
    assert torch.equal(got[2][:, [0, 3, 6]], ref[2][:, [0, 3, 6]])
    torch.testing.assert_close(got[2][:, [1, 2, 4, 5]], ref[2][:, [1, 2, 4, 5]], rtol=1e-5, atol=0)
    again = select.fused_select_maps(prob, score, valid, 0.5, 4 * h, 4 * w)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def test_select_kernel_is_one_device_kernel(cuda):
    prob, score, valid = _select_inputs(cuda, 0, 8, 50, 120, 160)
    from chip_smoke import device_events
    events = device_events(torch, lambda: select.select_maps_cuda(prob, score, valid, 0.5,
                                                                  480, 640))
    assert events["per_call"] == 1, events


def _ot_inputs(dev, seed, b, m, n, masked):
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.normal(0, 3, (b, m, n)).astype(np.float32)).to(dev)
    if not masked:
        return scores, None, None
    row = torch.from_numpy(rng.random((b, m)) > 0.4).to(dev)
    col = torch.from_numpy(rng.random((b, n)) > 0.4).to(dev)
    return scores, row, col


def _assert_ot_close(got, ref):
    """Non-finite entries where the plain version's are, and equal; finite
    ones within OT_KERNEL_TOL outside the -1e5 masked band."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], ref[inf])
    keep = torch.isfinite(ref) & (ref.abs() < 1e4)
    if keep.any():
        assert float((got - ref).abs()[keep].max()) <= OT_KERNEL_TOL


@pytest.mark.parametrize("b,m,n,masked,iters,variant", [
    (1, 1, 1, False, 200, "register"),
    (4, 50, 50, False, 200, "register"),
    (4, 50, 50, True, 200, "register"),  # the eval batch's shape
    (3, 63, 20, True, 200, "register"),  # 64 rows: the most values per lane
    (2, 100, 37, True, 200, "general"),
    (1, 200, 100, True, 20, "general"),  # z over 48 KB of shared memory
    (4, 50, 50, True, 0, "register"),
    (4, 50, 50, True, 1, "register"),
])
def test_sinkhorn_kernel_matches_plain(cuda, b, m, n, masked, iters, variant):
    scores, row, col = _ot_inputs(cuda, 0, b, m, n, masked)
    alpha = torch.tensor(1.0, device=cuda)
    before = LAUNCHES["sinkhorn"]
    got = sinkhorn.sinkhorn_cuda(scores, alpha, iters, row, col)
    assert LAUNCHES["sinkhorn"] == before + 1
    assert sinkhorn.last_config["variant"] == variant
    assert sinkhorn.last_config == sinkhorn.sinkhorn_config(m + 1, n + 1)
    ref = sinkhorn.sinkhorn_plain(scores, alpha, iters, row, col)
    assert got.shape == (b, m + 1, n + 1)
    _assert_ot_close(got, ref)
    assert torch.isfinite(got).all()
    assert torch.equal(got, sinkhorn.sinkhorn_cuda(scores, alpha, iters, row, col))


@pytest.mark.parametrize("m,n", [(50, 50), (100, 37)])
def test_sinkhorn_kernel_without_valid_rows_or_columns(cuda, m, n):
    """Batch element 1 has no valid row, 2 no valid column, 3 neither: the
    kernel's infinities and NaNs sit where the plain version's do."""
    scores, row, col = _ot_inputs(cuda, 1, 4, m, n, True)
    row[1], col[2], row[3], col[3] = False, False, False, False
    alpha = torch.tensor(0.7, device=cuda)
    got = sinkhorn.log_optimal_transport_masked(scores, alpha, 200, row, col)
    ref = sinkhorn.sinkhorn_plain(scores, alpha, 200, row, col)
    assert not torch.isfinite(ref[1:]).all()
    _assert_ot_close(got, ref)


def test_sinkhorn_kernel_is_one_device_kernel(cuda):
    scores, row, col = _ot_inputs(cuda, 2, 4, 50, 50, True)
    alpha = torch.tensor(1.0, device=cuda)
    from chip_smoke import device_events
    events = device_events(
        torch, lambda: sinkhorn.log_optimal_transport_masked(scores, alpha, 200, row, col))
    assert events["per_call"] == 1, events


def test_select_kernel_rejects_other_ratios(cuda):
    prob, score, valid = _select_inputs(cuda, 3, 2, 12, 24, 32)
    with pytest.raises(ValueError):
        select.fused_select_maps(prob, score, valid, 0.5, 48, 64)


def test_sinkhorn_kernel_refuses_autograd(cuda):
    scores = torch.randn((2, 8, 8), device=cuda, requires_grad=True)
    alpha = torch.tensor(1.0, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        sinkhorn.sinkhorn_cuda(scores, alpha, 5)
    with torch.no_grad():
        assert torch.isfinite(sinkhorn.sinkhorn_cuda(scores, alpha, 5)).all()


def mask_loss_inputs(dev, seed, b, nq, h, w, n_matched, grid=(3, 4)):
    """Seeded logits with coarse structure, disjoint GT masks (a grid of
    planes per view, ids shuffled), a random matching of n_matched queries
    per view."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(0, 4, (b, nq, h // 4 + 1, w // 4 + 1)).astype(np.float32)
    src = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3)[:, :, :h, :w]
    src = src + rng.normal(0, 1, (b, nq, h, w)).astype(np.float32)
    gh, gw = 4 * h, 4 * w
    n_planes = grid[0] * grid[1]
    masks = np.zeros((b, nq, gh, gw), np.uint8)
    for i in range(b):
        ids = rng.permutation(n_planes)
        for cell in range(n_planes):
            r, c = divmod(cell, grid[1])
            masks[i, ids[cell], r * gh // grid[0]:(r + 1) * gh // grid[0],
                  c * gw // grid[1]:(c + 1) * gw // grid[1]] = 1
    tgt = np.zeros((b, nq), np.int64)
    matched = np.zeros((b, nq), bool)
    for i in range(b):
        q = rng.permutation(nq)[:n_matched]
        tgt[i, q] = rng.permutation(n_planes)[:n_matched]
        matched[i, q] = True
    return (torch.from_numpy(src).to(dev), torch.from_numpy(masks).to(dev),
            torch.from_numpy(tgt).to(dev), torch.from_numpy(matched).to(dev))


def _mask_loss_both(src, masks, tgt, matched, weights):
    """Sums and d src of the kernel (through autograd) and of the plain
    version, for the loss sum(w0 * focal + w1 * inter + w2 * psum + w3 * tsum)."""
    out = []
    for fn in (mask_loss.fused_focal_dice, mask_loss.focal_dice_plain):
        s = src.clone().requires_grad_(True)
        sums = fn(s, masks, tgt, matched)
        loss = sum((wk * v).sum() for wk, v in zip(weights, sums))
        loss.backward()
        out.append(([v.detach() for v in sums], s.grad))
    return out


@pytest.mark.parametrize("b,nq,h,w,n_matched", [(2, 50, 24, 32, 6), (32, 50, 120, 160, 12),
                                                (4, 50, 24, 32, 1), (3, 50, 24, 32, 0)])
def test_mask_loss_kernel_matches_plain(cuda, b, nq, h, w, n_matched):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 0, b, nq, h, w, n_matched)
    before = (LAUNCHES["mask_loss_fwd"], LAUNCHES["mask_loss_bwd"])
    (k_sums, k_grad), (p_sums, p_grad) = _mask_loss_both(src, masks, tgt, matched,
                                                         (0.7, -0.3, 0.11, 0.5))
    torch.cuda.synchronize()
    assert (LAUNCHES["mask_loss_fwd"], LAUNCHES["mask_loss_bwd"]) == (before[0] + 1, before[1] + 1)
    for k, p in zip(k_sums, p_sums):
        torch.testing.assert_close(k, p, rtol=MASK_SUM_RTOL, atol=0)
        assert (k[~matched] == 0).all()
    assert (k_grad[~matched] == 0).all()
    scale = float(p_grad.abs().max())
    if n_matched == 0:
        assert scale == 0 and float(k_grad.abs().max()) == 0
    else:
        assert float((k_grad - p_grad).abs().max()) <= MASK_GRAD_TOL * scale


@pytest.mark.parametrize("b,nq,h,w,n_matched", [(2, 50, 24, 32, 6), (32, 50, 120, 160, 12),
                                                (3, 50, 24, 32, 0)])
def test_mask_loss_kernel_bf16_logits_match_plain(cuda, b, nq, h, w, n_matched):
    """bf16 logits (chip_smoke.py phase 8's bounds): f32 sums within rtol
    1e-4, a bf16 d src within one bf16 ulp of the plain version's, exact
    zeros for the unmatched queries."""
    src, masks, tgt, matched = mask_loss_inputs(cuda, 1, b, nq, h, w, n_matched)
    src = src.to(torch.bfloat16)
    names = ("mask_loss_fwd", "mask_loss_bwd", "mask_loss_fwd_bf16", "mask_loss_bwd_bf16")
    before = [LAUNCHES[n] for n in names]
    (k_sums, k_grad), (p_sums, p_grad) = _mask_loss_both(src, masks, tgt, matched,
                                                         (0.7, -0.3, 0.11, 0.5))
    torch.cuda.synchronize()
    # counted as the bf16-logit variant, not as the f32 one
    assert [LAUNCHES[n] - c for n, c in zip(names, before)] == [0, 0, 1, 1]
    assert k_grad.dtype == torch.bfloat16 and all(k.dtype == torch.float32 for k in k_sums)
    for k, p in zip(k_sums, p_sums):
        torch.testing.assert_close(k, p, rtol=MASK_SUM_RTOL, atol=0)
        assert (k[~matched] == 0).all()
    assert (k_grad[~matched] == 0).all()
    scale = float(p_grad.float().abs().max())
    assert float((k_grad.float() - p_grad.float()).abs().max()) <= BF16_ULP * scale


@pytest.mark.parametrize("b,nq,h,w,pairs", [
    (2, 50, 24, 32, (0, 99)),           # only the first and the last pair matched
    (3, 12, 30, 44, (0, 35)),           # h, w not multiples of the row tiles or of 32
    (2, 12, 30, 44, tuple(range(24))),  # every pair matched
])
def test_mask_loss_kernel_matched_pairs_at_the_ends(cuda, b, nq, h, w, pairs):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 5, b, nq, h, w, 12)
    matched = torch.zeros_like(matched)
    matched.view(-1)[list(pairs)] = True
    (k_sums, k_grad), (p_sums, p_grad) = _mask_loss_both(src, masks, tgt, matched,
                                                         (0.7, -0.3, 0.11, 0.5))
    torch.cuda.synchronize()
    for k, p in zip(k_sums, p_sums):
        torch.testing.assert_close(k, p, rtol=MASK_SUM_RTOL, atol=0)
        assert (k[~matched] == 0).all()
    assert (k_grad[~matched] == 0).all()
    assert float((k_grad - p_grad).abs().max()) <= MASK_GRAD_TOL * float(p_grad.abs().max())


def test_mask_loss_kernel_is_deterministic(cuda):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 1, 32, 50, 120, 160, 12)
    runs = [_mask_loss_both(src, masks, tgt, matched, (1.0, 1.0, 1.0, 0.0))[0] for _ in range(2)]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][1], runs[1][1])


def test_mask_loss_kernel_without_matched_computes_every_query(cuda):
    src, masks, tgt, _ = mask_loss_inputs(cuda, 2, 2, 12, 24, 32, 12)
    got = mask_loss.fused_focal_dice(src, masks, tgt)
    ref = mask_loss.focal_dice_plain(src, masks, tgt)
    for k, p in zip(got, ref):
        torch.testing.assert_close(k, p, rtol=MASK_SUM_RTOL, atol=0)
    assert (got[2] > 0).all()


def test_mask_loss_kernel_rejects_other_ratios(cuda):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 3, 1, 12, 24, 32, 2)
    with pytest.raises(ValueError, match="4x"):
        mask_loss.fused_focal_dice(src[..., :16], masks, tgt, matched)


def _b4_inputs(dev, seed, b, cin, cout, h, w, residual, dtype):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(np.abs(rng.normal(0, 1, (b, cin, h, w)))).to(dtype)  # post-ReLU activations
    wt = t(rng.normal(0, (2.0 / cin) ** 0.5, (cout, cin, 1, 1)))
    scale, shift = t(rng.uniform(0.5, 1.5, cout)), t(rng.normal(0, 0.1, cout))
    res = t(rng.normal(0, 1, (b, cout, h, w))).to(dtype) if residual else None
    return x, wt, scale, shift, res


# the eight shapes of the fused-tail eval batch: 8 images of 480x640, per
# stage conv1 Cout -> Cout/4 with ReLU and conv3 Cout/4 -> Cout with the residual
EVAL_SHAPES = [(8, cin, cout, h, w, residual)
               for h, w, width, mid in ((120, 160, 256, 64), (60, 80, 512, 128),
                                        (30, 40, 1024, 256), (15, 20, 2048, 512))
               for cin, cout, residual in ((width, mid, False), (mid, width, True))]


@pytest.mark.parametrize("b,cin,cout,h,w,residual,relu,dtype,variant", [
    (2, 64, 256, 15, 20, True, True, torch.float32, "vec"),       # the JAX test's P = 300
    (2, 64, 256, 15, 20, True, False, torch.bfloat16, "scalar"),  # bf16: P = 300, 300 % 8 != 0
    (2, 64, 256, 15, 20, False, True, torch.bfloat16, "scalar"),
    (8, 256, 64, 120, 160, False, True, torch.float32, "vec"),    # res2 conv1 of the eval path
    (8, 512, 2048, 15, 20, True, True, torch.float32, "vec"),     # res5 conv3
    (1, 96, 72, 7, 9, True, True, torch.float32, "scalar"),       # ragged Cout, P = 63
    (2, 96, 72, 7, 9, False, False, torch.float32, "scalar"),     # a tile across two images
])
def test_bottleneck_kernel_matches_plain(cuda, b, cin, cout, h, w, residual, relu, dtype,
                                         variant):
    x, wt, scale, shift, res = _b4_inputs(cuda, 0, b, cin, cout, h, w, residual, dtype)
    before = LAUNCHES["bottleneck_tail"]
    got = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res, relu=relu)
    assert LAUNCHES["bottleneck_tail"] == before + 1
    assert bottleneck.last_config["variant"] == variant
    ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res, relu=relu)
    assert got.dtype == dtype and got.shape == (b, cout, h, w)
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= BF16_ULP * ref.float().abs() + 1e-6).all()), float(diff.max())
    else:
        assert float(diff.max()) <= B4_F32_TOL * float(ref.abs().max())
    if relu:
        assert bool((got >= 0).all())


@pytest.mark.parametrize("b,cin,cout,h,w,residual", EVAL_SHAPES)
def test_bottleneck_kernel_at_the_eval_shapes(cuda, b, cin, cout, h, w, residual):
    x, wt, scale, shift, res = _b4_inputs(cuda, 1, b, cin, cout, h, w, residual, torch.float32)
    got = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res)
    cfg = dict(bottleneck.last_config)
    assert cfg == bottleneck.b4_config(b, cin, cout, h * w) and cfg["variant"] == "vec"
    ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res)
    assert float((got - ref).abs().max()) <= B4_F32_TOL * float(ref.abs().max())
    if cfg["split"] > 1:  # the cluster reduction runs in a fixed order
        again = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res)
        assert torch.equal(got, again)


@pytest.mark.parametrize("b,cin,cout,h,w,residual", EVAL_SHAPES)
def test_bottleneck_kernel_bf16_at_the_eval_shapes(cuda, b, cin, cout, h, w, residual):
    """bf16 at the eight eval shapes (chip_smoke.py phase 11's bound): within
    one bf16 ulp of the plain version."""
    x, wt, scale, shift, res = _b4_inputs(cuda, 2, b, cin, cout, h, w, residual, torch.bfloat16)
    got = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res)
    ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= BF16_ULP * ref.float().abs() + 1e-6).all()), float(diff.max())


def test_bottleneck_kernel_refuses_autograd(cuda):
    x, wt, scale, shift, _ = _b4_inputs(cuda, 1, 1, 64, 64, 4, 4, False, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        bottleneck.conv1x1_bn_act_cuda(x, wt.requires_grad_(True), scale, shift)
    with torch.no_grad():
        assert torch.isfinite(bottleneck.conv1x1_bn_act_cuda(x, wt, scale, shift)).all()


def test_fused_backbone_matches_unfused_on_card(cuda):
    gen = torch.Generator().manual_seed(0)
    fused, plain = ResNet(fuse_tail=True).eval(), ResNet().eval()
    with torch.no_grad():
        for name, buf in fused.state_dict().items():
            if buf.dim() == 4:  # conv weights: He init
                buf.copy_(torch.randn(buf.shape, generator=gen) * (2.0 / buf[0].numel()) ** 0.5)
            elif name.endswith(("weight", "running_var")):  # FrozenBN statistics and affine
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
            else:
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
    plain.load_state_dict(fused.state_dict())
    fused, plain = fused.to(cuda), plain.to(cuda)
    x = torch.randn((2, 3, 64, 96), generator=gen).to(cuda)
    before = LAUNCHES["bottleneck_tail"]
    with torch.inference_mode():
        got, ref = fused(x), plain(x)
    assert LAUNCHES["bottleneck_tail"] == before + 24  # two per identity block
    for name, r in ref.items():
        assert float((got[name] - r).abs().max()) <= 1e-4 * float(r.abs().max()), name
