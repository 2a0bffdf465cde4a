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

from nopesac_torch.core.sinkhorn import masked_ot_prologue
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


@pytest.mark.parametrize("seed,b,nq,h,w", [(0, 8, 50, 120, 160), (1, 3, 50, 120, 160),
                                           (2, 2, 12, 24, 32)])
def test_select_kernel_bit_equal_to_plain(cuda, seed, b, nq, h, w):
    prob, score, valid = _select_inputs(cuda, seed, b, nq, h, w)
    before = LAUNCHES["select_maps"]
    got = select.fused_select_maps(prob, score, valid, 0.5, 4 * h, 4 * w)
    assert LAUNCHES["select_maps"] == before + 1
    ref = select.select_maps_plain(prob.float(), score, valid, 0.5, 4 * h, 4 * w)
    assert torch.equal(got[0], ref[0]), int((got[0] != ref[0]).sum())
    assert torch.equal(got[1], ref[1]), int((got[1] != ref[1]).sum())
    assert (got[0][0] == 0).all()
    assert torch.equal(got[2][:, [0, 3, 6]], ref[2][:, [0, 3, 6]])
    torch.testing.assert_close(got[2][:, [1, 2, 4, 5]], ref[2][:, [1, 2, 4, 5]], rtol=1e-5, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_kernel_matches_plain(cuda, masked):
    gen = torch.Generator(device=cuda).manual_seed(0)
    scores = torch.randn((4, 50, 50), generator=gen, device=cuda) * 3
    row = torch.rand((4, 50), generator=gen, device=cuda) > 0.4 if masked else None
    col = torch.rand((4, 50), generator=gen, device=cuda) > 0.4 if masked else None
    before = LAUNCHES["sinkhorn"]
    got = sinkhorn.log_optimal_transport_masked(scores, torch.tensor(1.0, device=cuda), 200,
                                                row, col)
    assert LAUNCHES["sinkhorn"] == before + 1
    z, mu, nu, norm = masked_ot_prologue(scores, torch.tensor(1.0, device=cuda), row, col)
    ref = sinkhorn.sinkhorn_plain(z, mu, nu, norm, 200)
    keep = ref.abs() < 1e4  # leave out the -1e5 masked band
    assert torch.isfinite(got).all()
    assert float((got - ref).abs()[keep].max()) <= OT_KERNEL_TOL


def test_select_kernel_rejects_other_ratios(cuda):
    prob, score, valid = _select_inputs(cuda, 3, 2, 12, 24, 32)
    with pytest.raises(ValueError):
        select.fused_select_maps(prob, score, valid, 0.5, 48, 64)


def test_sinkhorn_kernel_refuses_autograd(cuda):
    scores = torch.randn((2, 8, 8), device=cuda, requires_grad=True)
    z, mu, nu, norm = masked_ot_prologue(scores, torch.tensor(1.0, device=cuda), None, None)
    with pytest.raises(RuntimeError, match="no backward"):
        sinkhorn.sinkhorn_cuda(z, mu, nu, norm, 5)
    with torch.no_grad():
        z, mu, nu, norm = masked_ot_prologue(scores, torch.tensor(1.0, device=cuda), None, None)
        assert torch.isfinite(sinkhorn.sinkhorn_cuda(z, mu, nu, norm, 5)).all()


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


@pytest.mark.parametrize("b,cin,cout,h,w,residual,relu,dtype", [
    (2, 64, 256, 15, 20, True, True, torch.float32),     # the JAX test's P = 300
    (2, 64, 256, 15, 20, True, False, torch.bfloat16),
    (2, 64, 256, 15, 20, False, True, torch.bfloat16),
    (8, 256, 64, 120, 160, False, True, torch.float32),  # res2 conv1 of the eval path
    (8, 512, 2048, 15, 20, True, True, torch.float32),   # res5 conv3
    (1, 96, 72, 7, 9, True, True, torch.float32),        # ragged Cout and P
])
def test_bottleneck_kernel_matches_plain(cuda, b, cin, cout, h, w, residual, relu, dtype):
    x, wt, scale, shift, res = _b4_inputs(cuda, 0, b, cin, cout, h, w, residual, dtype)
    before = LAUNCHES["bottleneck_tail"]
    got = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res, relu=relu)
    assert LAUNCHES["bottleneck_tail"] == before + 1
    ref = bottleneck.conv1x1_bn_act_plain(x, wt, scale, shift, residual=res, relu=relu)
    assert got.dtype == dtype and got.shape == (b, cout, h, w)
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= BF16_ULP * ref.float().abs() + 1e-6).all()), float(diff.max())
    else:
        assert float(diff.max()) <= B4_F32_TOL * float(ref.abs().max())
    if relu:
        assert bool((got >= 0).all())


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
