"""On the card: each CUDA kernel against its plain PyTorch version over its
cases, by the rules of `nopesac_torch/utils/kernel_checks.py` (which
`chip_smoke.py` applies at the main-path shapes before it times the
kernels), and the eval step's CUDA graphs against its eager run. The eval
and train steps through the kernels are held against the plain reference
by the benchmark's cells (`cardbench/`).

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package, so they run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.engine import test as entry
from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
from nopesac_torch.engine.test import _fetch, _numpy
from nopesac_torch.evaluation.evaluator import MP3DEvaluator
from nopesac_torch.losses.hungarian import hungarian, hungarian_plain
from nopesac_torch.losses.hungarian_cases import FAMILIES, SHAPES, cost_family
from nopesac_torch.models import matching_head, nopesac
from nopesac_torch.models.resnet import ResNet
from nopesac_torch.ops import bottleneck, mask_loss, select, sinkhorn
from nopesac_torch.ops.hungarian import hungarian_cuda
from nopesac_torch.utils import graphs, trace
from nopesac_torch.utils.device import LAUNCHES
from nopesac_torch.utils.kernel_checks import (MASK_SUM_RTOL, assert_ot_close, hold_bottleneck,
                                               hold_mask_loss, hold_select, hold_sinkhorn,
                                               mask_loss_both, outside_one_ulp)

pytestmark = pytest.mark.gpu


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
    got, _ = hold_select(prob, score, valid, 0.5, 4 * h, 4 * w, variant)
    assert LAUNCHES["select_maps"] == before + 2  # the kernel and its second run
    assert (got[0][0] == 0).all()


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
    hold_sinkhorn(scores, alpha, iters, row, col, variant)
    assert LAUNCHES["sinkhorn"] == before + 2  # the kernel and its second run


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
    assert_ot_close(got, ref)


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


def _weights(dev):
    """The loss w0 * focal + w1 * inter + w2 * psum + w3 * tsum."""
    return torch.tensor((0.7, -0.3, 0.11, 0.5), device=dev)


@pytest.mark.parametrize("b,nq,h,w,n_matched", [(2, 50, 24, 32, 6), (32, 50, 120, 160, 12),
                                                (4, 50, 24, 32, 1), (3, 50, 24, 32, 0),
                                                (32, 50, 120, 160, 0)])
def test_mask_loss_kernel_matches_plain(cuda, b, nq, h, w, n_matched):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 0, b, nq, h, w, n_matched)
    before = (LAUNCHES["mask_loss_fwd"], LAUNCHES["mask_loss_bwd"])
    (_, k_grad), (_, p_grad) = hold_mask_loss(src, masks, tgt, matched, _weights(cuda))
    torch.cuda.synchronize()
    assert (LAUNCHES["mask_loss_fwd"], LAUNCHES["mask_loss_bwd"]) == (before[0] + 1, before[1] + 1)
    if n_matched == 0:
        assert float(p_grad.abs().max()) == 0 and float(k_grad.abs().max()) == 0


@pytest.mark.parametrize("b,nq,h,w,n_matched", [(2, 50, 24, 32, 6), (32, 50, 120, 160, 12),
                                                (3, 50, 24, 32, 0)])
def test_mask_loss_kernel_bf16_logits_match_plain(cuda, b, nq, h, w, n_matched):
    """bf16 logits: f32 sums within rtol 1e-4, a bf16 d src within one bf16
    ulp of the plain version's, exact zeros for the unmatched queries."""
    src, masks, tgt, matched = mask_loss_inputs(cuda, 1, b, nq, h, w, n_matched)
    src = src.to(torch.bfloat16)
    names = ("mask_loss_fwd", "mask_loss_bwd", "mask_loss_fwd_bf16", "mask_loss_bwd_bf16")
    before = [LAUNCHES[n] for n in names]
    (k_sums, k_grad), _ = hold_mask_loss(src, masks, tgt, matched, _weights(cuda))
    torch.cuda.synchronize()
    # counted as the bf16-logit variant, not as the f32 one
    assert [LAUNCHES[n] - c for n, c in zip(names, before)] == [0, 0, 1, 1]
    assert k_grad.dtype == torch.bfloat16 and k_sums.dtype == torch.float32


@pytest.mark.parametrize("b,nq,h,w,pairs", [
    (2, 50, 24, 32, (0, 99)),           # only the first and the last pair matched
    (3, 12, 30, 44, (0, 35)),           # h, w not multiples of the row tiles or of 32
    (2, 12, 30, 44, tuple(range(24))),  # every pair matched
])
def test_mask_loss_kernel_matched_pairs_at_the_ends(cuda, b, nq, h, w, pairs):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 5, b, nq, h, w, 12)
    matched = torch.zeros_like(matched)
    matched.view(-1)[list(pairs)] = True
    hold_mask_loss(src, masks, tgt, matched, _weights(cuda))


def test_mask_loss_kernel_is_deterministic(cuda):
    src, masks, tgt, matched = mask_loss_inputs(cuda, 1, 32, 50, 120, 160, 12)
    weights = torch.tensor((1.0, 1.0, 1.0, 0.0), device=cuda)
    runs = [mask_loss_both(src, masks, tgt, matched, weights)[0] for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
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
    (2, 64, 256, 15, 20, True, False, torch.bfloat16, "wgmma"),   # bf16: P = 300, X by cp.async
    (2, 64, 256, 15, 20, False, True, torch.bfloat16, "wgmma"),
    (8, 256, 64, 120, 160, False, True, torch.float32, "vec"),    # res2 conv1 of the eval path
    (8, 512, 2048, 15, 20, True, True, torch.float32, "vec"),     # res5 conv3
    (1, 96, 72, 7, 9, True, True, torch.float32, "scalar"),       # ragged Cout, P = 63
    (2, 96, 72, 7, 9, False, False, torch.float32, "scalar"),     # a tile across two images
    (1, 64, 72, 7, 9, True, True, torch.bfloat16, "scalar"),      # bf16 with P = 63: not wgmma
    (2, 64, 256, 15, 20, True, True, torch.bfloat16, "wgmma"),    # the JAX test's, in bf16
    (2, 64, 256, 15, 20, False, False, torch.bfloat16, "wgmma"),
])
def test_bottleneck_kernel_matches_plain(cuda, b, cin, cout, h, w, residual, relu, dtype,
                                         variant):
    x, wt, scale, shift, res = _b4_inputs(cuda, 0, b, cin, cout, h, w, residual, dtype)
    before = LAUNCHES["bottleneck_tail"]
    got, _ = hold_bottleneck(x, wt, scale, shift, res, relu, variant)
    assert LAUNCHES["bottleneck_tail"] == before + 1
    assert got.dtype == dtype and got.shape == (b, cout, h, w)


@pytest.mark.parametrize("b,cin,cout,h,w,residual", EVAL_SHAPES)
def test_bottleneck_kernel_at_the_eval_shapes(cuda, b, cin, cout, h, w, residual):
    x, wt, scale, shift, res = _b4_inputs(cuda, 1, b, cin, cout, h, w, residual, torch.float32)
    # a split's cluster reduction runs in a fixed order: two runs bit-equal
    _, cfg = hold_bottleneck(x, wt, scale, shift, res, variant="vec",
                             twice=bottleneck.b4_config(b, cin, cout, h * w)["split"] > 1)
    assert cfg == bottleneck.b4_config(b, cin, cout, h * w)


def _b4_exact(x, wt, scale, shift, res):
    """B4's function (with ReLU) in f64 on the card, rounded once to bf16:
    the exact product of the bf16 inputs."""
    b, cin = x.shape[:2]
    acc = torch.matmul(wt.reshape(wt.shape[0], -1).to(torch.bfloat16).double(),
                       x.reshape(b, cin, -1).double())
    acc = acc * scale.double()[:, None] + shift.double()[:, None]
    if res is not None:
        acc = acc + res.reshape(acc.shape).double()
    return torch.relu(acc).to(torch.bfloat16).reshape(b, wt.shape[0], *x.shape[2:])


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("b,cin,cout,h,w,residual", EVAL_SHAPES)
def test_bottleneck_kernel_bf16_within_one_ulp_of_the_exact_product(cuda, seed, b, cin, cout,
                                                                     h, w, residual):
    """bf16 at the eight eval shapes held to the exact product, the bound
    that does not depend on a summation order. Against the plain version
    (cuBLAS's f32 sums in another order) one ulp can be exceeded: at seed 3,
    res4 conv1 (8, 1024 -> 256, P 1200), the two round one output to
    opposite sides of a bf16 boundary, 1.30 limits apart, while each lies
    within one ulp of the exact product."""
    x, wt, scale, shift, res = _b4_inputs(cuda, seed, b, cin, cout, h, w, residual,
                                          torch.bfloat16)
    got = bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res)
    assert bottleneck.last_config["variant"] == "wgmma"
    over, worst = outside_one_ulp(got, _b4_exact(x, wt, scale, shift, res))
    assert not over, worst


@pytest.mark.parametrize("b,cin,cout,h,w,residual", EVAL_SHAPES)
def test_bottleneck_kernel_bf16_at_the_eval_shapes(cuda, b, cin, cout, h, w, residual):
    """bf16 at the eight eval shapes: the wgmma variant, within one bf16 ulp
    of the plain version, bit-equal on a second run."""
    x, wt, scale, shift, res = _b4_inputs(cuda, 2, b, cin, cout, h, w, residual, torch.bfloat16)
    got, cfg = hold_bottleneck(x, wt, scale, shift, res, variant="wgmma", twice=True)
    assert cfg == bottleneck.b4_config(b, cin, cout, h * w, torch.bfloat16)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("b,cin,cout,h,w,residual,x_load,split", [
    (2, 128, 192, 30, 40, True, "tma", 1),       # ragged last tiles: P = 1200, Cout = 192
    (3, 64, 256, 15, 20, True, "cp.async", 1),   # P = 300: tiles across two images
    (8, 2048, 512, 15, 20, False, "cp.async", 2),  # res5 conv1: Cin split over a cluster
    (2, 1024, 256, 30, 40, True, "tma", 4),      # a split on the TMA path, the residual per rank
])
def test_bottleneck_kernel_bf16_trouble_spots(cuda, b, cin, cout, h, w, residual, x_load, split):
    """The wgmma variant where its tiles meet the edges of the maps, and
    where it splits Cin: within one bf16 ulp, and two runs bit-equal (the
    cluster reduction sums in rank order, without atomics)."""
    x, wt, scale, shift, res = _b4_inputs(cuda, 3, b, cin, cout, h, w, residual, torch.bfloat16)
    got, cfg = hold_bottleneck(x, wt, scale, shift, res, variant="wgmma", twice=True)
    assert (cfg["x_load"], cfg["split"]) == (x_load, split)
    assert torch.equal(got, bottleneck.conv1x1_bn_act(x, wt, scale, shift, residual=res))


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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p,n", SHAPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_hungarian_kernel_equals_plain(cuda, family, p, n, seed):
    """H1 bit-equal to its plain version (run on the CPU) on every cost
    family, ties and non-finite costs included: one launch per call, two
    runs bit-equal."""
    cost, num_gt, _ = cost_family(family, p, n, seed)
    c, k = torch.from_numpy(cost).to(cuda), torch.from_numpy(num_gt).to(cuda)
    before = LAUNCHES["hungarian"]
    got = hungarian_cuda(c, k)
    assert LAUNCHES["hungarian"] == before + 1
    again = hungarian_cuda(c, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and tuple(got.shape) == (p, n)
    assert torch.equal(got.cpu(), hungarian_plain(torch.from_numpy(cost),
                                                  torch.from_numpy(num_gt)))
    assert torch.equal(got, again)


def test_hungarian_on_card_takes_the_kernel_and_clamps_num_gt(cuda):
    cost, num_gt, _ = cost_family("layout", 8, 50, seed=5)
    ng = cost.shape[2]
    num_gt[1], num_gt[2] = ng + 9, -4
    before = LAUNCHES["hungarian"]
    got = hungarian(torch.from_numpy(cost).to(cuda), torch.from_numpy(num_gt).to(cuda))
    assert LAUNCHES["hungarian"] == before + 1
    ref = hungarian_plain(torch.from_numpy(cost), torch.from_numpy(np.clip(num_gt, 0, ng)))
    assert torch.equal(got.cpu(), ref)
    empty = hungarian_cuda(torch.zeros((0, 50, 50), device=cuda),
                           torch.zeros(0, dtype=torch.int64, device=cuda))
    assert tuple(empty.shape) == (0, 50) and LAUNCHES["hungarian"] == before + 1


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("ablations", [False, True])
def test_eval_step_makes_the_host_wait_nowhere(cuda, ablations):
    """One warm eval step of the shipped config (480x640, batch 4, seeded
    weights) from the uint8 images on the host through the enqueue of the
    fetch runs under `set_sync_debug_mode("error")`: no blocking copy, no
    synchronisation. The fetch lands in pinned memory, so it does not wait
    either, and the outputs are bit-equal to a step run with the mode off.
    With `ablations`, the GT-matcher and SparsePlanes-camera inputs go up
    from host arrays too."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "inference_mp3d.yaml"))
    h, w = cfg.INPUT.IMAGE_SIZE
    bs, nq = cfg.TEST.IMS_PER_BATCH, cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    step = make_eval_step(build_model_from_cfg(cfg, device=cuda, seed=0), h, w,
                          cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    rng = np.random.default_rng(5)
    images = [torch.from_numpy(rng.integers(0, 256, (bs, h, w, 3), dtype=np.uint8))
              for _ in range(2)]
    extra = {}
    if ablations:
        extra = {"gt_geo": {"params0": rng.normal(size=(bs, nq, 3)).astype(np.float32),
                            "params1": rng.normal(size=(bs, nq, 3)).astype(np.float32),
                            "corr_idx1": rng.integers(0, nq, size=(bs, nq)),
                            "corr_idx2": rng.integers(0, nq, size=(bs, nq)),
                            "corr_valid": rng.random((bs, nq)) < 0.3},
                 "init_cam": {"tran": rng.normal(size=(bs, 3)).astype(np.float32),
                              "rot": rng.normal(size=(bs, 4)).astype(np.float32)}}
    warm = _fetch(step(*images, **extra))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _fetch(step(*images, **extra))
        done = torch.cuda.Event()
        done.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    done.synchronize()
    assert all(t.is_pinned() for t in _leaves(out))
    got, want = _numpy(out), _numpy(warm)
    assert list(_leaves(got)) and "camera_onePP" in got
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


# ------------------------------------------- the eval step's CUDA graphs
def _eval_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "inference_mp3d.yaml"))
    cfg.merge_from_list(list(opts))
    return cfg


def _host_batches(cfg, n, seed=11):
    h, w = cfg.INPUT.IMAGE_SIZE
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.integers(0, 256, (cfg.TEST.IMS_PER_BATCH, h, w, 3),
                                           dtype=np.uint8)) for _ in range(2)]
            for _ in range(n)]


def _host(out):
    """The step's outputs on the host, waited for."""
    out = _fetch(out)
    torch.cuda.synchronize()
    return _numpy(out)


def _assert_same(got, want):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def _deep_equal(a, b) -> bool:
    """Equal values, containers alike, NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_deep_equal, a, b))
    if isinstance(a, torch.Tensor):
        a, b = a.numpy(), b.numpy()
    if isinstance(a, (np.ndarray, np.generic, float)):
        return np.shape(a) == np.shape(b) and np.array_equal(a, b, equal_nan=True)
    return a == b


def _eager(step, model, batch):
    """The step on a batch as its signature's first call: eager."""
    graphs.drop(model)
    return _host(step(*batch))


def _graph_counts():
    return {k: v for k, v in trace.snapshot()["counts"].items() if k.startswith("eval.graph_")}


@pytest.mark.parametrize("dtype,fuse_tail", [("float32", False), ("bfloat16", True)])
def test_eval_step_replay_is_bit_equal_to_its_eager_run(cuda, dtype, fuse_tail):
    """Three batches of distinct images at B = 4, 480x640: the first call
    of the signature runs eagerly, the second captures, the third and a
    repeat of the first replay; each is bit-equal to the eager step on its
    batch. With bf16 and MODEL.RESNETS.FUSE_TAIL, B4's launches are inside
    the backbone's graph: they and `model.fused_tail_calls` count 24 per
    batch, at each of its replays."""
    cfg = _eval_cfg("MODEL.COMPUTE_DTYPE", dtype, "MODEL.RESNETS.FUSE_TAIL", str(fuse_tail))
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device=cuda, seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batches = _host_batches(cfg, 3)
    want = [_eager(step, model, b) for b in batches]
    graphs.drop(model)
    trace.reset()
    trace.enable()
    before = LAUNCHES.snapshot()
    try:
        got = [_host(step(*b)) for b in batches + batches[:1]]
    finally:
        trace.disable()
    launched = {n: c - before[n] for n, c in LAUNCHES.snapshot().items() if c != before[n]}
    assert launched == {"select_maps": 4, "sinkhorn": 4,
                        **({"bottleneck_tail": 4 * 24} if fuse_tail else {})}
    tails = trace.snapshot()["counts"].get("model.fused_tail_calls", 0)
    assert tails == (4 * 24 if fuse_tail else 0)
    segments = len(graphs.cache_of(model))
    assert segments == 12
    assert _graph_counts() == {"eval.graph_eager": segments, "eval.graph_captures": segments,
                               "eval.graph_replays": 2 * segments}
    for g, wnt in zip(got, want + want[:1]):
        _assert_same(g, wnt)


def test_eval_entry_point_with_graphs_gives_what_it_gives_eagerly(cuda):
    """`EvalRunner.test` over a split of 4 batches, with the graphs, and with
    the cache dropped before every call (every call eager): the same
    inference dicts reach the postprocess, and the same records and metrics
    come out. An output buffer that a later replay overwrote before its
    fetch would differ here."""
    cfg = _eval_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    bs = int(cfg.TEST.IMS_PER_BATCH)
    model = build_model_from_cfg(cfg, device=cuda, seed=0)
    split = make_dataset(4 * bs - 1, n_planes=12, seed=5, h=h, w=w)  # a padded tail batch
    post_fn, process_fn, make_fn = entry.postprocess_batch, MP3DEvaluator.process, entry.make_eval_step

    def run(eager):
        outs, records = [], []

        def postprocess_batch(out, metas, **kwargs):
            outs.append(out)
            return post_fn(out, metas, **kwargs)

        def process(self, inputs, outputs):
            process_fn(self, inputs, outputs)
            records.extend(self._predictions[-len(inputs):])

        def make_eval_step_eager(m, *args, **kwargs):
            step = make_fn(m, *args, **kwargs)

            def eager_step(*a, **k):
                graphs.drop(m)
                return step(*a, **k)
            return eager_step

        entry.postprocess_batch, MP3DEvaluator.process = postprocess_batch, process
        if eager:
            entry.make_eval_step = make_eval_step_eager
        try:
            results = entry.EvalRunner(cfg, model).test(split)
        finally:
            entry.postprocess_batch, MP3DEvaluator.process = post_fn, process_fn
            entry.make_eval_step = make_fn
        return outs, records, results

    graphs.drop(model)
    ref = run(eager=True)
    graphs.drop(model)
    run(eager=False)  # the signature's eager call and capture
    got = run(eager=False)
    assert len(graphs.cache_of(model)) == 12 and len(got[0]) == 4
    for a, b in zip(got[0], ref[0]):
        _assert_same(a, b)
    assert len(got[1]) == 4 * bs - 1 and _deep_equal(got[1], ref[1])
    assert _deep_equal(dict(got[2]), dict(ref[2]))


def test_eval_step_replay_reads_weights_changed_in_place(cuda):
    cfg = _eval_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device=cuda, seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batch = _host_batches(cfg, 1)[0]
    for _ in range(2):
        before = _host(step(*batch))
    with torch.no_grad():  # the plane head's and the camera head's last layers
        model.sem_seg_head.plane_param.layers[-1].bias.add_(0.05)
        model.camera_head.trans.bias.add_(0.1)
    graphed = _host(step(*batch))
    assert len(graphs.cache_of(model)) == 12
    want = _eager(step, model, batch)
    _assert_same(graphed, want)
    assert not np.array_equal(graphed["cameras"]["camera_init"]["tran"],
                              before["cameras"]["camera_init"]["tran"])


def test_warm_replayed_eval_step_makes_the_host_wait_nowhere(cuda):
    cfg = _eval_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device=cuda, seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batches = _host_batches(cfg, 3)
    want = _eager(step, model, batches[2])
    for b in batches[:2]:
        _host(step(*b))
    trace.reset()
    trace.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _fetch(step(*batches[2]))
        done = torch.cuda.Event()
        done.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        trace.disable()
    done.synchronize()
    assert _graph_counts() == {"eval.graph_replays": 12}
    _assert_same(_numpy(out), want)


def test_graphed_eval_step_calls_each_wrapped_name_once_per_batch(cuda):
    """The calls that a benchmark wraps (the backbone's and the matching
    head's forward, B1 and B2 by their module names) stay outside the
    graphs: after the capture each is made once per batch."""
    cfg = _eval_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device=cuda, seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    calls, undo = {}, []

    def wrap(name, obj, attr):
        fn = getattr(obj, attr)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        setattr(obj, attr, counted)
        undo.append(lambda: setattr(obj, attr, fn))

    wrap("backbone", model.backbone, "forward")
    wrap("matching_head", model.matching_head, "forward")
    wrap("select", nopesac, "fused_select_maps")
    wrap("sinkhorn", matching_head, "log_optimal_transport_masked")
    try:
        batches = _host_batches(cfg, 5)
        for b in batches[:2]:
            _host(step(*b))
        calls.clear()
        for b in batches[2:]:
            _host(step(*b))
    finally:
        for u in undo:
            u()
    assert len(graphs.cache_of(model)) == 12
    assert calls == dict.fromkeys(("backbone", "matching_head", "select", "sinkhorn"), 3)
