"""The FLOP count and the roofline bounds: the hand count of ResNet-50 and
the meta-device count against FlopCounterMode over the reference run on
real tensors at a small size, the configurations' recorded numbers against
the count at their own size, and the bounds' arithmetic by hand."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench.harness import cells, flops, roofline
from cardbench.reference.build import Cfg, build_model

from conftest import SMALL


def _tree(name, small=True):
    tree = json.loads(json.dumps(cells.data_file("configs", name)["cfg"]))
    if small:
        for key, value in SMALL.items():
            node = tree
            *head, last = key.split(".")
            for k in head:
                node = node[k]
            node[last] = value
    return tree


@pytest.mark.parametrize("h,w", [(96, 128), (480, 640), (64, 96)])
def test_resnet50_by_hand(h, w):
    with torch.device("meta"):
        model = build_model(Cfg(_tree("nopesac_mp3d_eval")))
        model.requires_grad_(False)
        fc = FlopCounterMode(display=False)
        with fc:
            model.backbone(torch.zeros(1, 3, h, w))
    assert fc.get_total_flops() == flops.resnet50_flops(h, w)


def test_meta_count_equals_a_real_run():
    """The meta count (with its shape-only stand-ins) equals the counter
    over the reference's inference on real tensors on the CPU."""
    tree = _tree("nopesac_mp3d_eval")
    model = build_model(Cfg(tree))
    model.requires_grad_(False)
    x = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(0))
    fc = FlopCounterMode(display=False)
    with fc:
        model.inference(x, x, out_h=96, out_w=128)
    assert flops.count(tree, train=False, pairs=2)["forward"] == fc.get_total_flops()


def test_train_count_has_every_part():
    tree = _tree("nopesac_mp3d_train_step3")
    c = flops.count(tree, train=True, pairs=2)
    inference = flops.count(tree, train=False, pairs=2)
    assert c["ResNet"] == 4 * flops.resnet50_flops(96, 128)
    assert c["forward"] > inference["forward"] > 0
    for part in ("PlaneTRHead", "MatchingHead", "MLP"):
        assert c[part] > 0


@pytest.mark.parametrize("name,train", [("nopesac_mp3d_eval", False),
                                        ("nopesac_mp3d_train_step3", True)])
def test_recorded_counts(name, train):
    config = cells.data_file("configs", name)
    tree = _tree(name, small=False)
    if train:
        c = flops.count(tree, train=True, pairs=tree["SOLVER"]["IMS_PER_BATCH"])
        assert config["flops"]["train_per_step"] == 3 * c["forward"]
    else:
        assert config["flops"]["eval_per_pair"] == flops.count(tree, train=False)["forward"]


def test_bounds_by_hand():
    # B1 at the eval batch: [8, 50, 120, 160] f32 probabilities to 480x640
    n_bytes = 8 * 50 * 120 * 160 * 4 + 8 * 50 * 5 + 2 * 8 * 480 * 640 * 4 + 8 * 7 * 50 * 4
    n_ops = 8 * 50 * 480 * 640 * 6.25
    assert roofline.select_bound_s(8, 50, 120, 160, 480, 640, 4) == max(
        n_bytes / 3.35e12, n_ops / 67e12)
    assert n_bytes / 3.35e12 > n_ops / 67e12  # f32 probabilities: bound by bytes
    # B2: [4, 50, 50] at 200 iterations
    assert roofline.sinkhorn_bound_s(4, 50, 50, 200) == pytest.approx(
        4 * 200 * 2 * 51 * 51 * 5 / 67e12)
    # B3: 384 matched queries of [32, 50, 120, 160] f32 logits
    px = 16 * 120 * 160
    read = 384 * (120 * 160 * 4 + px) + 32 * 50 * 4
    fwd = max((read + 32 * 50 * 16) / 3.35e12, 384 * px * 39 / 67e12)
    bwd = max((read + 32 * 50 * 12 + 32 * 50 * 120 * 160 * 4) / 3.35e12, 384 * px * 55 / 67e12)
    assert roofline.mask_loss_bound_s(32, 50, 120, 160, 384, 4) == pytest.approx(fwd + bwd)
