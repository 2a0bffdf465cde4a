"""The model's FLOPs per eval pair and per train step: the convolutions and
matrix products of the reference's forward pass, counted by
`torch.utils.flop_counter.FlopCounterMode` on the meta device at the
configuration's shapes (no memory, no data). A train step counts 3x its
forward (the backward twice the forward, without REMAT's recompute). The
mask loss (elementwise) and the matcher's solver count no FLOPs and are
stood in for by shape-only versions, which the meta device needs; so is the
data-dependent gather of the plane sequences. `ResNet-50` is also counted
by hand (`resnet50_flops`), which the tests hold to the counter."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

# ResNet-50 (d2 layout, stride in the 3x3): (blocks, bottleneck width, out) per stage
STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))


def resnet50_flops(h: int, w: int) -> int:
    """2 x MACs of the stem and the 16 bottlenecks' convolutions for one
    [3, h, w] image (stem 7x7/2, max-pool 3x3/2, stages at strides 4-32)."""
    conv = lambda cin, cout, k, ho, wo: 2 * cin * cout * k * k * ho * wo  # noqa: E731
    half = lambda n: (n - 1) // 2 + 1  # noqa: E731  (kernel 3 or 7, padding k // 2, stride 2)
    ho, wo = half(h), half(w)
    total = conv(3, 64, 7, ho, wo)
    ho, wo = half(ho), half(wo)
    cin = 64
    for s, (blocks, mid, out) in enumerate(STAGES):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            h2, w2 = (half(ho), half(wo)) if stride == 2 else (ho, wo)
            total += conv(cin, mid, 1, ho, wo) + conv(mid, mid, 3, h2, w2) + conv(mid, out, 1, h2, w2)
            if b == 0:
                total += conv(cin, out, 1, h2, w2)
            cin, ho, wo = out, h2, w2
    return total


@contextlib.contextmanager
def _shape_only():
    """Stand-ins that the meta device can run: the mask loss's sums, the
    matcher (GT k to query k) and the plane-sequence gather, each of the
    shapes the real one returns. None of them holds a matrix product."""
    from ..reference.losses import criterion
    from ..reference.models import camera_head

    def focal_dice(src, gt_masks, tgt_idx, matched=None):
        z = src.sum(dim=(2, 3)).float()
        return z, z, z, z

    def hungarian(cost, num_gt):
        p, nq, _ = cost.shape
        return torch.arange(nq, device=cost.device).expand(p, nq).clone()

    def to_sequence(a, max_matches):
        b = a.shape[0]
        idx = torch.zeros((b, max_matches), dtype=torch.int64, device=a.device)
        return idx, idx, torch.ones((b, max_matches), dtype=torch.bool, device=a.device), \
            torch.full((b,), max_matches, dtype=torch.int64, device=a.device)

    saved = (criterion.fused_focal_dice, criterion.hungarian, camera_head.assignment_to_sequence)
    criterion.fused_focal_dice, criterion.hungarian = focal_dice, hungarian
    camera_head.assignment_to_sequence = to_sequence
    try:
        yield
    finally:
        (criterion.fused_focal_dice, criterion.hungarian,
         camera_head.assignment_to_sequence) = saved


def count(tree: Dict, train: bool, pairs: int = 1, planes: int = 12) -> Dict[str, int]:
    """FLOPs of the reference's forward for `pairs` pairs of the config
    `tree`, by top-level module; a train step's total is 3x "forward"."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.build import Cfg, build_model

    cfg = Cfg(tree)
    h, w = cfg.INPUT.IMAGE_SIZE
    nq = cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES
    with torch.device("meta"), _shape_only():
        model = build_model(cfg)
        model.requires_grad_(False)
        fc = FlopCounterMode(display=False, depth=1)
        with fc:
            if train:
                model.train()
                model.train_forward(meta_batch(pairs, h, w, nq, planes), torch.Generator("cpu"),
                                    torch.zeros(64, 4), torch.zeros(64, 3))
            else:
                x = torch.zeros(pairs, 3, h, w)
                model.inference(x, x, out_h=h, out_w=w)
    out = {k: int(sum(v.values())) for k, v in fc.get_flop_counts().items() if "." not in k}
    out["forward"] = int(fc.get_total_flops())
    return out


def meta_batch(b: int, h: int, w: int, nq: int, planes: int) -> Dict:
    """A collated training batch's tensors (the wire format of the mapper)
    on the current (meta) device."""
    def targets():
        return {"gt_valid": torch.zeros(b, nq, dtype=torch.bool),
                "gt_params": torch.zeros(b, nq, 3), "gt_centers": torch.zeros(b, nq, 2),
                "depth": torch.zeros(b, h, w),
                "gt_masks_packed": torch.zeros(b, nq, h, w // 8, dtype=torch.uint8),
                "k_inv": torch.zeros(b, 3, 3)}
    return {"image0": torch.zeros(b, h, w, 3), "image1": torch.zeros(b, h, w, 3),
            "targets0": targets(), "targets1": targets(), "gt_pose": torch.zeros(b, 7),
            "corr_idx1": torch.zeros(b, nq, dtype=torch.int32),
            "corr_idx2": torch.zeros(b, nq, dtype=torch.int32),
            "corr_valid": torch.zeros(b, nq, dtype=torch.bool)}
