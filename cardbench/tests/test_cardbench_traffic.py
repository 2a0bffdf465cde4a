"""The benchmark's copy of the scene generator against the program's."""
from __future__ import annotations

import numpy as np
import pytest

from cardbench.harness import scenes
from cardbench.traffic.synthetic import make_pair
from nopesac_torch.data.synthetic import make_pair as program_make_pair


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("seed,planes,h,w", [(0, 6, 96, 128), (17, 12, 96, 128),
                                             (2**31 + 3, 12, 480, 640), (5, 4, 480, 640)])
def test_generator_equals_the_programs(seed, planes, h, w):
    for pair_id in (0, 9):
        got = make_pair(np.random.default_rng(seed), n_planes=planes, h=h, w=w, pair_id=pair_id)
        want = program_make_pair(np.random.default_rng(seed), n_planes=planes, h=h, w=w,
                                 pair_id=pair_id)
        assert _equal(got, want)


def test_without_dense_masks_only_the_masks_go():
    got = make_pair(np.random.default_rng(3), n_planes=5, h=96, w=128, dense_masks=False)
    want = make_pair(np.random.default_rng(3), n_planes=5, h=96, w=128)
    for v in ("0", "1"):
        for ann in want[v]["annotations"]:
            ann.pop("mask")
    assert _equal(got, want)


def test_splits_draw_every_pool_pair_once_per_pass():
    pool = scenes.pool(np.random.default_rng(0), 4, 3, 96, 128)
    split = scenes.split(np.random.default_rng(1), pool, 8, 100)
    ids = [p["0"]["image_id"] for p in split]
    assert ids == [f"synth{100 + i}_0" for i in range(8)]
    firsts = [next(k for k, q in enumerate(pool) if q["0"]["image"] is p["0"]["image"])
              for p in split]
    assert sorted(firsts[:4]) == [0, 1, 2, 3] and sorted(firsts[4:]) == [0, 1, 2, 3]
