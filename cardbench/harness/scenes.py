"""Traffic from a mix's parameters: seeded synthetic two-view scenes
(`cardbench/traffic/synthetic.py`), a pool of distinct pairs made once per
run, and splits drawn from it under fresh image ids."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..traffic.synthetic import make_pair


def pool(rng: np.random.Generator, n: int, planes: int, h: int, w: int,
         dense_masks: bool = False) -> List[dict]:
    return [make_pair(rng, n_planes=planes, h=h, w=w, pair_id=i, dense_masks=dense_masks)
            for i in range(n)]


def relabel(pair: dict, uid: int) -> dict:
    """The pair under the ids of pair `uid` (its arrays shared)."""
    out = dict(pair)
    for v in ("0", "1"):
        view = dict(pair[v])
        view["image_id"] = f"synth{uid}_{v}"
        view["file_name"] = f"/nonexistent/synth_{uid}_{v}.jpg"
        out[v] = view
    return out


def split(rng: np.random.Generator, scenes: List[dict], n: int, first_uid: int) -> List[dict]:
    """n pairs drawn from the pool in a seeded order (each pool pair once
    per pass), numbered from `first_uid`."""
    order: List[int] = []
    while len(order) < n:
        order.extend(rng.permutation(len(scenes)).tolist())
    return [relabel(scenes[k], first_uid + i) for i, k in enumerate(order[:n])]


def images(pair: dict) -> Dict[str, np.ndarray]:
    return {v: np.asarray(pair[v]["image"], np.uint8) for v in ("0", "1")}
