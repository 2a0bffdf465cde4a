"""What decides `correct` in the evaluation cells: the inference dicts of a
sample of the window's batches against the reference's on the same uint8
images and weights, and (where the evaluator ran) what it accumulated for
those pairs. Each number is a widest gap:

* `planes_gap`: each view's planes: the largest |difference| of a valid
  plane's parameters over the largest |parameter| of the reference's valid
  planes, or the share of (view, query) whose `valid` differs, or the share
  of (view, pixel) whose gated plane label (`seg_gated`: the query that owns
  the pixel, -1 where none) differs, whichever is largest: valid planes,
  labels, masks and parameters;
* `scores_gap`: the largest |difference| of the matching log-scores over
  the entries both sides hold finite, over the largest |log-score| there
  (infinite where the two differ in which entries are finite);
* `camera_gap`: the largest |difference| of the final camera's rotation
  (unit quaternion) and translation, over the largest |value| of the
  reference's (at least 1).
The labels are not a number of their own, nor are the matches (the
assignment, which follows from the log-scores): with seeded random weights
the control leaves them equal on some seeds, so no limit of their own could
separate it. The evaluator's records give `planes_gap` (the instances'
count per view, 1 where it differs, and `pred_plane`) and `camera_gap` from
their own copies."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _f(x) -> np.ndarray:
    return np.asarray(x, np.float64)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of one batch, both dicts as numpy arrays."""
    mism = []
    pgap, pscale = 0.0, 1e-12
    for v in ("view0", "view1"):
        a, b = prog[v], ref[v]
        va, vb = np.asarray(a["valid"], bool), np.asarray(b["valid"], bool)
        mism.append(float((va != vb).mean()))
        mism.append(float((np.asarray(a["seg_gated"]) != np.asarray(b["seg_gated"])).mean()))
        both = va & vb
        if both.any():
            pgap = max(pgap, float(np.abs(_f(a["params"]) - _f(b["params"]))[both].max()))
        if vb.any():
            pscale = max(pscale, float(np.abs(_f(b["params"]))[vb].max()))
    out = {"planes_gap": max(max(mism), pgap / pscale)}
    sa, sb = _f(prog["log_scores"]), _f(ref["log_scores"])
    fin = np.isfinite(sa) & np.isfinite(sb)
    same_inf = np.array_equal(np.isfinite(sa), np.isfinite(sb))
    sgap = float(np.abs(sa - sb)[fin].max()) if fin.any() else 0.0
    sscale = max(float(np.abs(sb[fin]).max()) if fin.any() else 1.0, 1e-12)
    out["scores_gap"] = sgap / sscale if same_inf else float("inf")
    ca, cb = prog["cameras"]["camera"], ref["cameras"]["camera"]
    cgap = max(float(np.abs(_f(ca[k]) - _f(cb[k])).max()) for k in ("rot", "tran"))
    cscale = max(1.0, max(float(np.abs(_f(cb[k])).max()) for k in ("rot", "tran")))
    out["camera_gap"] = cgap / cscale
    return out


def record_gaps(records: List[Dict], ref: Dict) -> Dict[str, float]:
    """The evaluator's records of one batch (one per pair, in order) against
    the reference's inference dict: instance counts and scores as the
    labels, `pred_plane` as the parameters, the final camera."""
    mism, pgap, pscale, cgap = 0.0, 0.0, 1e-12, 0.0
    for i, rec in enumerate(records):
        for v in ("0", "1"):
            view = ref[f"view{v}"]
            keep = np.nonzero(np.asarray(view["valid"][i], bool))[0]
            inst = rec[v].get("instances", [])
            if len(inst) != len(keep):
                mism = 1.0
                continue
            got = _f(rec[v]["pred_plane"]).reshape(-1, 3)
            want = _f(view["params"][i])[keep]
            if len(keep):
                pgap = max(pgap, float(np.abs(got - want).max()))
                pscale = max(pscale, float(np.abs(want).max()))
        cam = rec.get("camera", {}).get("pred")
        if cam is None:
            cgap = float("inf")
            continue
        want = ref["cameras"]["camera"]
        scale = max(1.0, float(np.abs(_f(want["rot"][i])).max()),
                    float(np.abs(_f(want["tran"][i])).max()))
        for k in ("rot", "tran"):
            cgap = max(cgap, float(np.abs(_f(cam[k]).reshape(-1) - _f(want[k][i])).max()) / scale)
    return {"planes_gap": max(mism, pgap / pscale), "camera_gap": cgap}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    keys = sorted({k for r in rows for k in r})
    return {k: max(r[k] for r in rows if k in r) for k in keys}


def to_numpy(tree):
    """A tree of tensors on any device as numpy (bf16 widened to f32)."""
    import torch

    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def reference_outputs(ctx, ref, batches) -> List[Dict]:
    """The reference's inference dicts (numpy) of each batch of pairs, on
    the pairs' own uint8 images."""
    import torch

    from ..reference.build import eval_step
    from .scenes import images

    outs = []
    for pairs in batches:
        im = [torch.from_numpy(np.stack([images(p)[v] for p in pairs])) for v in "01"]
        outs.append(to_numpy(eval_step(ref, im[0], im[1], ctx.ref_cfg())))
    return outs
