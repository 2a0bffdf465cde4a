"""The port's run-based mask IoU (`nopesac_torch/utils/rle.py:iou`) against
the dense definition (`logical_and` / `logical_or` over decoded masks) and
the JAX package's `iou`, bit for bit, case by case.

The JAX package's `iou` is compared twice: through its numpy path (its
native codec switched off) on every case, and through its native codec where
that is built, on the cases that codec takes: well-formed counts (it sums
negative counts and counts past H*W as they are, which `decode` does not).
"""
import numpy as np
import pytest

from nopesac_tpu.utils import rle as jax_rle

from nopesac_torch.utils import rle


def _blocks(rng, h, w, n=3):
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y:y + rng.integers(1, h + 1), x:x + rng.integers(1, w + 1)] = 1
    return m


def _noise(rng, h, w, p):
    return (rng.uniform(size=(h, w)) < p).astype(np.uint8)


def _random(seed):
    """Seeded masks of a seeded size: blocks, sparse and dense noise, one of
    them empty and one full, split into dt and gt."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    masks = [_blocks(rng, h, w), _blocks(rng, h, w, 8), _noise(rng, h, w, 0.05),
             _noise(rng, h, w, 0.5), np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
             _blocks(rng, h, w, 1)]
    rles = [rle.encode(m) for m in rng.permutation(np.asarray(masks))]
    return rles[:3], rles[3:], None


def _shape(h, w):
    def make():
        rng = np.random.default_rng(h * 1000 + w)
        masks = [_noise(rng, h, w, p) for p in (0.1, 0.5, 0.9)] + [_blocks(rng, h, w)]
        return [rle.encode(m) for m in masks[:2]], [rle.encode(m) for m in masks], None
    return make


def _many_runs():
    rng = np.random.default_rng(21)
    dt = [rle.encode(_noise(rng, 48, 64, p)) for p in (0.3, 0.5)]
    gt = [rle.encode(_noise(rng, 48, 64, 0.5)), rle.encode(_blocks(rng, 48, 64, 20))]
    return dt, gt, None


def _empty_and_full():
    z, o = np.zeros((9, 7), np.uint8), np.ones((9, 7), np.uint8)
    half = o.copy()
    half[:, :3] = 0
    rles = [rle.encode(m) for m in (z, o, half)]
    return rles, rles, None


def _crowd():
    rng = np.random.default_rng(5)
    dt = [rle.encode(_blocks(rng, 30, 40)) for _ in range(3)] + [rle.encode(np.zeros((30, 40)))]
    gt = [rle.encode(_blocks(rng, 30, 40)) for _ in range(4)] + [rle.encode(np.ones((30, 40)))]
    return dt, gt, [1, 0, 2, 0, 1]


def _list_counts():
    """Uncompressed counts (as dataset files store them) beside compressed ones."""
    dt, gt, _ = _random(11)

    def as_list(r):
        return {"size": r["size"], "counts": [int(c) for c in rle._to_runs(r)]}

    return dt[:1] + [as_list(dt[1])], gt + [as_list(r) for r in gt[::2]], None


def _empty_dt():
    return [], _random(3)[1], None


def _empty_gt():
    return _random(3)[0], [], None


def _malformed():
    """Negative runs, a trailing continuation bit, and counts past and short
    of H*W: `decode` counts a negative run as 0, cuts at H*W and fills the
    rest with 0."""
    size = [8, 8]
    ok = rle.encode(_blocks(np.random.default_rng(9), 8, 8, 4))
    dt = [{"size": size, "counts": b"5M:"}, {"size": size, "counts": b"5M\x7f"},
          {"size": size, "counts": [3, -4, 6, 70]}, ok]
    gt = [{"size": size, "counts": [2, 5, -1, 9, 7, 100]}, {"size": size, "counts": [10, 20]},
          {"size": size, "counts": [0, 64]}, ok, {"size": size, "counts": b""}]
    return dt, gt, [0, 0, 1, 0, 0]


CASES = {
    **{f"random{seed}": (lambda s=seed: _random(s)) for seed in range(8)},
    "single_row": _shape(1, 57),
    "single_column": _shape(43, 1),
    "one_pixel": _shape(1, 1),
    "many_runs": _many_runs,
    "empty_and_full": _empty_and_full,
    "crowd": _crowd,
    "list_counts": _list_counts,
    "empty_dt": _empty_dt,
    "empty_gt": _empty_gt,
    "malformed": _malformed,
    "size_mismatch": None,
}


def _dense(dt, gt, iscrowd):
    """The definition: integer intersection and union (or the dt's area for
    a crowd gt) over the decoded masks, 0 where the denominator is 0."""
    out = np.zeros((len(dt), len(gt)))
    for i, d in enumerate(dt):
        dm = rle.decode(d).astype(bool)
        for j, g in enumerate(gt):
            gm = rle.decode(g).astype(bool)
            inter = np.logical_and(dm, gm).sum()
            crowd = iscrowd is not None and bool(iscrowd[j])
            denom = dm.sum() if crowd else np.logical_or(dm, gm).sum()
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def _well_formed(r):
    runs = rle._to_runs(r)
    h, w = r["size"]
    return bool((runs >= 0).all()) and int(runs.sum()) <= h * w


@pytest.mark.parametrize("case", list(CASES))
def test_iou_is_the_dense_iou_and_the_jax_iou(case, monkeypatch):
    if case == "size_mismatch":
        a, b = rle.encode(np.ones((8, 8), np.uint8)), rle.encode(np.ones((4, 16), np.uint8))
        for dt, gt in (([a], [b]), ([a], [a, b]), ([a, b], [a])):
            with pytest.raises(ValueError):
                rle.iou(dt, gt, [0] * len(gt))
            if jax_rle._HAVE_NATIVE:
                with pytest.raises(ValueError):
                    jax_rle.iou(dt, gt, [0] * len(gt))
        return
    dt, gt, iscrowd = CASES[case]()
    crowd = [0] * len(gt) if iscrowd is None else iscrowd
    got = rle.iou(dt, gt, crowd)
    assert got.dtype == np.float64 and got.shape == (len(dt), len(gt))
    assert np.array_equal(got, _dense(dt, gt, crowd)), case
    if iscrowd is None:
        assert np.array_equal(rle.iou(dt, gt), got)
    if jax_rle._HAVE_NATIVE and all(_well_formed(r) for r in dt + gt):
        assert np.array_equal(got, jax_rle.iou(dt, gt, crowd)), case
    monkeypatch.setattr(jax_rle, "_HAVE_NATIVE", False)
    assert np.array_equal(got, jax_rle.iou(dt, gt, crowd)), case
    # each case with room for it reaches an IoU strictly between 0 and 1
    assert ((got > 0) & (got < 1)).any() or case in ("empty_dt", "empty_gt", "one_pixel"), case
