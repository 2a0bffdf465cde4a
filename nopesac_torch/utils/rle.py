"""COCO-compatible RLE mask codec and IoU in numpy (the port's own copy of the
reference codec; it replaces the pycocotools C extension).

The byte format is the standard COCO compressed RLE: column-major (Fortran
order) run lengths, LEB128-style base-6-bit ascii with sign-folded deltas
from the fourth count on. Every encoder here is byte-identical to
pycocotools' `encode`. `iou` works on the run lengths, with no dense mask: its
intersections are overlaps of sorted on-runs, so its cost grows with the
number of runs, not of pixels, and it is exact (integer areas). There is no
native host codec.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, Union[Sequence[int], bytes, str]]


def counts_to_string(runs) -> bytes:
    """Raw run-length counts -> COCO LEB string: 6-bit groups, bit 5 the
    continuation, counts[i >= 3] stored as deltas from counts[i - 2]."""
    out = bytearray()
    cnts = np.asarray(runs, np.int64)
    for i in range(len(cnts)):
        x = int(cnts[i])
        if i > 2:  # deltas start at index 3, like the COCO C codec
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _string_to_counts(s) -> np.ndarray:
    """Parse a COCO LEB string: group bytes by the continuation bit, sum each
    group's 5-bit digits, sign-extend, then undo the stride-2 deltas as two
    cumulative sums."""
    if isinstance(s, str):
        s = s.encode("ascii")
    if not s:
        return np.zeros(0, np.int64)
    b = np.frombuffer(s, np.uint8).astype(np.int64) - 48
    ends = np.nonzero((b & 0x20) == 0)[0]  # last byte of each value
    if ends.size == 0 or ends[-1] != len(b) - 1:
        # a trailing continuation bit: the tail bytes make a final value
        ends = np.concatenate([ends, [len(b) - 1]])
    starts = np.concatenate([[0], ends[:-1] + 1])
    k = np.arange(len(b)) - np.repeat(starts, ends - starts + 1)
    x = np.add.reduceat((b & 0x1F) << (5 * k), starts)
    nbits = 5 * (ends - starts + 1)
    neg = (b[ends] & 0x10) != 0
    x = np.where(neg, x - (np.int64(1) << nbits), x)
    if len(x) > 3:
        x[3::2] = x[1] + np.cumsum(x[3::2])
    if len(x) > 4:
        x[4::2] = x[2] + np.cumsum(x[4::2])
    return x.astype(np.int64)


def encode(mask: np.ndarray) -> RLE:
    """Binary mask [H, W] (any dtype, non-zero is on) -> {"size": [H, W],
    "counts": bytes}, column-major."""
    h, w = mask.shape
    flat = mask.T.reshape(-1) != 0
    if flat.size == 0:
        return {"size": [int(h), int(w)], "counts": counts_to_string(np.asarray([0]))}
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0]:  # the runs start with a zero-run
        runs = np.concatenate([[0], runs])
    return {"size": [int(h), int(w)], "counts": counts_to_string(runs)}


def _to_runs(rle: RLE) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return _string_to_counts(counts)
    return np.asarray(list(counts), dtype=np.int64)


def decode(rle: RLE) -> np.ndarray:
    """Compressed (or uncompressed-list) RLE -> uint8 mask [H, W]."""
    h, w = rle["size"]
    runs = _to_runs(rle)
    vals = np.zeros(len(runs), dtype=np.uint8)
    vals[1::2] = 1
    # a malformed encoding can give negative deltas: count them as 0
    flat = np.repeat(vals, np.maximum(runs, 0))
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[: h * w].reshape(w, h).T


def area(rle: RLE) -> int:
    return int(_to_runs(rle)[1::2].sum())


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE -> [x, y, w, h] bbox, as pycocotools' toBbox."""
    h, _ = rle["size"]
    runs = _to_runs(rle)
    if runs[1::2].sum() == 0:
        return np.zeros(4)
    ends = np.cumsum(runs)
    starts = ends - runs
    on_s = starts[1::2]
    on_e = ends[1::2] - 1
    cols_s, cols_e = on_s // h, on_e // h
    x0, x1 = int(cols_s.min()), int(cols_e.max())
    if (cols_e > cols_s).any():  # a run over several columns covers every row
        y0, y1 = 0, h - 1
    else:
        y0, y1 = int((on_s % h).min()), int((on_e % h).max())
    return np.asarray([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dtype=np.float64)


def _on_runs(rle: RLE, n: int):
    """An RLE's on-runs as [start, end) of the column-major flat index, as
    `decode` fills them: negative counts count as 0 and nothing passes pixel
    n. Sorted, disjoint, possibly empty."""
    ends = np.minimum(np.cumsum(np.maximum(_to_runs(rle), 0)), n)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    return starts[1::2], ends[1::2]


def iou(dt: List[RLE], gt: List[RLE], iscrowd=None) -> np.ndarray:
    """Pairwise mask IoU matrix [len(dt), len(gt)] (pycocotools.mask.iou).

    The gt masks' on-runs, each mask shifted by its index times H*W, make one
    sorted list; the length of it below a point x is one `searchsorted`. Each
    dt run [s, e) overlaps gt j by that length at e + j*H*W less that at
    s + j*H*W, and a dt mask's intersection is the sum over its runs. Every
    mask must have the same size."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    h, w = dt[0]["size"]
    for r in list(dt) + list(gt):
        if tuple(r["size"]) != (h, w):
            raise ValueError(f"RLE size mismatch in iou: {r['size']} vs {[h, w]}")
    n = int(h) * int(w)
    d_runs = [_on_runs(r, n) for r in dt]
    g_runs = [_on_runs(r, n) for r in gt]
    offsets = np.arange(len(gt), dtype=np.int64) * n
    # the gt table, closed by a run past every query so each lookup has a next run
    sentinel = np.asarray([len(gt) * n + 1], np.int64)
    g_starts = np.concatenate([s + o for (s, _), o in zip(g_runs, offsets)] + [sentinel])
    g_ends = np.concatenate([e + o for (_, e), o in zip(g_runs, offsets)] + [sentinel])
    g_cum = np.concatenate([[0], np.cumsum(g_ends - g_starts)[:-1]])

    def covered(x):  # the table's length below each x
        k = np.searchsorted(g_ends, x, side="right")
        return g_cum[k] + np.maximum(x - g_starts[k], 0)

    d_starts = np.concatenate([s for s, _ in d_runs])
    d_ends = np.concatenate([e for _, e in d_runs])
    per_run = covered(d_ends[:, None] + offsets) - covered(d_starts[:, None] + offsets)
    # a dt mask's runs are a block of rows: sum each block by a cumulative sum
    bounds = np.cumsum([0] + [len(s) for s, _ in d_runs])
    acc = np.concatenate([np.zeros((1, len(gt)), np.int64), np.cumsum(per_run, axis=0)])
    inter = acc[bounds[1:]] - acc[bounds[:-1]]

    dt_a = np.asarray([int((e - s).sum()) for s, e in d_runs], np.int64)[:, None]
    gt_a = np.asarray([int((e - s).sum()) for s, e in g_runs], np.int64)[None, :]
    crowd = np.asarray([bool(iscrowd[j]) if iscrowd is not None else False
                        for j in range(len(gt))])
    denom = np.where(crowd[None, :], dt_a, dt_a + gt_a - inter)
    out = np.zeros((len(dt), len(gt)))
    np.divide(inter, denom, out=out, where=denom > 0)
    return out


def merge(rles: List[RLE], intersect: bool = False) -> RLE:
    """Union (or intersection) of masks, like pycocotools merge."""
    if not rles:
        return {"size": [0, 0], "counts": b""}
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        other = decode(r).astype(bool)
        m = m & other if intersect else m | other
    return encode(m)


def poly_to_mask(polys: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Polygons [x0, y0, x1, y1, ...] -> binary mask by scanline fill
    (pycocotools frPoly equivalent, PIL-backed)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = [(float(poly[i]), float(poly[i + 1])) for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def seg_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list or RLE dict) -> uint8 mask."""
    if isinstance(seg, dict):
        return decode(seg)
    return poly_to_mask(seg, h, w)


def encode_label_map(labels: np.ndarray, query_ids: Sequence[int]) -> List[RLE]:
    """Per-query COCO RLEs from an argmax label map in one pass.

    labels: [H, W] int map (background: any id not in query_ids, e.g. -1).
    Returns, aligned with query_ids, each query's compressed RLE,
    byte-identical to encode(labels == q), with its raw runs under "_runs".
    The label map's own run segments are split per query, so no [K, H, W]
    masks are built and scanned.
    """
    h, w = labels.shape
    flat = labels.T.reshape(-1)  # column-major, like the COCO codec
    total = flat.size
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [total]])
    seg_starts = bounds[:-1]
    seg_lens = np.diff(bounds)
    seg_labels = flat[seg_starts]

    out: List[RLE] = []
    for q in query_ids:
        sel = seg_labels == q
        s, ln = seg_starts[sel], seg_lens[sel]
        if s.size == 0:
            runs = np.asarray([total], np.int64)  # an all-zero mask
        else:
            runs = np.empty(s.size * 2 + 1, np.int64)
            runs[0] = s[0]
            runs[2:-1:2] = s[1:] - (s[:-1] + ln[:-1])  # gaps between on-runs
            runs[1::2] = ln
            runs[-1] = total - (int(s[-1]) + int(ln[-1]))
            if runs[-1] == 0:  # encode() emits no trailing zero-run
                runs = runs[:-1]
        out.append({"size": [int(h), int(w)], "counts": counts_to_string(runs), "_runs": runs})
    return out
