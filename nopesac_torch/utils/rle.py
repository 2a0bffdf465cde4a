"""COCO-compatible RLE mask codec and IoU in numpy (the port's own copy of the
reference codec; it replaces the pycocotools C extension).

The byte format is the standard COCO compressed RLE: column-major (Fortran
order) run lengths, LEB128-style base-6-bit ascii with sign-folded deltas
from the fourth count on. Every encoder here is byte-identical to
pycocotools' `encode`. The port has this one numpy path; a native host codec
is not ported.
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


def iou(dt: List[RLE], gt: List[RLE], iscrowd=None) -> np.ndarray:
    """Pairwise mask IoU matrix [len(dt), len(gt)] (pycocotools.mask.iou)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    out = np.zeros((len(dt), len(gt)))
    dt_m = [decode(d).astype(bool) for d in dt]
    gt_m = [decode(g).astype(bool) for g in gt]
    dt_a = [m.sum() for m in dt_m]
    gt_a = [m.sum() for m in gt_m]
    for i, dm in enumerate(dt_m):
        for j, gm in enumerate(gt_m):
            inter = np.logical_and(dm, gm).sum()
            crowd = bool(iscrowd[j]) if iscrowd is not None else False
            denom = dt_a[i] if crowd else dt_a[i] + gt_a[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


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
