"""2D visualisation: labelled segmentations, cross-view match drawing and
the affinity figures (the port's copy of the JAX package's
`visualization/vis2d.py`: the same library calls, so the same pixels).

Spec: visualization/visualization.py (draw_match:190, create_instances:306,
get_labeled_seg:328, save_affinity_after_stitch:53-86), with PIL and
matplotlib (Agg) in place of cv2, detectron2 and seaborn. Both are imported
inside the functions that draw.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils import rle as rle_util

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200], [245, 130, 48],
    [145, 30, 180], [70, 240, 240], [240, 50, 230], [210, 245, 60], [250, 190, 190],
    [0, 128, 128], [230, 190, 255], [170, 110, 40], [255, 250, 200], [128, 0, 0],
    [170, 255, 195], [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], dtype=np.uint8)


def color_for(i: int) -> np.ndarray:
    return _PALETTE[i % len(_PALETTE)]


def create_instances(predictions: List[dict], image_size, pred_planes=None,
                     conf_threshold: float = 0.7) -> Dict:
    """Prediction dicts -> {scores, pred_classes, pred_planes, pred_masks}
    filtered by score (visualization.py:306-326)."""
    score = np.asarray([x["score"] for x in predictions])
    chosen = np.nonzero(score > conf_threshold)[0]
    out = {
        "image_size": tuple(image_size),
        "scores": score[chosen],
        "pred_classes": np.asarray([predictions[i]["category_id"] for i in chosen]),
        "pred_masks": [predictions[i]["segmentation"] for i in chosen],
    }
    if pred_planes is not None:
        out["pred_planes"] = np.asarray([pred_planes[i] for i in chosen])
    return out


def get_labeled_seg(image: np.ndarray, masks, alpha: float = 0.5,
                    assigned_colors: Optional[np.ndarray] = None) -> np.ndarray:
    """Overlay instance masks on an RGB uint8 image (visualization.py:328)."""
    out = np.asarray(image, np.float64).copy()
    for i, m in enumerate(masks):
        if isinstance(m, dict):
            m = rle_util.decode(m)
        m = np.asarray(m) > 0
        color = (assigned_colors[i] if assigned_colors is not None else color_for(i)).astype(np.float64)
        out[m] = out[m] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def mask_center(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(2)
    return np.array([xs.mean(), ys.mean()])


def draw_match(image0: np.ndarray, image1: np.ndarray, masks0, masks1,
               corrs: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Side-by-side pair with mask overlays + correspondence lines
    (visualization.py:190-303). corrs: [M, 2] index pairs."""
    from PIL import Image, ImageDraw

    corrs = np.asarray(corrs).reshape(-1, 2)
    masks0 = [rle_util.decode(m) if isinstance(m, dict) else np.asarray(m) for m in masks0]
    masks1 = [rle_util.decode(m) if isinstance(m, dict) else np.asarray(m) for m in masks1]

    # matched planes share a color; unmatched stay grey
    colors0 = np.full((len(masks0), 3), 160, np.uint8)
    colors1 = np.full((len(masks1), 3), 160, np.uint8)
    for k, (i, j) in enumerate(corrs):
        colors0[i] = color_for(k)
        colors1[j] = color_for(k)

    vis0 = get_labeled_seg(image0, masks0, alpha, colors0)
    vis1 = get_labeled_seg(image1, masks1, alpha, colors1)
    h = max(vis0.shape[0], vis1.shape[0])
    w0 = vis0.shape[1]
    canvas = np.zeros((h, w0 + vis1.shape[1], 3), np.uint8)
    canvas[: vis0.shape[0], :w0] = vis0
    canvas[: vis1.shape[0], w0:] = vis1

    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    for k, (i, j) in enumerate(corrs):
        c0 = mask_center(masks0[i] > 0)
        c1 = mask_center(masks1[j] > 0) + np.array([w0, 0])
        col = tuple(int(v) for v in color_for(k))
        draw.line([tuple(c0), tuple(c1)], fill=col, width=3)
        for c in (c0, c1):
            draw.ellipse([c[0] - 5, c[1] - 5, c[0] + 5, c[1] + 5], fill=col)
    return np.asarray(img)


def save_affinity(affinity: np.ndarray, path: str) -> None:
    """Affinity/assignment matrix as a grayscale image (quick raw dump)."""
    from PIL import Image

    a = np.asarray(affinity, np.float64)
    a = (a - a.min()) / max(a.max() - a.min(), 1e-9)
    Image.fromarray((a * 255).astype(np.uint8)).resize(
        (a.shape[1] * 8, a.shape[0] * 8), Image.NEAREST
    ).save(path)


def save_affinity_stitched(affinity: np.ndarray, sz_i: int, sz_j: int,
                           matching, path: str) -> None:
    """Annotated affinity heatmap: per-cell scores plus '*' on the selected
    matches, padded to a 5/10-aligned square like the reference figure
    (visualization.py:53-86, save_affinity_after_stitch; matplotlib
    replaces the seaborn dependency)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(affinity, np.float64)
    sz_i = min(sz_i, a.shape[0])
    sz_j = min(sz_j, a.shape[1])
    max_sz = max(sz_i, sz_j)
    max_sz = 5 if max_sz < 5 else (10 if max_sz < 10 else max_sz)
    # zero-PAD to the aligned square (reference labels_full, :74-76) rather
    # than truncate — a 7x4 affinity must show all 7 rows
    vis = np.zeros((max_sz, max_sz))
    vis[:sz_i, :sz_j] = a[:sz_i, :sz_j]
    matched = {(i, int(j)) for i, j in enumerate(np.asarray(matching).tolist())
               if int(j) != -1}

    fig, ax = plt.subplots(figsize=(max(4, max_sz * 0.6),) * 2)
    im = ax.imshow(vis, vmin=0.0, vmax=1.0, cmap="rocket"
                   if "rocket" in plt.colormaps() else "magma")
    fig.colorbar(im, ax=ax)
    for i in range(max_sz):
        for j in range(max_sz):
            if i < sz_i and j < sz_j:
                star = "*\n" if (i, j) in matched else ""
                ax.text(j, i, f"{star}{vis[i, j]:.2f}", ha="center", va="center",
                        fontsize=7, color="w" if vis[i, j] < 0.5 else "k")
    ax.set_xticks(range(max_sz))
    ax.set_yticks(range(max_sz))
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
