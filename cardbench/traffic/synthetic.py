"""Seeded synthetic two-view scenes with exact relative poses: the
benchmark's copy of the port's generator (`nopesac_torch/data/synthetic.py:
make_pair`), which gives the same pairs for the same draws. It fills each
plane's depth and colour inside the plane's own cell only, which gives the
same arrays in a tenth of the time, and `dense_masks=False` leaves out the
annotations' dense `"mask"` (what an evaluation split carries: the COCO RLE
`segmentation`, as real annotations do).

Geometry: a relative pose and view-0 planes are drawn; view-1 plane params
come from the exact plane warp, so matching and pose have known optima. Each
plane owns one cell of a 4 x 3 grid of the image.
"""
from __future__ import annotations

import functools

import numpy as np

from ..reference.utils import rle
from ..reference.data.mapper import DEFAULT_FOCAL

FLIP = np.array([1.0, -1.0, -1.0])


def _quat_to_rotmat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def _warp_plane_np(p, q, t):
    """The plane warp of `core/geometry.py:warp_planes_to_global` in numpy."""
    r = _quat_to_rotmat_np(q)
    end = r @ (p * FLIP) + t
    b = end - t
    scale = float(end @ b) / (np.linalg.norm(b) + 1e-5) ** 2
    return scale * b


@functools.lru_cache(maxsize=4)
def _rays(h: int, w: int) -> np.ndarray:
    """K^-1 . xy1 ray map [3, H, W] of the mapper's default intrinsics, the
    pixel grid rescaled to w x h."""
    k = np.array([[DEFAULT_FOCAL, 0, 320.0], [0, DEFAULT_FOCAL, 240.0], [0, 0, 1.0]])
    k_inv = np.linalg.inv(k)
    x = (np.arange(w, dtype=np.float64) / w * 640.0)[None, :].repeat(h, 0)
    y = (np.arange(h, dtype=np.float64) / h * 480.0)[:, None].repeat(w, 1)
    xy1 = np.stack([x, y, np.ones((h, w))]).reshape(3, -1)
    rays = (k_inv @ xy1).reshape(3, h, w)
    rays.flags.writeable = False
    return rays


def _plane_depth(p: np.ndarray, rays: np.ndarray, max_depth: float = 10.0) -> np.ndarray:
    """Analytic per-pixel plane depth offset / (n . ray) [H, W]; non-positive
    or too-far intersections are 0 (invalid)."""
    offset = np.linalg.norm(p)
    normal = p / max(offset, 1e-10)
    ntr = np.einsum("c,chw->hw", normal, rays)
    depth = offset / np.where(np.abs(ntr) < 1e-4, 1e-4, ntr)
    return np.where((depth > 0) & (depth <= max_depth), depth, 0.0).astype(np.float32)


def make_pair(rng: np.random.Generator, n_planes: int = 6, h: int = 480, w: int = 640,
              pair_id: int = 0, dense_masks: bool = True) -> dict:
    """One pair dict: views "0" and "1" (image uint8 [H, W, 3], depth, one
    annotation per plane with its RLE, dense mask and params), "rel_pose"
    and "gt_corrs" (plane i of view 0 is plane i of view 1)."""
    # relative pose: modest rotation + translation, w >= 0
    rv = rng.normal(size=3) * 0.3
    angle = np.linalg.norm(rv)
    axis = rv / max(angle, 1e-9)
    q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
    if q[0] < 0:
        q = -q
    t = rng.normal(size=3) * 0.5

    rays = _rays(h, w)
    cell_w, cell_h = w // 4, h // 3

    def cell_center_ray(i: int) -> np.ndarray:
        gx, gy = i % 4, (i // 4) % 3
        return rays[:, gy * cell_h + cell_h // 2, gx * cell_w + cell_w // 2]

    # well-separated base normals on the camera-facing hemisphere, each plane
    # a codebook direction with small jitter
    ring = [(np.cos(a), np.sin(a)) for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
    base_dirs = np.array(
        [[0.0, 0.0, 1.0]] + [[0.72 * c, 0.72 * s, 0.69] for c, s in ring]
        + [[0.97 * c, 0.97 * s, 0.26] for c, s in ring[::2]]
    )
    views = {"0": [], "1": []}
    gt_corrs = []
    for i in range(n_planes):
        normal = base_dirs[i % len(base_dirs)] + rng.normal(size=3) * 0.06
        normal /= np.linalg.norm(normal)
        # the plane faces the camera at its mask cell (positive depth there)
        if normal @ cell_center_ray(i) < 0:
            normal = -normal
        # stratified offsets: planes sharing a direction stay > 1 m apart
        offset = 0.5 + 3.5 * ((i + rng.uniform(0.1, 0.9)) / max(n_planes, 1))
        p0 = normal * offset
        p1 = FLIP * _warp_plane_np(p0, q, t)
        views["0"].append(p0)
        views["1"].append(p1)
        gt_corrs.append([i, i])

    def build_view(idx: str, planes) -> dict:
        annos = []
        depth = np.zeros((h, w), np.float32)
        # each plane's cell coloured by its normal and shaded by inverse depth
        image = np.zeros((h, w, 3), np.float64)
        for i, p in enumerate(planes):
            gx, gy = i % 4, (i // 4) % 3
            x0, y0 = gx * cell_w + 8, gy * cell_h + 8
            x1, y1 = x0 + cell_w - 16, y0 + cell_h - 16
            mask = np.zeros((h, w), np.uint8)
            mask[y0:y1, x0:x1] = 1
            d = _plane_depth(p, rays[:, y0:y1, x0:x1])
            depth[y0:y1, x0:x1] = d
            normal = p / max(np.linalg.norm(p), 1e-8)
            base = (normal * 0.5 + 0.5) * 255.0
            shade = np.clip(1.0 / np.maximum(d, 0.25), 0.0, 1.0)[..., None]
            image[y0:y1, x0:x1] = base[None, None, :] * shade
            annos.append({
                "bbox": [x0, y0, x1, y1],
                "bbox_mode": 0,  # XYXY_ABS
                "category_id": 0,
                "segmentation": {"size": [h, w],
                                 "counts": rle.encode(mask)["counts"].decode("ascii")},
                "plane": [float(v) for v in p],
            })
            if dense_masks:
                annos[-1]["mask"] = mask
        return {
            "file_name": f"/nonexistent/synth_{pair_id}_{idx}.jpg",
            "image_id": f"synth{pair_id}_{idx}",
            "height": h,
            "width": w,
            "annotations": annos,
            "depth": depth,
            "image": image.astype(np.uint8),
        }

    return {
        "0": build_view("0", views["0"]),
        "1": build_view("1", views["1"]),
        "rel_pose": {"position": [float(v) for v in t], "rotation": [float(v) for v in q]},
        "gt_corrs": gt_corrs,
    }
