"""Seeded synthetic raw scans in the ScanNet layout that
`tools/generate_scannetv2_data.py` reads (no ScanNet files needed):

    <root>/<scene>/<scene>.txt                      intrinsics, numDepthFrames
    <root>/<scene>/pose/<idx>.txt                   camera-to-world 4x4
    <root>/<scene>/color/<idx>.jpg                  uint8 RGB
    <root>/<scene>/depth/<idx>.png                  uint16 millimetres
    <root>/<scene>/annotation/segmentation/<idx>.png  global plane ids, RGB-coded
    <root>/<scene>/annotation/{planes,plane_info}.npy  plane fits, (id, label)

A scene is a row of near-fronto-parallel planes 2-3.5 m in front of the
cameras. Frame k (index k * frame_step) sees a window of 6-12 consecutive
planes as Voronoi cells; consecutive windows share `shares[k]` planes (3-7
unless given). The cameras alternate 12.5 degrees to either side (yaw) and
0.3 m to either side, so consecutive frames pass the generator's pose-gap
gate (25 degrees, 0.6 m) and frames an even distance apart do not. Each
pixel's depth is its plane's, so the generator's depth-consistency gates
hold; every third plane has a label outside CONFIDENT_LABELS, so
`clean_segmentation` checks its depth and components too.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .generate_scannetv2_data import calc_plane_depths, encode_segmentation_rgb, transform_planes

# ScanNet's depth intrinsics (a typical scene's _info.txt)
FX, FY, CX, CY = 577.590698, 578.729797, 318.905426, 242.683609
WALL, CHAIR = 1, 5  # nyu40 labels: confident, not confident


def _swap(extr: np.ndarray) -> np.ndarray:
    """The generator's world-to-camera axis swap (build_view_record)."""
    e = extr.copy()
    tmp = e[1].copy()
    e[1] = e[2]
    e[2] = -tmp
    return e


def _yaw(deg: float, pitch: float) -> np.ndarray:
    a, b = np.deg2rad(deg), np.deg2rad(pitch)
    ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    return ry @ rx


def _voronoi(rng, n: int, h: int, w: int) -> np.ndarray:
    """[h, w] int labels 0..n-1: the Voronoi cells of n of the 12 jittered
    centres of a 3 x 4 grid."""
    gy, gx = np.meshgrid((np.arange(3) + 0.5) / 3, (np.arange(4) + 0.5) / 4, indexing="ij")
    centres = np.stack([gy.ravel(), gx.ravel()], -1)[rng.permutation(12)[:n]]
    centres = (centres + rng.uniform(-0.08, 0.08, centres.shape)) * [h, w]
    ys, xs = np.mgrid[:h, :w]
    d = (ys[None] - centres[:, 0, None, None]) ** 2 + (xs[None] - centres[:, 1, None, None]) ** 2
    return d.argmin(0).astype(np.int32)


def write_scene(root: str, name: str, n_frames: int, frame_step: int, seed: int,
                shares: Optional[Sequence[int]] = None, size=(480, 640),
                planes=(6, 12)) -> List[List[int]]:
    """Write scene `name` under `root` with `n_frames` frames of `size` at
    indices 0, frame_step, ..., each seeing planes[0]-planes[1] planes;
    returns each frame's global plane ids."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    sp = os.path.join(root, name)
    for d in ("color", "depth", "pose", os.path.join("annotation", "segmentation")):
        os.makedirs(os.path.join(sp, d), exist_ok=True)
    n_views = [int(v) for v in rng.integers(planes[0], planes[1] + 1, n_frames)]
    if shares is None:
        shares = [int(rng.integers(3, min(7, a, b) + 1)) for a, b in zip(n_views, n_views[1:])]
    starts = [0]
    for n, share in zip(n_views, shares):
        starts.append(starts[-1] + n - share)
    windows = [list(range(s, s + n)) for s, n in zip(starts, n_views)]
    n_planes = starts[-1] + n_views[-1]

    # the planes in the frame of the identity camera, then in the world frame
    # the generator's transform_planes and calc_plane_depths undo
    normals = np.concatenate([rng.uniform(-0.15, 0.15, (n_planes, 2)), np.ones((n_planes, 1))], 1)
    planes_cam = normals / np.linalg.norm(normals, axis=1, keepdims=True) \
        * rng.uniform(2.0, 3.5, (n_planes, 1))
    inv_perm = np.stack([planes_cam[:, 0], planes_cam[:, 2], -planes_cam[:, 1]], axis=-1)
    world = transform_planes(np.linalg.inv(_swap(np.eye(4))), inv_perm)
    labels = [CHAIR if g % 3 == 2 else WALL for g in range(n_planes)]
    colors = rng.integers(60, 230, (n_planes, 3))
    camera = np.array([FX, FY, CX, CY])

    with open(os.path.join(sp, name + ".txt"), "w") as f:
        f.write(f"fx_depth = {FX}\nfy_depth = {FY}\nmx_depth = {CX}\nmy_depth = {CY}\n"
                f"depthWidth = {w}\ndepthHeight = {h}\n"
                f"numDepthFrames = {(n_frames - 1) * frame_step + 11}\n")
    for k, ids in enumerate(windows):
        side = 1.0 if k % 2 == 0 else -1.0
        extr_inv = np.eye(4)
        extr_inv[:3, :3] = _yaw(side * 12.5 + rng.normal(0, 1.0), rng.normal(0, 1.0))
        extr_inv[:3, 3] = [side * 0.3 + rng.normal(0, 0.03), rng.normal(0, 0.03),
                           rng.normal(0, 0.03)]
        idx = k * frame_step
        with open(os.path.join(sp, "pose", f"{idx}.txt"), "w") as f:
            for row in extr_inv:
                f.write(" ".join(str(v) for v in row) + "\n")
        pc = transform_planes(_swap(np.linalg.inv(extr_inv)), world[ids])
        cells = _voronoi(rng, len(ids), h, w)
        depth = np.take_along_axis(calc_plane_depths(pc, camera, w, h), cells[None], 0)[0]
        if not ((depth > 0.3) & (depth < 9.0)).all():
            raise ValueError(f"{name} frame {idx}: plane depths outside (0.3, 9) m")
        gids = np.asarray(ids, np.int32)[cells]
        Image.fromarray(encode_segmentation_rgb(gids)).save(
            os.path.join(sp, "annotation", "segmentation", f"{idx}.png"))
        Image.fromarray((depth * 1000).astype(np.uint16)).save(
            os.path.join(sp, "depth", f"{idx}.png"))
        image = colors[gids] + rng.normal(0, 12, (h, w, 3))
        Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(
            os.path.join(sp, "color", f"{idx}.jpg"))
    np.save(os.path.join(sp, "annotation", "planes.npy"), world)
    np.save(os.path.join(sp, "annotation", "plane_info.npy"),
            np.array([[(g, lab)] for g, lab in enumerate(labels)], dtype=object))
    return windows
