"""ScanNetv2 sparse-view pair annotations from raw scans (the port's copy of
the repo's `tools/generate_scannetv2_data.py`, itself after the reference's
`generate_scannetv2_data_final.py`; host numpy, the same float64 arithmetic).

    python -m nopesac_torch.tools.generate_scannetv2_data \
        --scans-dir SCANS --output-dir OUT --split train|test [--split-file SCENES.txt]

From raw ScanNet scans, laid out as
<scans>/<scene>/{<scene>.txt, color, depth, pose, annotation/{planes.npy,
plane_info.npy, segmentation}} (PlaneRCNN-style plane fits, per-frame poses
and intrinsics), it mines sparse-view pairs and writes
OUT/scannet_json/cached_set_<split>V2.json (the split the registry reads as
`scannet_train` / `scannet_test` under DATASETS.ROOT_DIR OUT) and
OUT/twoView_Anns/<scene>/<frame>.pkl (`plane_masks`, `camera_K`: what the
mapper's ScanNet branch reads). The first 1210 scenes (sorted) are train,
the rest test, unless --split-file lists them; train samples every 20
frames and uses each frame in at most one pair, test every 40 and two.

The pure geometry (plane depth rendering, SE(3) plane transforms, the
habitat-frame relative pose, pair mining by pose gap) is importable. PIL,
scipy.ndimage and OpenCV load inside the functions that use them.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import rle as rle_util
from ..utils.np_geometry import rotmat_to_quat

H, W = 480, 640

# ScanNet nyu40 ids whose plane fits are trusted without depth validation -
# the True rows of the reference confidentClasses table (:471-517) mapped
# through scannetv2-labels.combined.tsv: wall(1) floor(2) cabinet(3) bed(4)
# table(7) door(8) window(9) picture(11) counter(12) desk(14) dresser(17)
# floor-mat(20) ceiling(22) refrigerator(24) television(25) box(29)
# whiteboard(30) night-stand(32)
CONFIDENT_LABELS = {1, 2, 3, 4, 7, 8, 9, 11, 12, 14, 17, 20, 22, 24, 25, 29, 30, 32}


# ---------------------------------------------------------------------------
# pure geometry (testable)
# ---------------------------------------------------------------------------

def calc_plane_depths(planes: np.ndarray, camera: np.ndarray,
                      width: int = W, height: int = H,
                      max_depth: float = 10.0) -> np.ndarray:
    """Per-plane depth maps [N, H, W] from plane params (reference :37-62).

    camera: (fx, fy, cx, cy). The reference permutes plane normals
    (x, -z, y) to match the ScanNet plane-fitting frame before projecting.
    """
    fx, fy, cx, cy = camera[:4]
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    k_inv = np.linalg.inv(k)
    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)
    xx, yy = np.meshgrid(xs, ys)
    xy1 = np.stack([xx, yy, np.ones_like(xx)]).reshape(3, -1)
    rays = k_inv @ xy1  # [3, HW]

    planes = np.asarray(planes, np.float64).reshape(-1, 3)
    offsets = np.linalg.norm(planes, axis=-1, keepdims=True)
    normals = planes / (offsets + 1e-10)
    normals = np.stack([normals[:, 0], -normals[:, 2], normals[:, 1]], axis=-1)
    ntr = normals @ rays  # [N, HW]
    ntr = np.where(ntr == 0, 1e-4, ntr)
    depths = offsets / ntr
    if max_depth > 0:
        depths = np.clip(depths, 0, max_depth)
    return depths.reshape(-1, height, width)


def transform_planes(transformation: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """n*d plane params through a 4x4 transform (reference :125-142):
    move the closest point and a reference point, re-derive normal/offset."""
    planes = np.asarray(planes, np.float64).reshape(-1, 3)
    offsets = np.linalg.norm(planes, axis=-1, keepdims=True)
    centers_h = np.concatenate([planes, np.ones((len(planes), 1))], axis=-1)
    new_centers = (transformation @ centers_h.T).T
    new_centers = new_centers[:, :3] / new_centers[:, 3:4]

    ref = planes - planes / np.maximum(offsets, 1e-4)
    ref_h = np.concatenate([ref, np.ones((len(planes), 1))], axis=-1)
    new_ref = (transformation @ ref_h.T).T
    new_ref = new_ref[:, :3] / new_ref[:, 3:4]

    normals = new_ref - new_centers
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    new_offsets = np.sum(new_centers * normals, axis=-1, keepdims=True)
    return normals * new_offsets


def relative_pose_habitat(extr_inv0: np.ndarray, extr_inv1: np.ndarray):
    """Two camera-to-world matrices -> (position, quaternion) of the relative
    pose in the habitat axis convention (reference :253-279: conjugate the
    relative rotation by diag(1,-1,-1))."""
    t_rel = np.linalg.inv(extr_inv1) @ extr_inv0
    r = t_rel[:3, :3]
    t = t_rel[:3, 3:4]
    ma = np.diag([1.0, -1.0, -1.0])
    r_h = ma @ r @ np.linalg.inv(ma)
    t_h = (ma @ t).reshape(-1)
    q = rotmat_to_quat(r_h)
    if q[0] < 0:
        q = -q
    return t_h.tolist(), q.tolist()


def view_overlap_ratio(depth0: np.ndarray, extr_inv0: np.ndarray,
                       extr_inv1: np.ndarray, camera: np.ndarray,
                       stride: int = 8) -> float:
    """Fraction of view-0's valid depth pixels that reproject inside view-1
    (the pair-mining criterion, reference :224-420)."""
    fx, fy, cx, cy = camera[:4]
    h, w = depth0.shape
    ys, xs = np.nonzero(depth0[::stride, ::stride] > 1e-4)
    if len(ys) == 0:
        return 0.0
    ys = ys * stride
    xs = xs * stride
    z = depth0[ys, xs]
    pts_cam0 = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=-1)
    pts_h = np.concatenate([pts_cam0, np.ones((len(z), 1))], axis=-1)
    world = (extr_inv0 @ pts_h.T).T
    cam1 = (np.linalg.inv(extr_inv1) @ world.T).T[:, :3]
    in_front = cam1[:, 2] > 1e-4
    u = cam1[:, 0] / np.maximum(cam1[:, 2], 1e-6) * fx + cx
    v = cam1[:, 1] / np.maximum(cam1[:, 2], 1e-6) * fy + cy
    visible = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return float(visible.mean())


def clean_segmentation(image: np.ndarray, planes: np.ndarray, plane_labels,
                       segmentation: np.ndarray, depth: np.ndarray,
                       camera: np.ndarray, plane_area_threshold: int = 200,
                       plane_width_threshold: float = 10.0,
                       depth_diff_threshold: float = 0.1,
                       valid_area_threshold: float = 0.5,
                       bright_threshold: float = 20.0) -> np.ndarray:
    """Drop unreliable plane segments (reference cleanSegmentation :64-123):
    keep confident-class segments by area; otherwise require depth-consistent
    pixels, minimum area, and minimum width (per connected component)."""
    from scipy import ndimage

    plane_depths = calc_plane_depths(planes, camera, segmentation.shape[1],
                                     segmentation.shape[0])
    new_seg = -np.ones_like(segmentation)
    valid_mask = (np.linalg.norm(image.astype(np.float64), axis=-1) > bright_threshold) \
        & (depth > 1e-4)
    for seg_idx in np.unique(segmentation):
        if seg_idx < 0:
            continue
        seg_mask = segmentation == seg_idx
        label = plane_labels[seg_idx] if seg_idx < len(plane_labels) else -1
        if label in CONFIDENT_LABELS:
            if seg_mask.sum() > plane_area_threshold:
                new_seg[seg_mask] = seg_idx
            continue
        depth_ok = (np.abs(plane_depths[seg_idx] - depth) < depth_diff_threshold) \
            | (depth < 1e-4)
        ori_area = seg_mask.sum()
        seg_mask = seg_mask & depth_ok
        if (seg_mask & valid_mask).sum() < ori_area * valid_area_threshold:
            continue
        dilated = ndimage.binary_dilation(seg_mask, np.ones((3, 3), bool))
        components, n_comp = ndimage.label(dilated)
        for comp in range(1, n_comp + 1):
            mask = components == comp
            ys, xs = np.nonzero(mask)
            area = float(len(xs))
            if area < plane_area_threshold * 2.0:
                continue
            length = np.hypot(xs.max() - xs.min() + 1, ys.max() - ys.min() + 1)
            if area / length < plane_width_threshold:
                continue
            new_seg[mask] = seg_idx
    return new_seg


# ---------------------------------------------------------------------------
# record assembly (reference :528-936)
# ---------------------------------------------------------------------------

def decode_segmentation_rgb(rgb: np.ndarray) -> np.ndarray:
    """PlaneRCNN-style seg png (RGB) -> plane index map, -1 = non-plane
    (reference :631-634: (r*65536 + g*256 + b) // 100 - 1)."""
    rgb = rgb.astype(np.int64)
    seg = (rgb[:, :, 0] * 256 * 256 + rgb[:, :, 1] * 256 + rgb[:, :, 2]) // 100 - 1
    seg[seg == 167771] = -1
    return seg.astype(np.int32)


def encode_segmentation_rgb(seg: np.ndarray) -> np.ndarray:
    """Inverse of decode_segmentation_rgb (for synthetic test fixtures)."""
    v = (seg.astype(np.int64) + 1) * 100
    rgb = np.stack([v // 65536, (v // 256) % 256, v % 256], axis=-1)
    return rgb.astype(np.uint8)


def load_scene_info(scene_path: str) -> Optional[dict]:
    """Scene intrinsics + PlaneRCNN global plane fits (reference
    get_scene_info :428-470). Expects <scene>/<scene>.txt with fx_depth/...
    keys and annotation/{planes,plane_info}.npy."""
    scene_name = os.path.basename(os.path.normpath(scene_path))
    meta_path = os.path.join(scene_path, scene_name + ".txt")
    if not os.path.exists(meta_path):
        return None
    vals: Dict[str, float] = {}
    with open(meta_path) as f:
        for line in f:
            toks = [t for t in line.strip().split(" ") if t.strip()]
            if len(toks) >= 3 and toks[1] == "=":
                try:
                    vals[toks[0]] = float(toks[2])
                except ValueError:
                    pass
    planes = np.load(os.path.join(scene_path, "annotation", "planes.npy"),
                     allow_pickle=True)
    info = np.load(os.path.join(scene_path, "annotation", "plane_info.npy"),
                   allow_pickle=True)
    fx, fy = vals.get("fx_depth", 577.0), vals.get("fy_depth", 577.0)
    cx, cy = vals.get("mx_depth", W / 2), vals.get("my_depth", H / 2)
    return {
        "scene_name": scene_name,
        "camera_vec": np.array([fx, fy, cx, cy,
                                vals.get("depthWidth", W), vals.get("depthHeight", H)]),
        "camera_K": np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]),
        "num_images": int(vals.get("numDepthFrames", 0)) - 10,
        "global_planes": np.asarray(planes, np.float64).reshape(-1, 3),
        "plane_info": list(info),
    }


def build_view_record(scene_path: str, img_idx: int, scene: dict,
                      plane_area_threshold: int = 800) -> Optional[dict]:
    """Per-view half of the pair record (reference :616-736): decode the
    plane segmentation, filter segments, transform the scene-frame plane
    fits into the camera frame, clean the segmentation against measured
    depth, and gate on coverage/plane-count/depth-consistency."""
    from PIL import Image

    pose_path = os.path.join(scene_path, "pose", f"{img_idx}.txt")
    extr_inv = read_pose(pose_path)  # camera-to-world
    if extr_inv is None or not np.all(np.isfinite(extr_inv)):
        return None
    extrinsics = np.linalg.inv(extr_inv)

    seg_path = os.path.join(scene_path, "annotation", "segmentation", f"{img_idx}.png")
    img_path = os.path.join(scene_path, "color", f"{img_idx}.jpg")
    depth_path = os.path.join(scene_path, "depth", f"{img_idx}.png")
    if not (os.path.exists(seg_path) and os.path.exists(depth_path)):
        return None
    seg = decode_segmentation_rgb(np.asarray(Image.open(seg_path).convert("RGB")))
    depth = np.asarray(Image.open(depth_path), np.float32) / 1000.0
    if os.path.exists(img_path):
        image = np.asarray(
            Image.open(img_path).convert("RGB").resize(depth.shape[::-1]), np.float64)
    else:
        image = np.full(depth.shape + (3,), 255.0)

    global_planes = scene["global_planes"]
    # segment filter pass 1 (reference :634-672): by area desc, valid fits
    segments, counts = np.unique(seg, return_counts=True)
    seg_list = sorted(
        [(s, c) for s, c in zip(segments.tolist(), counts.tolist()) if s >= 0],
        key=lambda x: -x[1])
    new_seg = np.full(seg.shape, -1, np.int32)
    new_planes, new_labels, new_gidx = [], [], []
    for ori_idx, count in seg_list:
        if count < plane_area_threshold or ori_idx >= len(global_planes):
            continue
        if np.linalg.norm(global_planes[ori_idx]) < 1e-4:
            continue
        new_seg[seg == ori_idx] = len(new_planes)
        new_planes.append(global_planes[ori_idx])
        pinfo = scene["plane_info"][ori_idx]
        try:  # PlaneRCNN layout: plane_info[i][0] = (instance_id, label)
            label = int(pinfo[0][1])
        except (TypeError, IndexError, ValueError):
            label = -1
        new_labels.append(label)
        new_gidx.append(ori_idx)
    n = len(new_planes)
    h, w = new_seg.shape
    if n < 2 or n > 22 or (new_seg > -1).sum() / (h * w) < 0.7:
        return None

    # world -> camera with the ScanNet axis swap (reference :678-683)
    extr = extrinsics.copy()
    tmp = extr[1].copy()
    extr[1] = extr[2]
    extr[2] = -tmp
    planes_cam = transform_planes(extr, np.asarray(new_planes))

    # depth-based cleanup (reference cleanSegmentation call :685-691)
    seg_clean = clean_segmentation(
        image, planes_cam, new_labels, new_seg, depth, scene["camera_vec"],
        plane_area_threshold=plane_area_threshold, plane_width_threshold=30.0)
    kept = [s for s in np.unique(seg_clean) if s >= 0]
    if len(kept) < 2:
        return None

    # plane-depth consistency gate (reference :697-711)
    plane_depths = calc_plane_depths(planes_cam, scene["camera_vec"], w, h)
    masks = seg_clean[None] == np.arange(n)[:, None, None]
    plane_depth = (plane_depths * masks).sum(0)
    plane_mask = masks.any(0) & (depth > 1e-4)
    area = plane_mask.sum()
    err = (np.abs(plane_depth - depth) * plane_mask).sum() / max(area, 1)
    if err > 0.1 or (seg_clean > -1).sum() / (h * w) < 0.7:
        return None

    # final re-index (reference :721-734)
    final_seg = np.full(seg_clean.shape, -1, np.int32)
    final_planes, final_gidx = [], []
    for s in kept:
        if (seg_clean == s).sum() < plane_area_threshold:
            continue
        final_seg[seg_clean == s] = len(final_planes)
        final_planes.append(planes_cam[s])
        final_gidx.append(new_gidx[s])
    if len(final_planes) < 2:
        return None
    return {
        "img_idx": img_idx,
        "file_name": img_path,
        "extrinsics": extrinsics,
        "extr_inv": extr_inv,
        "planes_cam": np.asarray(final_planes),
        "seg": final_seg,
        "global_idx": final_gidx,
    }


def _polygons_from_mask(mask: np.ndarray):
    """Polygon contours (reference polygonFromMask :183-196); None if cv2
    is unavailable or the mask has no valid contour - callers fall back to
    RLE, which the data mapper consumes equally (utils/rle.seg_to_mask)."""
    try:
        import cv2
    except ImportError:
        return None
    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polys = [c.astype(float).flatten().tolist() for c in contours if c.size >= 6]
    return polys or None


def build_pair_record(view0: dict, view1: dict, scene: dict,
                      anns_dir: Optional[str] = None) -> Optional[dict]:
    """Two view records -> one cached_set pair entry + twoView_Anns pickles
    (reference :737-882). Returns None when the correspondence-count or
    overlap gates reject the pair."""
    # GT correspondences: shared scene-level plane ids (reference :739-752)
    gt_corrs = [[i, j]
                for i, g0 in enumerate(view0["global_idx"])
                for j, g1 in enumerate(view1["global_idx"]) if g0 == g1]
    n0, n1 = len(view0["global_idx"]), len(view1["global_idx"])
    if min(n0, n1) > 10 and len(gt_corrs) / min(n0, n1) > 0.7:
        return None  # too-easy pair (reference :753-754)
    if len(gt_corrs) < 3 or len(gt_corrs) > 7:
        return None

    position, rotation = relative_pose_habitat(view0["extr_inv"], view1["extr_inv"])
    rel_pose = {"position": position, "rotation": rotation}

    samples = []
    for view in (view0, view1):
        planes_cam = view["planes_cam"]
        # annotation plane frame: (x, -z, y) permute (reference :801)
        planes_anno = np.stack(
            [planes_cam[:, 0], -planes_cam[:, 2], planes_cam[:, 1]], axis=-1)
        seg = view["seg"]
        annotations = []
        masks = []
        for pi in range(len(planes_anno)):
            m = (seg == pi).astype(np.uint8)
            masks.append(m)
            r = rle_util.encode(np.asarray(m, order="F") > 0)
            bbox = rle_util.to_bbox(r).tolist()
            polys = _polygons_from_mask(m)
            segmentation = polys if polys is not None else {
                "size": list(r["size"]), "counts": r["counts"].decode("ascii")
                if isinstance(r["counts"], bytes) else r["counts"]}
            annotations.append({
                "id": pi,
                "image_id": "",
                "category_id": 0,
                "area": float(m.sum()),
                "segmentation": segmentation,
                "width": seg.shape[1],
                "height": seg.shape[0],
                "plane": planes_anno[pi].tolist(),
                "iscrowd": 0,
                "bbox": bbox,
                "bbox_mode": 1,
            })
        img_id = f"{view['img_idx']}"
        samples.append({
            "image_id": scene["scene_name"] + "-" + img_id,
            "file_name": view["file_name"],
            "height": seg.shape[0],
            "width": seg.shape[1],
            "annotations": annotations,
            "gt_plane_num": len(planes_anno),
        })
        if anns_dir is not None:
            scene_dir = os.path.join(anns_dir, scene["scene_name"])
            os.makedirs(scene_dir, exist_ok=True)
            with open(os.path.join(scene_dir, img_id + ".pkl"), "wb") as f:
                pickle.dump({"plane_masks": masks,
                             "camera_K": scene["camera_K"]}, f)

    return {"0": samples[0], "1": samples[1],
            "rel_pose": rel_pose, "gt_corrs": gt_corrs}


def candidate_pairs_by_pose_gap(scene_path: str, num_images: int,
                                sample_step: int) -> List[Tuple[int, int]]:
    """Reference pair mining (:204-306): sample every sample_step frames and
    keep pairs whose pose gap satisfies (rot>15deg & t>0.2m) | (rot>10deg &
    t>0.5m)."""
    frames = []
    for idx in range(0, max(num_images, 0), sample_step):
        extr_inv = read_pose(os.path.join(scene_path, "pose", f"{idx}.txt"))
        if extr_inv is None or not np.all(np.isfinite(extr_inv)):
            continue
        # reference :263: T_rel = poses[1] @ poses_inv[0] with poses[1]=I,
        # i.e. the CAM-TO-WORLD pose - the translation gap below is then the
        # physical camera baseline |C0 - C1| (world-to-cam would give
        # |R0 C0 - R1 C1|, faking a gap for pure rotations far from origin)
        pos, quat = relative_pose_habitat(extr_inv, np.eye(4))
        frames.append((idx, np.asarray(pos), np.asarray(quat)))
    pairs = []
    # BOTH orders: the reference enumerates torch.nonzero(mask) over the
    # full matrix, so (a,b) and (b,a) are distinct candidates (the per-frame
    # hit cap in generate_scene_pairs then decides how many survive)
    for a in range(len(frames)):
        for b_i in range(len(frames)):
            if a == b_i:
                continue
            i0, t0, q0 = frames[a]
            i1, t1, q1 = frames[b_i]
            dt = float(np.linalg.norm(t0 - t1))
            dr = 2 * np.degrees(np.arccos(np.clip(abs(float(q0 @ q1)), -1.0, 1.0)))
            if (dr > 15 and dt > 0.2) or (dr > 10 and dt > 0.5):
                pairs.append((i0, i1))
    return pairs


def generate_scene_pairs(scene_path: str, sample_step: int = 20,
                         max_per_scene: int = 40, max_hit_num: int = 1,
                         anns_dir: Optional[str] = None) -> List[dict]:
    """Full per-scene pipeline: mine candidates, assemble + gate records
    (reference main loop :575-882, incl. per-frame hit caps)."""
    scene = load_scene_info(scene_path)
    if scene is None:
        return []
    cand = candidate_pairs_by_pose_gap(scene_path, scene["num_images"], sample_step)
    hits: Dict[int, int] = {}
    view_cache: Dict[int, Optional[dict]] = {}
    records = []
    for i0, i1 in cand:
        if len(records) >= max_per_scene:
            break
        if hits.get(i0, 0) >= max_hit_num or hits.get(i1, 0) >= max_hit_num:
            continue
        views = []
        for idx in (i0, i1):
            if idx not in view_cache:
                view_cache[idx] = build_view_record(scene_path, idx, scene)
            if view_cache[idx] is None:
                hits[idx] = hits.get(idx, 0) + 100
            views.append(view_cache[idx])
        if views[0] is None or views[1] is None:
            continue
        rec = build_pair_record(views[0], views[1], scene, anns_dir=anns_dir)
        if rec is None:
            continue
        records.append(rec)
        hits[i0] = hits.get(i0, 0) + 1
        hits[i1] = hits.get(i1, 0) + 1
    return records


# ---------------------------------------------------------------------------
# pipeline (requires raw ScanNet data)
# ---------------------------------------------------------------------------

def read_pose(path: str) -> Optional[np.ndarray]:
    vals: List[float] = []
    with open(path) as f:
        for line in f:
            vals += [float(v) for v in line.split()]
    if len(vals) != 16:
        return None
    return np.asarray(vals).reshape(4, 4)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="ScanNetv2 pair generator")
    parser.add_argument("--scans-dir", required=True)
    parser.add_argument("--output-dir", required=True,
                        help="writes scannet_json/cached_set_<split>V2.json + twoView_Anns/")
    parser.add_argument("--split", default="train", choices=["train", "test"])
    parser.add_argument("--split-file", default="", help="scene list, one per line")
    args = parser.parse_args(argv)

    # reference split policy (:519-545): first 1210 scenes train, rest test;
    # train samples every 20 frames with 1 use per frame, test every 40 / 2
    if args.split_file:
        with open(args.split_file) as f:
            scenes = [s.strip() for s in f if s.strip()]
    else:
        all_scenes = sorted(os.listdir(args.scans_dir))
        scenes = all_scenes[:1210] if args.split == "train" else all_scenes[1210:]
    sample_step = 20 if args.split == "train" else 40
    max_hit_num = 1 if args.split == "train" else 2

    anns_dir = os.path.join(args.output_dir, "twoView_Anns")
    data: List[dict] = []
    trans_errs, rot_errs = [], []
    for scene in scenes:
        scene_path = os.path.join(args.scans_dir, scene)
        if not os.path.isdir(scene_path):
            continue
        try:
            records = generate_scene_pairs(
                scene_path, sample_step=sample_step, max_hit_num=max_hit_num,
                anns_dir=anns_dir)
        except (OSError, ValueError) as e:
            print(f"skip {scene}: {e}")
            continue
        for rec in records:
            trans_errs.append(float(np.linalg.norm(rec["rel_pose"]["position"])))
            rot_errs.append(2 * np.degrees(np.arccos(
                np.clip(abs(rec["rel_pose"]["rotation"][0]), -1.0, 1.0))))
        data.extend(records)
        print(f"{scene}: {len(records)} pairs (total {len(data)})")

    if trans_errs:
        te, re_ = np.asarray(trans_errs), np.asarray(rot_errs)
        print(f"Mean Error [tran, rot]: {te.mean():.2f}, {re_.mean():.2f}")
        print(f"Median Error [tran, rot]: {np.median(te):.2f}, {np.median(re_):.2f}")
        for tt, rr in ((1.0, 30), (0.5, 15), (0.2, 10), (0.1, 5)):
            print(f"Accuracy [tran({tt}m), rot({rr}')]: "
                  f"{(te < tt).mean() * 100:.1f}, {(re_ < rr).mean() * 100:.1f}")

    json_dir = os.path.join(args.output_dir, "scannet_json")
    os.makedirs(json_dir, exist_ok=True)
    # the registry's name (data/datasets.py:SPLITS); the repo's
    # tools/generate_scannetv2_data.py:554-556 writes cached_set_<split>.json
    out = os.path.join(json_dir, f"cached_set_{args.split}V2.json")
    with open(out, "w") as f:
        json.dump({"categories": [{"id": 0, "name": "plane"}], "data": data}, f)
    print(f"wrote {len(data)} pairs -> {out}")


if __name__ == "__main__":
    main()
