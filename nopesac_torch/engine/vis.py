"""Visualisation of the evaluation entry point's artifacts (counterpart of the
root `vis_NopeSAC.py`, with its flags and its files).

    python -m nopesac_torch.engine.vis \
        --rcnn-cached-file OUT/NopeSAC_instances_predictions.pth \
        --optimized-dict-path OUT/continuous.pkl --output-dir vis_out \
        [--num-data 10] [--height H --width W] [--one-plane-cams] \
        [--no-textured] [--dataset-phase synthetic_test]

Per pair <idx> it writes into --output-dir:
  * <idx>_matching.png       both views' masks side by side, matched planes
                             in one colour, joined by lines (PIL);
  * <idx>_affinity_pred.png  the matching's soft affinity, '*' on the
                             selected matches (matplotlib), where the
                             predictions carry `pred_aff`;
  * <idx>_scene.obj          both views' planar meshes under the predicted
                             relative camera, vertex-coloured, with the two
                             camera frustums; <idx>_scene_gt.obj the same
                             under the GT camera;
  * <idx>_scene_textured.obj/.mtl/_tex<k>.png  the textured planar scene
                             (the rectified texture of each plane), where a
                             view's image file is readable;
  * <idx>_scene_gtplanes.obj the GT planes' scene (with --dataset-phase);
  * <idx>_cam_onePP<k>.obj, <idx>_cam_final.obj  the frustum of every
                             one-plane pose hypothesis and of the final pose
                             beside the GT's (with --one-plane-cams).
Everything here is host numpy in float64, as in `vis_NopeSAC.py`.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import datasets  # noqa: F401  (registers the builtin splits)
from ..data.registry import DatasetCatalog
from ..utils import rle as rle_util
from ..utils.mesh import (
    camera_frustum_mesh,
    join_meshes,
    planes_to_meshes,
    planes_to_textured_meshes,
    save_obj,
    save_obj_textured,
    transform_mesh,
)
from ..utils.np_geometry import get_coordinate_map
from ..visualization.vis2d import draw_match, save_affinity_stitched

PRED_RGB = (0.9, 0.2, 0.2)
VIEW1_RGB = (0.2, 0.9, 0.2)
GT_RGB = (0.2, 0.2, 0.9)


def load_predictions(path: str):
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=False)


def _pose(cam: dict):
    return np.asarray(cam["position"]).reshape(3), np.asarray(cam["rotation"]).reshape(4)


def load_image(file_name: str, h: int, w: int):
    """(uint8 [h, w, 3], True) from the file, else (flat grey, False)."""
    if file_name and os.path.exists(file_name):
        from PIL import Image

        return np.asarray(Image.open(file_name).convert("RGB").resize((w, h))), True
    return np.full((h, w, 3), 200, np.uint8), False


def _frustums(cam_pos, cam_rot, extra=()) -> Dict:
    """A camera-only scene: the hypothesis' frustum (red), view 1's at the
    identity (green) and the reference frustums in `extra` (vis_3DPlanes'
    'Cam' renders, reference vis_NopeSAC.py:544-564)."""
    meshes = [camera_frustum_mesh(cam_pos, cam_rot, color=PRED_RGB),
              camera_frustum_mesh([0, 0, 0], [1, 0, 0, 0], color=VIEW1_RGB)]
    for pos, rot, color in extra:
        meshes.append(camera_frustum_mesh(pos, rot, color=color))
    return join_meshes(meshes)


def scene_meshes(pred: dict, od: dict, h: int, w: int, images, gt_pair: Optional[dict] = None,
                 one_plane_cams: bool = False, textured: bool = True) -> Dict[str, object]:
    """The 3D content of one pair's files, keyed by the file's suffix:
    "scene", "scene_gt", "scene_gtplanes", "cam_onePP<k>", "cam_final" a
    joined mesh each, "scene_textured" the list of textured meshes.
    `images` is ((img0, readable0), (img1, readable1))."""
    (img0, real0), (img1, real1) = images
    masks0 = [rle_util.decode(ins["segmentation"]) for ins in pred["0"]["instances"]]
    masks1 = [rle_util.decode(ins["segmentation"]) for ins in pred["1"]["instances"]]
    planes0 = np.asarray(pred["0"]["pred_plane"])
    planes1 = np.asarray(pred["1"]["pred_plane"])
    kmap = get_coordinate_map(h=h, w=w)
    pred_pos, pred_rot = _pose(od["best_camera"])
    gt_pos, gt_rot = _pose(od["gt_camera"])
    out: Dict[str, object] = {}

    # vertex-coloured scenes under the predicted and the GT camera
    view0 = planes_to_meshes(masks0, planes0, kmap, img0, step=4)
    view1 = planes_to_meshes(masks1, planes1, kmap, img1, step=4)
    for tag, (pos, rot) in (("scene", (pred_pos, pred_rot)), ("scene_gt", (gt_pos, gt_rot))):
        meshes = [transform_mesh(m, pos, rot) for m in view0] + view1
        meshes.append(camera_frustum_mesh(pos, rot, color=PRED_RGB))
        meshes.append(camera_frustum_mesh([0, 0, 0], [1, 0, 0, 0], color=VIEW1_RGB))
        out[tag] = join_meshes(meshes)

    # the textured scene (the reference's headline qualitative artifact)
    if textured and (real0 or real1):
        tm0 = planes_to_textured_meshes(masks0, planes0, kmap, img0, step=4)
        tm1 = planes_to_textured_meshes(masks1, planes1, kmap, img1, step=4)
        out["scene_textured"] = [transform_mesh(m, pred_pos, pred_rot) for m in tm0] + tm1

    # the GT planes' scene (vis_3DPlanes' GT renders, reference vis_NopeSAC.py:543-546)
    if gt_pair is not None:
        gt_meshes = []
        for i, img in (("0", img0), ("1", img1)):
            anns = gt_pair[i].get("annotations", [])
            gm = [rle_util.seg_to_mask(a["segmentation"], h, w) for a in anns]
            gp = np.asarray([a["plane"] for a in anns])
            ms = planes_to_meshes(gm, gp, kmap, img, step=4)
            if i == "0":
                ms = [transform_mesh(m, gt_pos, gt_rot) for m in ms]
            gt_meshes += ms
        out["scene_gtplanes"] = join_meshes(gt_meshes)

    # the one-plane pose hypotheses (vis_3DPlanes, reference vis_NopeSAC.py:515-564)
    if one_plane_cams and "camera_onePP" in pred:
        trans = np.asarray(pred["camera_onePP"]["pred"]["tran"]).reshape(-1, 3)
        rots = np.asarray(pred["camera_onePP"]["pred"]["rot"]).reshape(-1, 4)
        extra = [(gt_pos, gt_rot, GT_RGB)]
        for k in range(len(rots)):
            out[f"cam_onePP{k}"] = _frustums(trans[k], rots[k], extra)
        out["cam_final"] = _frustums(pred_pos, pred_rot, extra)
    return out


def vis_pair(idx: int, pred: dict, od: dict, out_dir: str, h: int = 480, w: int = 640,
             gt_pair: Optional[dict] = None, one_plane_cams: bool = False,
             textured: bool = True) -> Dict[str, object]:
    """Write one pair's files into `out_dir` (the module docstring's list) and
    return `scene_meshes`' meshes."""
    from PIL import Image

    images = (load_image(pred["0"].get("file_name", ""), h, w),
              load_image(pred["1"].get("file_name", ""), h, w))
    masks0 = [ins["segmentation"] for ins in pred["0"]["instances"]]
    masks1 = [ins["segmentation"] for ins in pred["1"]["instances"]]
    corrs = np.argwhere(np.asarray(od["best_assignment"]))
    match_img = draw_match(images[0][0], images[1][0], masks0, masks1, corrs)
    Image.fromarray(match_img).save(os.path.join(out_dir, f"{idx}_matching.png"))

    # the per-cell Sinkhorn scores, '*' on the selected matches (reference
    # visualization.py:53-86, save_affinity_after_stitch)
    if pred.get("pred_aff") is not None:
        aff = np.asarray(pred["pred_aff"])
        ass = np.asarray(od["best_assignment"])
        matching = np.full(aff.shape[0], -1, np.int64)
        rows, cols = np.nonzero(ass)
        matching[rows] = cols
        save_affinity_stitched(aff, aff.shape[0], aff.shape[1], matching,
                               os.path.join(out_dir, f"{idx}_affinity_pred.png"))

    meshes = scene_meshes(pred, od, h, w, images, gt_pair, one_plane_cams, textured)
    for tag, mesh in meshes.items():
        if tag == "scene_textured":
            save_obj_textured(out_dir, f"{idx}_{tag}", mesh)
        else:
            save_obj(out_dir, f"{idx}_{tag}", mesh)
    return meshes


def artifact_size(preds: List[dict]):
    """(height, width) of the first RLE mask in the predictions, else 480x640."""
    for p in preds:
        for view in ("0", "1"):
            for inst in p.get(view, {}).get("instances", []):
                seg = inst.get("segmentation")
                if isinstance(seg, dict) and "size" in seg:
                    return int(seg["size"][0]), int(seg["size"][1])
    return 480, 640


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="NopeSAC visualization")
    parser.add_argument("--rcnn-cached-file", required=True)
    parser.add_argument("--optimized-dict-path", required=True)
    parser.add_argument("--output-dir", default="vis_out")
    parser.add_argument("--num-data", type=int, default=10)
    parser.add_argument("--height", type=int, default=0,
                        help="0 = infer from the prediction RLE masks")
    parser.add_argument("--width", type=int, default=0)
    parser.add_argument("--one-plane-cams", action="store_true",
                        help="render every camera_onePP hypothesis frustum")
    parser.add_argument("--no-textured", action="store_true")
    parser.add_argument("--dataset-phase", default="",
                        help="dataset name for GT-plane scenes (optional)")
    args = parser.parse_args(argv)

    preds = load_predictions(args.rcnn_cached_file)
    with open(args.optimized_dict_path, "rb") as f:
        od = pickle.load(f)
    os.makedirs(args.output_dir, exist_ok=True)

    gt_pairs = None
    if args.dataset_phase:
        gt_pairs = {d["0"]["image_id"] + "__" + d["1"]["image_id"]: d
                    for d in DatasetCatalog.get(args.dataset_phase)}

    height, width = args.height, args.width
    if not (height and width):
        height, width = artifact_size(preds)

    n = len(preds) if args.num_data < 0 else min(args.num_data, len(preds))
    for idx in range(n):
        gt_pair = None
        if gt_pairs is not None:
            gt_pair = gt_pairs.get(preds[idx]["0"]["image_id"] + "__" + preds[idx]["1"]["image_id"])
        vis_pair(idx, preds[idx], od[idx], args.output_dir, height, width, gt_pair=gt_pair,
                 one_plane_cams=args.one_plane_cams, textured=not args.no_textured)
        print(f"[{idx + 1}/{n}] wrote visualizations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
