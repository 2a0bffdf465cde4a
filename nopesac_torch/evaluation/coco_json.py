"""Per-image COCO-format json dump of the siamese pair GT (the port's own
copy of the reference's detectron2coco.py:7-146 + mp3d_evaluation.py:131-167):
the two views of every pair are deduplicated into unique images and
`siamese2coco.json` is written into the output directory once, with the
{info, images, annotations, categories} schema the reference emits.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import tempfile
from typing import Dict, Iterable, List

import numpy as np

from ..utils import rle as rle_util

logger = logging.getLogger(__name__)

# detectron2 BoxMode values used by the cached_set jsons
XYXY_ABS, XYWH_ABS = 0, 1


def _to_xywh(bbox, bbox_mode: int) -> List[float]:
    x0, y0, a, b = [float(v) for v in bbox]
    if bbox_mode == XYXY_ABS:
        return [x0, y0, a - x0, b - y0]
    return [x0, y0, a, b]


def _poly_area(poly: Iterable[float]) -> float:
    xs = np.asarray(poly[0::2], np.float64)
    ys = np.asarray(poly[1::2], np.float64)
    return float(np.abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1))) / 2)


def _seg_area(seg, h: int, w: int) -> float:
    if isinstance(seg, dict):
        counts = seg["counts"]
        rle = {"size": seg["size"],
               "counts": counts.encode("ascii") if isinstance(counts, str) else counts}
        return float(rle_util.area(rle))
    return float(sum(_poly_area(p) for p in seg if len(p) > 4))


def images_to_coco_dict(image_dicts: List[dict], thing_classes: List[str],
                        contiguous_to_dataset_id: Dict[int, int] | None = None) -> dict:
    """Unique per-image dicts -> COCO {info, images, annotations, categories}."""
    remap = contiguous_to_dataset_id or {}
    categories = [
        {"id": remap.get(i, i), "name": name} for i, name in enumerate(thing_classes)
    ]
    images, annotations = [], []
    for image_id, view in enumerate(image_dicts):
        h, w = view["height"], view["width"]
        images.append({
            "id": view.get("image_id", image_id),
            "width": w,
            "height": h,
            "file_name": view.get("file_name", ""),
        })
        for ann in view.get("annotations", []):
            seg = ann.get("segmentation")
            coco_ann = {
                "id": len(annotations) + 1,  # COCO ids start at 1
                "image_id": images[-1]["id"],
                "bbox": [round(v, 3) for v in _to_xywh(ann["bbox"], ann.get("bbox_mode", XYWH_ABS))],
                "area": _seg_area(seg, h, w) if seg is not None else 0.0,
                "iscrowd": ann.get("iscrowd", 0),
                "category_id": remap.get(ann.get("category_id", 0), ann.get("category_id", 0)),
            }
            if seg is not None:
                if isinstance(seg, dict) and isinstance(seg.get("counts"), bytes):
                    seg = {"size": seg["size"], "counts": seg["counts"].decode("ascii")}
                coco_ann["segmentation"] = seg
            if "plane" in ann:
                coco_ann["plane"] = [float(v) for v in ann["plane"]]
            annotations.append(coco_ann)
    return {
        "info": {
            "date_created": str(datetime.datetime.now()),
            "description": "COCO json generated by nopesac_torch (per-image GT of the siamese pairs)",
        },
        "images": images,
        "annotations": annotations,
        "categories": categories,
        "licenses": None,
    }


def write_siamese_coco_json(pair_dicts: List[dict], output_dir: str,
                            thing_classes: List[str],
                            contiguous_to_dataset_id: Dict[int, int] | None = None,
                            filename: str = "siamese2coco.json") -> str:
    """Dedup pair views into unique images and write the COCO json once.

    Concurrency: written via tempfile + atomic rename, and an existing file
    is reused (the reference's file_lock + cache semantics,
    mp3d_evaluation.py:136-143).
    """
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    if os.path.exists(path):
        logger.warning("Using previously cached COCO annotations at %s", path)
        return path

    seen, uniq = set(), []
    for pair in pair_dicts:
        for i in ("0", "1"):
            view = pair[i]
            if view["image_id"] in seen:
                continue
            seen.add(view["image_id"])
            uniq.append(view)
    coco = images_to_coco_dict(uniq, thing_classes, contiguous_to_dataset_id)
    fd, tmp = tempfile.mkstemp(dir=output_dir, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(coco, f)
    os.replace(tmp, path)
    logger.info("Wrote %s (%d images, %d annotations)",
                path, len(coco["images"]), len(coco["annotations"]))
    return path
