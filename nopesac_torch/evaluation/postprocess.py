"""Host-side postprocess: the eval step's fixed-shape outputs, fetched as
numpy -> reference-format prediction dicts (the port's own copy of the
reference postprocess, siamese_planeTR.py:625-803 + :384-450).

The device half (`PlaneTRNopeSAC.select_planes` / `inference`) produces
padded arrays with validity masks; this module compacts them and assembles
the per-pair result dicts: instances with COCO RLE segmentation, pred_plane,
the camera dict zoo and assignment matrices over compacted plane indices.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils import rle as rle_util


def _compact_view(view_out: Dict, b: int, image_id: str, file_name: str,
                  height: int, width: int) -> Dict:
    valid = np.asarray(view_out["valid"][b])
    keep = np.nonzero(valid)[0]  # ascending original query order
    scores = np.asarray(view_out["score"][b])[keep]
    params = np.asarray(view_out["params"][b])[keep]
    centers = np.asarray(view_out["centers"][b])[keep]

    # per-query RLE straight from the gated argmax label map, in one pass
    # without [K, H, W] masks: mask_q == (seg_gated == q). The eval step
    # emits the gated int8 map; dicts with separate seg_ids + gate work too.
    if "seg_gated" in view_out:
        seg_gated = np.asarray(view_out["seg_gated"][b])
    else:
        seg_gated = np.where(np.asarray(view_out["gate"][b]),
                             np.asarray(view_out["seg_ids"][b]), -1)
    rles = rle_util.encode_label_map(seg_gated, keep)

    total = height * width
    instances = []
    for k in range(len(keep)):
        r = rles[k]
        runs = r["_runs"]
        if len(runs) == 1:
            # zero-detection fallback keeps a degenerate mask alive
            # (siamese_planeTR.py:699-702): single on-pixel at (0, 0)
            runs = np.asarray([0, 1, total - 1], np.int64)
            r = {"size": r["size"],
                 "counts": rle_util.counts_to_string(runs), "_runs": runs}
            rles[k] = r
        bbox = rle_util.to_bbox({"size": r["size"], "counts": runs}).tolist()
        instances.append({
            "image_id": image_id,
            "file_name": file_name,
            "category_id": 0,
            "score": float(scores[k]),
            "segmentation": {"size": [height, width], "counts": r["counts"]},
            "bbox": bbox,
            "bbox_mode": 1,  # XYWH_ABS
        })

    return {
        "image_id": image_id,
        "file_name": file_name,
        "instances": instances,
        "pred_plane": params,  # [n, 3] numpy
        "pred_plane_oriIdxs": keep.tolist(),
        "pred_plane_ins_center": centers,
        "_keep": keep,
    }


def postprocess_batch(infer_out: Dict, metas: List[dict], height: int = 480,
                      width: int = 640) -> List[Dict]:
    """Convert one batched inference output into per-pair result dicts."""
    results = []
    bsz = len(metas)
    for b in range(bsz):
        meta = metas[b]
        res: Dict = {}
        v0 = _compact_view(infer_out["view0"], b, meta["image_id0"],
                           meta.get("file_name0", ""), height, width)
        v1 = _compact_view(infer_out["view1"], b, meta["image_id1"],
                           meta.get("file_name1", ""), height, width)
        keep0, keep1 = v0.pop("_keep"), v1.pop("_keep")
        res["0"] = v0
        res["1"] = v1
        res["depth"] = {
            "0": None if "depth0" not in infer_out or infer_out["depth0"] is None
            else np.asarray(infer_out["depth0"][b])[..., 0],
            "1": None if "depth1" not in infer_out or infer_out["depth1"] is None
            else np.asarray(infer_out["depth1"][b])[..., 0],
        }
        # soft matching affinity over the kept planes (exp of the Sinkhorn
        # log-OT scores, dustbin dropped), for the stitched-affinity figure
        res["pred_aff"] = None
        if "log_scores" in infer_out:
            aff = np.exp(np.asarray(infer_out["log_scores"][b], np.float64))
            res["pred_aff"] = aff[np.ix_(keep0, keep1)].astype(np.float32)

        if "cameras" in infer_out:
            for key, cam in infer_out["cameras"].items():
                res[key] = {
                    "tran": np.asarray(cam["tran"][b]),
                    "rot": np.asarray(cam["rot"][b]),
                }
        if "camera_onePP" in infer_out:
            hv = np.asarray(infer_out["camera_onePP"]["hyp_valid"][b])
            nh = int(hv.sum())
            res["camera_onePP"] = {
                "tran": np.asarray(infer_out["camera_onePP"]["tran"][b])[:nh],
                "rot": np.asarray(infer_out["camera_onePP"]["rot"][b])[:nh],
            }

        # assignment matrices over compacted plane indices
        for key_in, key_out in (("assignment_beforeRef", "pred_assignment_beforeRef0"),
                                ("assignment", "pred_assignment")):
            if key_in in infer_out:
                a = np.asarray(infer_out[key_in][b])
                res[key_out] = a[np.ix_(keep0, keep1)]
        if "pred_assignment" in res:
            res["pred_assignment_afterRef0"] = res["pred_assignment"].copy()
        results.append(res)
    return results
