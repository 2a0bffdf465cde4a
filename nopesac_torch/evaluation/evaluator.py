"""Online evaluator for sparse-view plane pairs (MP3D / ScanNet): the port's
own copy of the reference's evaluation/mp3d_evaluation.py (MP3DEvaluator),
host-side numpy with the port's RLE codec. It keeps
  * the process()/evaluate() protocol,
  * the `NopeSAC_instances_predictions.pth` (torch.save) and `continuous.pkl`
    artifacts that eval.py reads (mp3d_evaluation.py:331-342),
  * the metric names and thresholds (camera acc@{1.0,0.5,0.2}m/{30,15,10}deg,
    mask AP, plane AP variants, matching precision/recall/F).
With `distributed=True` each rank processes its own slice of the pairs and
`evaluate()` gathers the predictions to rank 0 in rank-major order (rank 0's
pairs, then rank 1's, ...). Rank 0 writes the artifacts and computes the
metrics against the GT of `dataset_list`, which is the whole split on every
rank; one more gather shares its result dict, or its error, with every rank.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.metrics import compare_planes, compute_ap, rotation_angle_error_deg
from ..data.registry import DatasetCatalog, MetadataCatalog
from ..parallel.host_gather import all_gather_objects, is_main_process
from ..utils import rle as rle_util
from ..utils import trace
from .coco_json import write_siamese_coco_json

logger = logging.getLogger(__name__)


def _gt_rle(ann: dict, height: int, width: int):
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return {"size": seg["size"], "counts": seg["counts"]}
    mask = rle_util.poly_to_mask(seg, height, width)
    return rle_util.encode(mask)


class _MaskIous:
    """The mask IoU matrices of one `evaluate()` call, which the plane AP and
    the matching passes both read, and the GT RLEs they come from. Keyed on
    the identity of the prediction view and the GT view, never on an image
    id: two pairs may share an image id and hold different predictions. The
    views outlive the memo, so their ids stay theirs while it lives."""

    def __init__(self):
        self._gt: Dict[int, list] = {}
        self._iou: Dict[tuple, np.ndarray] = {}

    def gt_rles(self, view: dict) -> list:
        """The view's GT masks as RLEs, a polygon rasterised once."""
        rles = self._gt.get(id(view))
        if rles is None:
            h, w = view.get("height", 480), view.get("width", 640)
            rles = self._gt[id(view)] = [_gt_rle(a, h, w) for a in view.get("annotations", [])]
        return rles

    def iou(self, pred_view: dict, gt_view: dict) -> np.ndarray:
        """[predictions, GT planes] mask IoU of a prediction view against a GT
        view (both non-empty)."""
        key = (id(pred_view), id(gt_view))
        miou = self._iou.get(key)
        if miou is not None:
            trace.count("eval.iou_reused")
            return miou
        gt_rles = self.gt_rles(gt_view)
        pred_rles = [ins["segmentation"] for ins in pred_view["instances"]]
        miou = self._iou[key] = rle_util.iou(pred_rles, gt_rles, [0] * len(gt_rles))
        trace.count("eval.iou_matrices")
        return miou


class MP3DEvaluator:
    def __init__(self, dataset_name: str, cfg, distributed: bool = False,
                 output_dir: Optional[str] = None, dataset_list: Optional[List[dict]] = None):
        self.cfg = cfg
        self._distributed = distributed
        self.dataset_name = dataset_name
        self._output_dir = output_dir or cfg.OUTPUT_DIR
        self.eval_full_scene = cfg.TEST.EVAL_FULL_SCENE

        self._tasks = ("segm",) if cfg.MODEL.MASK_ON else ()
        self._plane_tasks = ()
        if cfg.MODEL.EMBEDDING_ON and cfg.MODEL.MASK_ON:
            self._plane_tasks += ("embedding",)
        if cfg.MODEL.CAMERA_ON:
            self._plane_tasks += ("camera",)

        if dataset_list is None:
            dataset_list = DatasetCatalog.get(dataset_name)
        self.dataset_dict = {
            d["0"]["image_id"] + "__" + d["1"]["image_id"]: d for d in dataset_list
        }
        # unique per-image GT (the _siamese_to_coco dedup, mp3d_evaluation.py:131-167)
        self.image_gt: "OrderedDict[str, dict]" = OrderedDict()
        for d in dataset_list:
            for i in ("0", "1"):
                v = d[i]
                if v["image_id"] not in self.image_gt:
                    self.image_gt[v["image_id"]] = v
        self._predictions: List[dict] = []

        os.makedirs(self._output_dir, exist_ok=True)
        self.metrics_log = os.path.join(self._output_dir, "metrics.txt")

    def _log(self, msg: str):
        logger.info(msg)
        with open(self.metrics_log, "a") as f:
            f.write(msg + "\n")

    def reset(self):
        self._predictions = []

    # ------------------------------------------------------------------
    def process(self, inputs: List[dict], outputs: List[dict]):
        """inputs: dataset pair dicts; outputs: postprocess_batch results."""
        for inp, out in zip(inputs, outputs):
            prediction: Dict = {"0": {}, "1": {}}
            for i in ("0", "1"):
                prediction[i]["image_id"] = inp[i]["image_id"]
                prediction[i]["file_name"] = inp[i].get("file_name", "")
                if out.get(i) is not None and "instances" in out[i]:
                    prediction[i]["instances"] = out[i]["instances"]
                    prediction[i]["pred_plane"] = out[i]["pred_plane"]
                d = out.get("depth", {}).get(i) if isinstance(out.get("depth"), dict) else None
                if d is not None and "depth" in inp[i]:
                    gt_d = np.asarray(inp[i]["depth"], np.float64)
                    mask = (gt_d > 1e-4).astype(np.float64)
                    err = np.abs(np.asarray(d, np.float64) - gt_d) * mask
                    prediction[i]["pred_depth"] = d
                    prediction[i]["depth_l1_dist"] = err.sum() / max(mask.sum(), 1)

            if "camera" in self._plane_tasks and "rel_pose" in inp:
                gt_cam = {
                    "tran": inp["rel_pose"]["position"],
                    "rot": inp["rel_pose"]["rotation"],
                    "tran_cls": inp["rel_pose"].get("tran_cls"),
                    "rot_cls": inp["rel_pose"].get("rot_cls"),
                }
                for key in out:
                    if "camera" in key and "cls" not in key:
                        prediction[key] = {"pred": out[key], "gts": gt_cam}
            if "embedding" in self._plane_tasks:
                for key in out:
                    if "assignment" in key:
                        prediction[key] = np.asarray(out[key])
                if out.get("pred_aff") is not None:
                    # soft affinity for the vis CLI's stitched figure
                    # (reference stores it when present, mp3d_evaluation.py:254)
                    prediction["pred_aff"] = np.asarray(out["pred_aff"])
            self._predictions.append(prediction)

    # ------------------------------------------------------------------
    def get_optimized_dict(self, predictions) -> dict:
        """The continuous.pkl contract (mp3d_evaluation.py:259-313)."""
        if predictions and ("pred_assignment" not in predictions[0]
                            or "camera" not in predictions[0]):
            raise RuntimeError(
                "TEST.EVAL_FULL_SCENE requires matching + camera predictions "
                "(MODEL.EMBEDDING_ON / MODEL.CAMERA_ON are off in this config)")
        out = {}
        for idx, p in enumerate(predictions):
            best_assignment = np.asarray(p["pred_assignment"])
            cam = p["camera"]
            out[idx] = {
                "n_corr": best_assignment.sum(),
                "cost": 0.1,
                "best_camera": {
                    "position": np.asarray(cam["pred"]["tran"]),
                    "rotation": np.asarray(cam["pred"]["rot"]),
                },
                "gt_camera": {
                    "position": np.asarray(cam["gts"]["tran"]),
                    "rotation": np.asarray(cam["gts"]["rot"]),
                },
                "best_assignment": best_assignment,
                "plane_param_override": {
                    "0": np.asarray(p["0"]["pred_plane"]),
                    "1": np.asarray(p["1"]["pred_plane"]),
                },
                "image_ids": {
                    "0": p["0"]["image_id"],
                    "1": p["1"]["image_id"],
                },
            }
        return out

    def evaluate(self) -> "OrderedDict":
        """Write the artifacts (TEST.EVAL_FULL_SCENE) and compute the metrics
        over every prediction processed, on every rank's when distributed.
        Every rank returns rank 0's results; an error on rank 0 raises on
        every rank."""
        if not self._distributed:
            return self._evaluate_main(self._predictions)
        per_rank = all_gather_objects(self._predictions)
        shared = None
        if is_main_process():
            try:
                shared = (self._evaluate_main([p for preds in per_rank for p in preds]), None)
            except Exception as e:  # every rank must reach the second gather
                logger.exception("evaluation on rank 0 failed")
                shared = (None, repr(e))
        results, error = all_gather_objects(shared)[0]
        if error is not None:
            raise RuntimeError(f"evaluation on rank 0 failed: {error}")
        self._results = results
        return results

    def _evaluate_main(self, predictions) -> "OrderedDict":
        if not predictions:
            logger.warning("MP3DEvaluator received no predictions")
            return OrderedDict()

        if self.eval_full_scene:
            os.makedirs(self._output_dir, exist_ok=True)
            torch.save(self._torchify(predictions),
                       os.path.join(self._output_dir, "NopeSAC_instances_predictions.pth"))
            with open(os.path.join(self._output_dir, "continuous.pkl"), "wb") as f:
                pickle.dump(self.get_optimized_dict(predictions), f)
            # per-image COCO json artifact (_siamese_to_coco,
            # mp3d_evaluation.py:131-167 + detectron2coco.py:7-146)
            try:
                meta = MetadataCatalog.get(self.dataset_name)
                id_map = meta.get("thing_dataset_id_to_contiguous_id") or {}
                write_siamese_coco_json(
                    list(self.dataset_dict.values()), self._output_dir,
                    thing_classes=meta.get("thing_classes") or ["plane"],
                    contiguous_to_dataset_id={v: k for k, v in id_map.items()},
                )
            except Exception:
                logger.exception("COCO json dump failed (non-fatal)")

        results: "OrderedDict" = OrderedDict()
        ious = _MaskIous()
        if "segm" in self._tasks:
            singles = self._siamese_to_single(predictions)
            if singles and "instances" in singles[0]:
                results.update(self._eval_planes(singles, ious))
            if singles and "depth_l1_dist" in singles[0]:
                vals = [p["depth_l1_dist"] for p in singles]
                results["depth_l1_dist"] = float(np.mean(vals))
                self._log(f"Depth metrics: depth_l1_dist={results['depth_l1_dist']:.4f}")
        if "embedding" in self._plane_tasks:
            results.update(self._eval_matching(predictions, ious))
        if "camera" in self._plane_tasks:
            for key in predictions[0]:
                if "onePP" in key:
                    continue
                if "camera" in key and "cls" not in key:
                    results.update(self._eval_camera_reg(predictions, key))
        self._results = results
        return results

    @staticmethod
    def _torchify(predictions):
        """Store pred_plane as torch tensors for bit-compatible .pth files."""
        out = copy.deepcopy(predictions)
        for p in out:
            for i in ("0", "1"):
                if "pred_plane" in p[i]:
                    p[i]["pred_plane"] = torch.as_tensor(np.asarray(p[i]["pred_plane"]))
                for ins in p[i].get("instances", []):
                    c = ins["segmentation"]["counts"]
                    if isinstance(c, str):
                        ins["segmentation"]["counts"] = c.encode("ascii")
            for key in list(p.keys()):
                if "assignment" in key:
                    p[key] = torch.as_tensor(np.asarray(p[key]))
        return out

    @staticmethod
    def _siamese_to_single(predictions):
        singles, seen = [], set()
        for pred in predictions:
            for i in ("0", "1"):
                insts = pred[i].get("instances", [])
                if not insts:
                    continue
                imgid = insts[0]["image_id"]
                if imgid in seen:
                    continue
                seen.add(imgid)
                singles.append(pred[i])
        return singles

    # ------------------------------------------------------------------
    def _eval_planes(self, predictions, ious: _MaskIous, iou_thresh=0.5,
                     normal_threshold=30.0, offset_threshold=0.3):
        """Mask AP + plane AP variants (mp3d_evaluation.py:467-743)."""
        mask_s, mask_l = [], []
        plane_s, plane_l = [], []
        pn_s, pn_l = [], []
        po_s, po_l = [], []
        normal_errs, offset_errs = [], []
        npos = sum(len(v.get("annotations", [])) for v in self.image_gt.values())

        for pred in predictions:
            image_id = pred["image_id"]
            gt_view = self.image_gt.get(image_id)
            if gt_view is None or "instances" not in pred:
                continue
            insts = pred["instances"]
            if not insts:
                continue
            gt_anns = gt_view.get("annotations", [])
            if not gt_anns:
                continue
            gt_planes = [a["plane"] for a in gt_anns]

            scores = np.asarray([ins["score"] for ins in insts])
            miou = ious.iou(pred, gt_view)
            pm = compare_planes(np.asarray(pred["pred_plane"]), gt_planes)

            order = np.argsort(-scores, kind="stable")
            covered = {"mask": set(), "plane": set(), "pn": set(), "po": set()}
            for pid in order:
                gt_id = int(np.argmax(miou[pid]))
                pred_miou = miou[pid, gt_id]
                normal = pm["norm"][pid, gt_id]
                offset = pm["offset"][pid, gt_id]
                normal_errs.append(float(normal))
                offset_errs.append(float(offset))
                s = float(scores[pid])

                ok_iou = pred_miou > iou_thresh
                defs = [
                    ("mask", ok_iou, mask_s, mask_l),
                    ("plane", ok_iou and normal < normal_threshold and offset < offset_threshold,
                     plane_s, plane_l),
                    ("pn", ok_iou and normal < normal_threshold, pn_s, pn_l),
                    ("po", ok_iou and offset < offset_threshold, po_s, po_l),
                ]
                for name, cond, ss, ll in defs:
                    tp = 0
                    if cond and gt_id not in covered[name]:
                        tp = 1
                        covered[name].add(gt_id)
                    ss.append(s)
                    ll.append(tp)

        det = {
            "mask_ap@%.1f" % iou_thresh: compute_ap(np.asarray(mask_s), np.asarray(mask_l), npos),
            "plane_ap@iou%.1fnormal%.1foffset%.1f" % (iou_thresh, normal_threshold, offset_threshold):
                compute_ap(np.asarray(plane_s), np.asarray(plane_l), npos),
            "plane_ap@iou%.1fnormal%.1f" % (iou_thresh, normal_threshold):
                compute_ap(np.asarray(pn_s), np.asarray(pn_l), npos),
            # NOTE: offset key intentionally formatted with NORMAL_threshold
            # — bug-for-bug parity with the reference's own format-string slip
            # (mp3d_evaluation.py:714-716); do NOT "fix" without breaking
            # metric-name compatibility
            "plane_ap@iou%.1foffset%.1f" % (iou_thresh, normal_threshold):
                compute_ap(np.asarray(po_s), np.asarray(po_l), npos),
        }
        ne = np.asarray(normal_errs)
        oe = np.asarray(offset_errs)
        if len(ne):
            det.update({
                "%normal<10": float((ne < 10).mean() * 100),
                "%normal<30": float((ne < 30).mean() * 100),
                "%offset<0.5": float((oe < 0.5).mean() * 100),
                "%offset<0.3": float((oe < 0.3).mean() * 100),
                "mean_normal": float(ne.mean()),
                "median_normal": float(np.median(ne)),
                "mean_offset": float(oe.mean()),
                "median_offset": float(np.median(oe)),
            })
        self._log("Detection metrics:\n" + "\n".join(f"  {k}: {v:.4f}" for k, v in det.items()))
        return det

    # ------------------------------------------------------------------
    def _eval_matching(self, predictions, ious: _MaskIous, iou_thresh=0.5):
        """Correspondence precision/recall/F (mp3d_evaluation.py:746-849)."""
        keys = [k for k in predictions[0] if "assignment" in k]
        stats = {k: {"correct": 0, "matched": 0} for k in keys}
        all_gt = 0
        matching_metrics = {}
        for pred in predictions:
            pair_id = pred["0"]["image_id"] + "__" + pred["1"]["image_id"]
            gt_pair = self.dataset_dict.get(pair_id)
            if gt_pair is None:
                continue
            gt_corr = [list(c) for c in gt_pair["gt_corrs"]]
            all_gt += len(gt_corr)

            matched_iou, matched_gt = [], []
            for i in ("0", "1"):
                n_pred = len(pred[i].get("instances", []))
                if not n_pred or not ious.gt_rles(gt_pair[i]):
                    matched_iou.append(np.zeros(n_pred))
                    matched_gt.append(np.zeros(n_pred, int))
                    continue
                miou = ious.iou(pred[i], gt_pair[i])
                matched_iou.append(miou.max(-1))
                matched_gt.append(miou.argmax(-1))

            for key in keys:
                a = np.asarray(pred[key])
                idxs = np.argwhere(a > 0)
                correct = 0
                for p0, p1 in idxs:
                    if (p0 < len(matched_iou[0]) and p1 < len(matched_iou[1])
                            and matched_iou[0][p0] >= iou_thresh
                            and matched_iou[1][p1] >= iou_thresh):
                        if [int(matched_gt[0][p0]), int(matched_gt[1][p1])] in gt_corr:
                            correct += 1
                stats[key]["matched"] += len(idxs)
                stats[key]["correct"] += correct

        # per-key tables (mp3d_evaluation.py:833-847); the reference returns
        # whatever key iterated LAST - here the unprefixed metrics are
        # deterministically the primary `pred_assignment` key, and every key
        # additionally gets a `<key>/` prefixed copy.
        matching_metrics = {}
        per_key = {}
        for key in keys:
            c, m = stats[key]["correct"], stats[key]["matched"]
            precision = c / m if m else 0.0
            recall = c / all_gt if all_gt else 0.0
            f = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
            per_key[key] = {
                "precision": precision, "recall": recall, "F-score": f,
                "TP": c, "Pred. Num.": m, "GT Num.": all_gt,
            }
            self._log(f"Matching metrics ({key}): " + ", ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in per_key[key].items()))
        primary = "pred_assignment" if "pred_assignment" in per_key else (
            keys[-1] if keys else None)
        if primary is not None:
            matching_metrics.update(per_key[primary])
        for key, m_ in per_key.items():
            for k, v in m_.items():
                matching_metrics[f"{key}/{k}"] = v
        return matching_metrics

    # ------------------------------------------------------------------
    def _eval_camera_reg(self, predictions, camera_name="camera"):
        """Median/mean err + accuracy table (mp3d_evaluation.py:382-425)."""
        gt_tran = np.vstack([np.asarray(p[camera_name]["gts"]["tran"]).reshape(1, 3)
                             for p in predictions])
        gt_rot = np.vstack([np.asarray(p[camera_name]["gts"]["rot"]).reshape(1, 4)
                            for p in predictions])
        pr_tran = np.vstack([np.asarray(p[camera_name]["pred"]["tran"]).reshape(1, 3)
                             for p in predictions])
        pr_rot = np.vstack([np.asarray(p[camera_name]["pred"]["rot"]).reshape(1, 4)
                            for p in predictions])
        tran_err = np.linalg.norm(gt_tran - pr_tran, axis=1)
        rot_err = rotation_angle_error_deg(pr_rot, gt_rot)
        m = {
            "T median err": float(np.median(tran_err)),
            "T mean err": float(np.mean(tran_err)),
            "T err < 1.0": float((tran_err < 1.0).mean() * 100),
            "T err < 0.5": float((tran_err < 0.5).mean() * 100),
            "T err < 0.2": float((tran_err < 0.2).mean() * 100),
            "R median err": float(np.median(rot_err)),
            "R mean err": float(np.mean(rot_err)),
            "R err < 30": float((rot_err < 30).mean() * 100),
            "R err < 15": float((rot_err < 15).mean() * 100),
            "R err < 10": float((rot_err < 10).mean() * 100),
        }
        self._log(f"{camera_name} metrics:\n" + "\n".join(
            f"  {k}: {v:.4f}" for k, v in m.items()))
        if camera_name != "camera":
            return {}
        return m
