"""Online evaluator for sparse-view plane pairs (MP3D / ScanNet): the port's
own copy of the reference's evaluation/mp3d_evaluation.py (MP3DEvaluator),
host-side numpy with the port's RLE codec. It keeps
  * the process()/evaluate() protocol,
  * the `NopeSAC_instances_predictions.pth` (torch.save) and `continuous.pkl`
    artifacts that eval.py reads (mp3d_evaluation.py:331-342),
  * the metric names and thresholds (camera acc@{1.0,0.5,0.2}m/{30,15,10}deg,
    mask AP, plane AP variants, matching precision/recall/F).
`process()` scores each pair as it arrives, against the GT of `dataset_list`:
each view's mask IoU, true-positive labels and plane errors, and the pair's
correct and matched correspondences. In `EvalRunner.test` it runs while the
card computes the next batch, so `evaluate()` is left with the reductions
over the whole split (AP, means, medians, the camera table).
With `distributed=True` each rank processes its own slice of the pairs and
`evaluate()` gathers the predictions and their scores to rank 0 in
rank-major order (rank 0's pairs, then rank 1's, ...). Rank 0 writes the
artifacts and reduces the scores; `dataset_list` is the whole split on every
rank. One more gather shares its result dict, or its error, with every rank.
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

IOU_THRESH = 0.5  # a prediction's mask IoU that matches a GT plane
NORMAL_THRESH = 30.0  # degrees, plane AP
OFFSET_THRESH = 0.3  # plane AP


def _gt_rle(ann: dict, height: int, width: int):
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return {"size": seg["size"], "counts": seg["counts"]}
    mask = rle_util.poly_to_mask(seg, height, width)
    return rle_util.encode(mask)


class _MaskIous:
    """The mask IoU matrices of one split, which a view's plane AP record and
    its pair's correspondences both read, and the GT RLEs they come from.
    Keyed on the identity of the prediction view and the GT view, never on an
    image id: two pairs may share an image id and hold different predictions.
    The prediction views live in the evaluator's records and the GT views in
    its dataset until `reset()` drops the memo, so their ids stay theirs
    while it lives."""

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
        self.reset()

        os.makedirs(self._output_dir, exist_ok=True)
        self.metrics_log = os.path.join(self._output_dir, "metrics.txt")

    def _log(self, msg: str):
        logger.info(msg)
        with open(self.metrics_log, "a") as f:
            f.write(msg + "\n")

    def reset(self):
        self._predictions: List[dict] = []
        # one per prediction: what evaluate() reduces of the pair (_score_pair)
        self._scores: List[dict] = []
        # the instances' image ids whose views have a plane AP record
        self._seen_images: set = set()
        self._ious = _MaskIous()

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
            self._scores.append(self._score_pair(prediction))

    def _score_pair(self, pred: dict) -> dict:
        """What `evaluate()` reduces of one pair. "planes": each view's plane
        AP record, or None where there is none to make: no instances, an
        image id whose view this evaluator scored earlier (`_siamese_to_single`
        keeps the first; across ranks the first of the gathered order, which
        an earlier view of this rank precedes), no GT view or no GT planes.
        "matching": the pair's GT correspondences and, per assignment key, its
        correct and matched ones, or None when the pair is not in
        `dataset_list`."""
        scored = set()
        planes = {"0": None, "1": None}
        if "segm" in self._tasks:
            for i in ("0", "1"):
                insts = pred[i].get("instances", [])
                if not insts or insts[0]["image_id"] in self._seen_images:
                    continue
                self._seen_images.add(insts[0]["image_id"])
                gt_view = self.image_gt.get(pred[i]["image_id"])
                if gt_view is not None and gt_view.get("annotations"):
                    planes[i] = self._score_planes(pred[i], gt_view)
                    scored.add(i)
        matching = None
        if "embedding" in self._plane_tasks:
            matching = self._score_matching(pred, scored)
        if scored:
            trace.count("eval.views_scored", len(scored))
        return {"planes": planes, "matching": matching}

    def _score_planes(self, view: dict, gt_view: dict) -> dict:
        """A view's plane AP record (mp3d_evaluation.py:467-743): its
        predictions in score order, each one's score, its true-positive label
        under the mask, plane, normal and offset criteria (rows 0-3; a GT
        plane counts once per criterion, for its first prediction), and its
        normal and offset errors against the GT plane of highest mask IoU."""
        insts = view["instances"]
        scores = np.asarray([ins["score"] for ins in insts])
        miou = self._ious.iou(view, gt_view)
        pm = compare_planes(np.asarray(view["pred_plane"]),
                            [a["plane"] for a in gt_view["annotations"]])
        order = np.argsort(-scores, kind="stable")
        gt_id = miou[order].argmax(1)
        normal, offset = pm["norm"][order, gt_id], pm["offset"][order, gt_id]
        ok_iou = miou[order, gt_id] > IOU_THRESH
        ok_n, ok_o = normal < NORMAL_THRESH, offset < OFFSET_THRESH
        labels = np.zeros((4, len(order)), np.int64)
        for row, cond in enumerate((ok_iou, ok_iou & ok_n & ok_o, ok_iou & ok_n, ok_iou & ok_o)):
            hits = np.nonzero(cond)[0]
            labels[row, hits[np.unique(gt_id[hits], return_index=True)[1]]] = 1
        return {"scores": scores[order].astype(np.float64), "labels": labels,
                "normal": normal.astype(np.float64), "offset": offset.astype(np.float64)}

    def _score_matching(self, pred: dict, scored: set) -> Optional[dict]:
        """The pair's correspondences (mp3d_evaluation.py:746-849): a matched
        pair of predictions is correct when both masks reach IOU_THRESH on
        their best GT planes and those two planes correspond. Adds the views
        whose IoU it reads to `scored`."""
        gt_pair = self.dataset_dict.get(pred["0"]["image_id"] + "__" + pred["1"]["image_id"])
        if gt_pair is None:
            return None
        gt_corr = [list(c) for c in gt_pair["gt_corrs"]]
        matched_iou, matched_gt = [], []
        for i in ("0", "1"):
            n_pred = len(pred[i].get("instances", []))
            if not n_pred or not self._ious.gt_rles(gt_pair[i]):
                matched_iou.append(np.zeros(n_pred))
                matched_gt.append(np.zeros(n_pred, int))
                continue
            miou = self._ious.iou(pred[i], gt_pair[i])
            scored.add(i)
            matched_iou.append(miou.max(-1))
            matched_gt.append(miou.argmax(-1))

        counts = {}
        for key in pred:
            if "assignment" not in key:
                continue
            idxs = np.argwhere(np.asarray(pred[key]) > 0)
            correct = 0
            for p0, p1 in idxs:
                if (p0 < len(matched_iou[0]) and p1 < len(matched_iou[1])
                        and matched_iou[0][p0] >= IOU_THRESH
                        and matched_iou[1][p1] >= IOU_THRESH):
                    if [int(matched_gt[0][p0]), int(matched_gt[1][p1])] in gt_corr:
                        correct += 1
            counts[key] = (correct, len(idxs))
        return {"gt": len(gt_corr), "counts": counts}

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
            return self._evaluate_main(self._predictions, self._scores)
        per_rank = all_gather_objects((self._predictions, self._scores))
        shared = None
        if is_main_process():
            try:
                shared = (self._evaluate_main([p for preds, _ in per_rank for p in preds],
                                              [s for _, scores in per_rank for s in scores]),
                          None)
            except Exception as e:  # every rank must reach the second gather
                logger.exception("evaluation on rank 0 failed")
                shared = (None, repr(e))
        results, error = all_gather_objects(shared)[0]
        if error is not None:
            raise RuntimeError(f"evaluation on rank 0 failed: {error}")
        self._results = results
        return results

    def _evaluate_main(self, predictions, scores) -> "OrderedDict":
        """The metrics of `predictions` from their `_score_pair` records
        `scores`, in the same order."""
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
        if "segm" in self._tasks:
            singles = self._siamese_to_single(predictions, scores)
            if singles:
                results.update(self._eval_planes([rec for _, rec in singles]))
            if singles and "depth_l1_dist" in singles[0][0]:
                vals = [p["depth_l1_dist"] for p, _ in singles]
                results["depth_l1_dist"] = float(np.mean(vals))
                self._log(f"Depth metrics: depth_l1_dist={results['depth_l1_dist']:.4f}")
        if "embedding" in self._plane_tasks:
            results.update(self._eval_matching(predictions, scores))
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
    def _siamese_to_single(predictions, scores):
        """The first view with instances of each image id (the instances'),
        in order, with its plane AP record."""
        singles, seen = [], set()
        for pred, score in zip(predictions, scores):
            for i in ("0", "1"):
                insts = pred[i].get("instances", [])
                if not insts:
                    continue
                imgid = insts[0]["image_id"]
                if imgid in seen:
                    continue
                seen.add(imgid)
                singles.append((pred[i], score["planes"][i]))
        return singles

    # ------------------------------------------------------------------
    def _eval_planes(self, records):
        """Mask AP + plane AP variants (mp3d_evaluation.py:467-743) over the
        plane AP records of the views kept, concatenated in their order."""
        records = [r for r in records if r is not None]
        npos = sum(len(v.get("annotations", [])) for v in self.image_gt.values())

        def cat(parts):
            return np.concatenate(parts) if parts else np.asarray([])

        scores = cat([r["scores"] for r in records])
        mask_l, plane_l, pn_l, po_l = (cat([r["labels"][row] for r in records])
                                       for row in range(4))
        det = {
            "mask_ap@%.1f" % IOU_THRESH: compute_ap(scores, mask_l, npos),
            "plane_ap@iou%.1fnormal%.1foffset%.1f" % (IOU_THRESH, NORMAL_THRESH, OFFSET_THRESH):
                compute_ap(scores, plane_l, npos),
            "plane_ap@iou%.1fnormal%.1f" % (IOU_THRESH, NORMAL_THRESH):
                compute_ap(scores, pn_l, npos),
            # NOTE: offset key intentionally formatted with NORMAL_threshold
            # — bug-for-bug parity with the reference's own format-string slip
            # (mp3d_evaluation.py:714-716); do NOT "fix" without breaking
            # metric-name compatibility
            "plane_ap@iou%.1foffset%.1f" % (IOU_THRESH, NORMAL_THRESH):
                compute_ap(scores, po_l, npos),
        }
        ne = cat([r["normal"] for r in records])
        oe = cat([r["offset"] for r in records])
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
    def _eval_matching(self, predictions, scores):
        """Correspondence precision/recall/F (mp3d_evaluation.py:746-849) from
        the pairs' counts."""
        keys = [k for k in predictions[0] if "assignment" in k]
        stats = {k: {"correct": 0, "matched": 0} for k in keys}
        all_gt = 0
        for score in scores:
            pair = score["matching"]
            if pair is None:
                continue
            all_gt += pair["gt"]
            for key in keys:
                correct, matched = pair["counts"][key]
                stats[key]["matched"] += matched
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
