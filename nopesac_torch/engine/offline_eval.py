"""Offline evaluation of the evaluation entry point's artifacts (counterpart of
the root `eval.py`, with its flags, modes and printed tables).

    python -m nopesac_torch.engine.offline_eval \
        --rcnn-cached-file OUT/NopeSAC_instances_predictions.pth \
        --optimized-dict-path OUT/continuous.pkl \
        --evaluate AP|camera|matching [--num-process 8] \
        [--dataset-phase mp3d_test | --dataset-json cached_set.json] \
        [--camera-cached-file sp_camera_logits.pkl] [--num-data N] \
        [--config-file FILE --opts KEY VALUE ...]

It reads the two files that `engine/test.py` writes with
TEST.EVAL_FULL_SCENE (`NopeSAC_instances_predictions.pth`, `continuous.pkl`)
and the split's GT (a registered split, or a cached_set json):
  * AP: full-scene plane AP over the two views merged under the predicted
    camera (matched planes merged, the normal eigen-averaged), at five
    threshold settings (all / -offset / -normal / -mask / -normal-offset);
  * camera: the relative pose's error table;
  * matching: the precision and recall of the plane correspondences.
Any other --evaluate value does nothing and exits 0, as `eval.py` does.
A pair whose `best_camera` is None takes its camera from the SparsePlanes
cached camera logits (--camera-cached-file, `models/camera_branch.py`); so
does every pair when there is no continuous.pkl.

The evaluation is host numpy with `eval.py`'s float64 arithmetic, so its
numbers are `eval.py`'s; nothing of it runs on a device, so the CLI takes
no --device. --num-process > 1 spreads the AP pairs over forked worker
processes, as `eval.py` does.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.linalg import eigh

from ..config.config import get_cfg
from ..core.metrics import voc_ap
from ..data import datasets
from ..data.registry import DatasetCatalog
from ..models.camera_branch import CameraBranch
from ..utils import rle as rle_util
from ..utils.np_geometry import plane_params_to_global

# AP threshold settings: all / -offset / -normal / -mask / -normal-offset
EP_MASK_THRESH = [0.5, 0.5, 0.5, 0.0, 0.5]
EP_NORMAL_THRESH = [30.0, 30.0, 1000.0, 30.0, 1000.0]
EP_OFFSET_THRESH = [1.0, 1000.0, 1.0, 1.0, 1000.0]
EP_AP_STR = ["all", "-offset", "-normal", "-mask", "-normal-offset"]

SCORE_THRESHOLD = 0.1


def _gt_rles_for_view(view: dict):
    h, w = view.get("height", 480), view.get("width", 640)
    out = []
    for ann in view.get("annotations", []):
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            out.append({"size": seg["size"], "counts": seg["counts"]})
        else:
            out.append(rle_util.encode(rle_util.poly_to_mask(seg, h, w)))
    return out


def _normal_offset(params):
    params = np.asarray(params, dtype=np.float64).reshape(-1, 3)
    offset = np.maximum(np.linalg.norm(params, ord=2, axis=1), 1e-5).reshape(-1, 1)
    return params / offset, offset


class Evaluator:
    def __init__(self, args, dataset=None):
        dataset = dataset or args.dataset_phase
        self.score_threshold = SCORE_THRESHOLD

        # the config contributes only TEST.EVAL_GT_BOX, which backfills the
        # predictions' file_name keys (reference eval.py:96-116)
        self.gt_box = False
        if getattr(args, "config_file", ""):
            cfg = get_cfg()
            cfg.merge_from_file(args.config_file)
            if getattr(args, "opts", None):
                cfg.merge_from_list(args.opts)
            self.gt_box = bool(cfg.TEST.EVAL_GT_BOX)

        with open(args.rcnn_cached_file, "rb") as f:
            print(f"loading rcnn cached file from {args.rcnn_cached_file}")
            self.rcnn_data = torch.load(f, map_location="cpu", weights_only=False)
            print("rcnn cached file has been loaded")
        if self.gt_box and "file_name" not in self.rcnn_data[0]["0"]:
            for pair in self.rcnn_data:
                for i in ("0", "1"):
                    pair[i]["file_name"] = pair[i]["image_id"]

        if args.dataset_json:
            dataset_list = datasets.load_pair_json(args.dataset_json)
        else:
            dataset_list = DatasetCatalog.get(dataset)
        self.dataset_dict = {
            d["0"]["image_id"] + "__" + d["1"]["image_id"]: d for d in dataset_list
        }
        self.optimized_dict = None
        # the cached-camera fallback (reference eval.py:119-135): the
        # SparsePlanes kmeans-bin logits file as another camera source
        self.camera_branch = None
        if args.camera_cached_file:
            self.camera_branch = CameraBranch(
                dataset=datasets.dataset_kind(dataset),
                cached_logits_path=args.camera_cached_file)
        if args.num_data > 0:
            self.rcnn_data = self.rcnn_data[: args.num_data]
        self.sanity_check()

    def get_camera_info(self, idx, tran_topk=0, rot_topk=0):
        """Camera of pair idx from the cached-logits branch; both topk == -1
        give the GT pose of the predictions themselves (reference
        eval.py:191-195)."""
        if tran_topk == -1 and rot_topk == -1:
            gts = self.rcnn_data[idx]["camera"]["gts"]
            return {"position": np.asarray(gts["tran"]).reshape(3),
                    "rotation": np.asarray(gts["rot"]).reshape(4)}
        if self.camera_branch is None:
            raise RuntimeError(
                "camera fallback requested (optimized dict has no best_camera "
                f"for pair {idx}) but no --camera-cached-file was given")
        key = self.rcnnidx2datasetkey(idx)
        return self.camera_branch.cached_rel_camera(
            [self.dataset_dict[key]], tran_topk, rot_topk)[0]

    def rcnnidx2datasetkey(self, idx):
        return (self.rcnn_data[idx]["0"]["image_id"] + "__"
                + self.rcnn_data[idx]["1"]["image_id"])

    def sanity_check(self):
        keys = list(self.dataset_dict.keys())
        for idx in range(len(self.rcnn_data)):
            key = self.rcnnidx2datasetkey(idx)
            if key not in self.dataset_dict:
                raise KeyError(f"prediction pair {key} not in dataset")
            if idx < len(keys) and keys[idx] != key:
                # AP only looks pairs up by key
                print("warning: prediction order differs from dataset order")
                break

    # ------------------------------------------------------------------
    def evaluate_camera(self, return_dict):
        tran_errs, rot_errs = [], []
        for idx in range(len(self.rcnn_data)):
            entry = return_dict[idx]
            if "gt_camera" in entry:
                gt_cam = entry["gt_camera"]
            else:
                gt_cam = {
                    "position": self.rcnn_data[idx]["camera"]["gts"]["tran"],
                    "rotation": self.rcnn_data[idx]["camera"]["gts"]["rot"],
                }
            best = entry["best_camera"]
            if best is None:
                best = self.get_camera_info(idx, tran_topk=0, rot_topk=0)
            pred_cam = {k: np.asarray(v).reshape(-1) for k, v in best.items()}
            tran_errs.append(np.linalg.norm(
                pred_cam["position"] - np.asarray(gt_cam["position"], np.float64)))
            d = np.abs(np.sum(pred_cam["rotation"] * np.asarray(gt_cam["rotation"], np.float64)))
            rot_errs.append(2 * np.arccos(np.clip(d, -1, 1)) * 180 / np.pi)

        tran_errs = np.asarray(tran_errs)
        rot_errs = np.asarray(rot_errs)
        acc = lambda e, t: (e < t).mean() * 100  # noqa: E731
        print("Median Error [tran, rot]:            {:.2f}, {:.2f}".format(
            np.median(tran_errs), np.median(rot_errs)))
        print("Mean Error   [tran, rot]:            {:.2f}, {:.2f}".format(
            tran_errs.mean(), rot_errs.mean()))
        print("Accuracy     [tran(1m), rot(30')]:   {:.2f}, {:.2f}".format(
            acc(tran_errs, 1.0), acc(rot_errs, 30)))
        print("Accuracy     [tran(0.5m), rot(15')]: {:.2f}, {:.2f}".format(
            acc(tran_errs, 0.5), acc(rot_errs, 15)))
        print("Accuracy     [tran(0.2m), rot(10')]: {:.2f}, {:.2f}".format(
            acc(tran_errs, 0.2), acc(rot_errs, 10)))
        print("Accuracy     [tran(0.1m), rot(5')]:  {:.2f}, {:.2f}".format(
            acc(tran_errs, 0.1), acc(rot_errs, 5)))
        return {
            "tran_errs": tran_errs, "rot_errs": rot_errs,
            "mean_tran_err": tran_errs.mean(), "mean_rot_err": rot_errs.mean(),
            "median_tran_err": float(np.median(tran_errs)),
            "median_rot_err": float(np.median(rot_errs)),
            "tran_acc": acc(tran_errs, 1.0) / 100, "rot_acc": acc(rot_errs, 30) / 100,
        }

    # ------------------------------------------------------------------
    def get_gt_corr_list(self, idx):
        key = self.rcnnidx2datasetkey(idx)
        return [list(c) for c in self.dataset_dict[key]["gt_corrs"]]

    def get_maskiou(self, idx):
        key = self.rcnnidx2datasetkey(idx)
        mious = {}
        for i in ("0", "1"):
            gt_rles = _gt_rles_for_view(self.dataset_dict[key][i])
            pred_rles = [ins["segmentation"] for ins in self.rcnn_data[idx][i]["instances"]]
            mious[i] = rle_util.iou(pred_rles, gt_rles, [0] * len(gt_rles))
        return mious

    def evaluate_matching_precision_recall(self):
        all_matched = all_correct = all_gt = 0
        for idx in range(len(self.rcnn_data)):
            pred_corr = np.argwhere(np.asarray(self.optimized_dict[idx]["best_assignment"]))
            gt_corr = self.get_gt_corr_list(idx)
            mious = self.get_maskiou(idx)
            m0, m1 = mious["0"], mious["1"]
            gi0 = m0.argmax(-1) if m0.size else np.zeros(0, int)
            gv0 = m0.max(-1) if m0.size else np.zeros(0)
            gi1 = m1.argmax(-1) if m1.size else np.zeros(0, int)
            gv1 = m1.max(-1) if m1.size else np.zeros(0)
            correct = 0
            for p0, p1 in pred_corr:
                if p0 < len(gv0) and p1 < len(gv1) and gv0[p0] >= 0.5 and gv1[p1] >= 0.5:
                    if [int(gi0[p0]), int(gi1[p1])] in gt_corr:
                        correct += 1
            all_matched += len(pred_corr)
            all_correct += correct
            all_gt += len(gt_corr)
        precision = all_correct / all_matched if all_matched else 0.0
        recall = all_correct / all_gt if all_gt else 0.0
        f = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        print("precision2 = ", precision)
        print("recall2 = ", recall)
        print("F-score = ", f)
        print("TP = ", all_correct)
        print("Pred Num = ", all_matched)
        print("GT Num:", all_gt)
        return {"precision": precision, "recall": recall, "F-score": f}

    # ------------------------------------------------------------------
    def _merged_params(self, per_view, corrs):
        """Merge the matched plane pairs: the eigen-averaged normal and the
        mean offset (reference eval.py:445-468)."""
        merged_offset, merged_normal, merged_score = [], [], []
        has_scores = "scores" in per_view["0"]
        for i in ("0", "1"):
            n = len(per_view[i]["offset"])
            col = 0 if i == "0" else 1
            for ann_id in range(n):
                if len(corrs) == 0 or ann_id not in corrs[:, col]:
                    merged_offset.append(per_view[i]["offset"][ann_id])
                    merged_normal.append(per_view[i]["normal"][ann_id])
                    if has_scores:
                        merged_score.append(per_view[i]["scores"][ann_id])
        for a0, a1 in corrs:
            normal_pair = np.vstack((per_view["0"]["normal"][a0], per_view["1"]["normal"][a1]))
            w, v = eigh(normal_pair.T @ normal_pair)
            avg_normal = v[:, np.argmax(w)]
            if (avg_normal @ normal_pair.T).sum() < 0:
                avg_normal = -avg_normal
            merged_normal.append(avg_normal)
            merged_offset.append((per_view["0"]["offset"][a0] + per_view["1"]["offset"][a1]) / 2)
            if has_scores:
                merged_score.append(max(per_view["0"]["scores"][a0], per_view["1"]["scores"][a1]))
        out = {
            "merged_offset": np.asarray(merged_offset, dtype=np.float64).reshape(-1, 1),
            "merged_normal": np.asarray(merged_normal, dtype=np.float64).reshape(-1, 3),
        }
        if has_scores:
            out["merged_score"] = np.asarray(merged_score, dtype=np.float64).reshape(-1, 1)
        return out

    def evaluate_ap_by_idx(self, idx):
        key = self.rcnnidx2datasetkey(idx)
        od = self.optimized_dict[idx]
        pred_corr = np.argwhere(np.asarray(od["best_assignment"]))
        pred_camera = od["best_camera"]
        if pred_camera is None:
            # the cached-camera fallback (reference eval.py:370-375)
            pred_camera = self.get_camera_info(idx, 0, 0)
        override = od.get("plane_param_override")

        identity = {"position": np.zeros(3), "rotation": np.array([1.0, 0, 0, 0])}
        cam = {
            "position": np.asarray(pred_camera["position"]).reshape(3),
            "rotation": np.asarray(pred_camera["rotation"]).reshape(4),
        }

        pred = {"corrs": pred_corr}
        for i in ("0", "1"):
            cam_i = cam if i == "0" else identity
            insts = self.rcnn_data[idx][i]["instances"]
            scores = np.asarray([ins["score"] for ins in insts])
            pp = np.asarray(self.rcnn_data[idx][i]["pred_plane"])
            # as the reference: the 0.1 threshold filters the parameters and
            # scores (create_instances' conf_threshold, reference
            # eval.py:401-409) while get_maskiou takes every instance
            # (reference :650-653)
            chosen = scores > self.score_threshold
            if override is not None:
                params = np.asarray(override[i])
            else:
                params = pp[chosen]
            scores = scores[chosen] if override is None else scores
            n, o = _normal_offset(params)
            glob = plane_params_to_global(params, cam_i["position"], cam_i["rotation"])
            gn, go = _normal_offset(glob)
            pred[i] = {"normal": gn, "offset": go, "scores": scores}
            pred[i + "_local"] = {"normal": n, "offset": o, "scores": scores}
        pred["merged"] = self._merged_params(pred, pred_corr)

        gt_camera = od.get("gt_camera") or {
            "position": self.rcnn_data[idx]["camera"]["gts"]["tran"],
            "rotation": self.rcnn_data[idx]["camera"]["gts"]["rot"],
        }
        gt_cam = {
            "position": np.asarray(gt_camera["position"]).reshape(3),
            "rotation": np.asarray(gt_camera["rotation"]).reshape(4),
        }
        gt_corr = np.asarray(self.get_gt_corr_list(idx)).reshape(-1, 2)

        gt = {"corrs": gt_corr}
        for i in ("0", "1"):
            cam_i = gt_cam if i == "0" else identity
            params = np.asarray(
                [ann["plane"] for ann in self.dataset_dict[key][i]["annotations"]]
            ).reshape(-1, 3)
            n, o = _normal_offset(params)
            glob = plane_params_to_global(params, cam_i["position"], cam_i["rotation"])
            gn, go = _normal_offset(glob)
            gt[i] = {"normal": gn, "offset": go}
            gt[i + "_local"] = {"normal": n, "offset": o}
        gt["merged"] = self._merged_params(gt, gt_corr)

        # individual errors in each view's own frame
        individual_error_offset, individual_error_normal = {}, {}
        for i in ("0", "1"):
            individual_error_offset[i] = np.abs(
                pred[i + "_local"]["offset"] - gt[i + "_local"]["offset"].T)
            individual_error_normal[i] = np.arccos(np.clip(np.abs(
                pred[i + "_local"]["normal"] @ gt[i + "_local"]["normal"].T), -1, 1)
            ) / np.pi * 180

        individual_miou = self.get_maskiou(idx)

        err_offsets = np.abs(pred["merged"]["merged_offset"] - gt["merged"]["merged_offset"].T)
        err_normals = np.arccos(np.clip(np.abs(
            pred["merged"]["merged_normal"] @ gt["merged"]["merged_normal"].T), -1, 1)
        ) / np.pi * 180
        mask_iou = self.get_maskiou_merged(idx, pred_corr=pred_corr, gt_corr=gt_corr)

        return {
            "err_offsets": err_offsets,
            "err_normals": err_normals,
            "mask_iou": mask_iou,
            "scores": pred["merged"]["merged_score"],
            "individual_error_offset": individual_error_offset,
            "individual_error_normal": individual_error_normal,
            "individual_miou": individual_miou,
            "individual_score": {
                "0": pred["0"]["scores"].reshape(-1, 1),
                "1": pred["1"]["scores"].reshape(-1, 1),
            },
        }

    def get_single2merge(self, idx, pred_corr, gt_corr):
        key = self.rcnnidx2datasetkey(idx)
        entry2gt, gt2entry = {}, {"0": {}, "1": {}}
        eid = 0
        for i in ("0", "1"):
            col = 0 if i == "0" else 1
            for s_i in range(len(self.dataset_dict[key][i]["annotations"])):
                if len(gt_corr) == 0 or s_i not in gt_corr[:, col]:
                    entry2gt[eid] = {"pair": i, "ann_id": s_i, "merged": False}
                    gt2entry[i][s_i] = eid
                    eid += 1
        for pair in gt_corr:
            entry2gt[eid] = {"pair": ["0", "1"], "ann_id": pair, "merged": True}
            gt2entry["0"][pair[0]] = eid
            gt2entry["1"][pair[1]] = eid
            eid += 1

        entry2pred, pred2entry = {}, {"0": {}, "1": {}}
        eid = 0
        for i in ("0", "1"):
            col = 0 if i == "0" else 1
            for s_i in range(len(self.rcnn_data[idx][i]["pred_plane"])):
                if len(pred_corr) == 0 or s_i not in pred_corr[:, col]:
                    entry2pred[eid] = {"pair": i, "ann_id": s_i, "merged": False}
                    pred2entry[i][s_i] = eid
                    eid += 1
        for pair in pred_corr:
            entry2pred[eid] = {"pair": ["0", "1"], "ann_id": pair, "merged": True}
            pred2entry["0"][pair[0]] = eid
            pred2entry["1"][pair[1]] = eid
            eid += 1
        return entry2gt, entry2pred

    def get_maskiou_merged(self, idx, pred_corr, gt_corr):
        """The merged entries' mask IoU table (reference eval.py:657-717)."""
        mious = self.get_maskiou(idx)
        entry2gt, entry2pred = self.get_single2merge(idx, pred_corr, gt_corr)
        np_, ng = len(entry2pred), len(entry2gt)
        out = np.zeros((np_, ng))
        for r in range(np_):
            pe = entry2pred[r]
            for c in range(ng):
                ge = entry2gt[c]
                if not pe["merged"] and not ge["merged"]:
                    if pe["pair"] != ge["pair"]:
                        continue
                    out[r, c] = mious[pe["pair"]][pe["ann_id"], ge["ann_id"]]
                elif pe["merged"] and not ge["merged"]:
                    out[r, c] = mious[ge["pair"]][pe["ann_id"][int(ge["pair"])], ge["ann_id"]]
                elif not pe["merged"] and ge["merged"]:
                    out[r, c] = mious[pe["pair"]][pe["ann_id"], ge["ann_id"][int(pe["pair"])]]
                else:
                    iou0 = mious["0"][pe["ann_id"][0], ge["ann_id"][0]]
                    iou1 = mious["1"][pe["ann_id"][1], ge["ann_id"][1]]
                    out[r, c] = (iou0 + iou1) / 2
        return out

    def evaluate_by_list(self, idxs) -> Dict[int, dict]:
        return {idx: self.evaluate_ap_by_idx(idx) for idx in idxs}


# ---------------------------------------------------------------------------
# instance benchmarking (reference eval.py:832-1010)
# ---------------------------------------------------------------------------

def evaluate_by_idx(eval_dict):
    ndt, ngt = eval_dict["mask_iou"].shape
    stats = []
    if ndt == 0:
        for _ in range(len(EP_AP_STR)):
            stats.append([np.zeros((0, 1), bool), np.zeros((0, 1), bool),
                          np.zeros((0, 1), bool), ngt, None, None, None])
        return stats
    threshs = [EP_MASK_THRESH, EP_NORMAL_THRESH, EP_OFFSET_THRESH]
    fns = [np.greater_equal, np.less_equal, np.less_equal]
    overlaps = [eval_dict["mask_iou"], eval_dict["err_normals"], eval_dict["err_offsets"]]
    dt = {"sc": eval_dict["scores"]}
    gt = {"diff": np.zeros((ngt, 1), dtype=bool)}
    for i in range(len(EP_AP_STR)):
        ov = [fn(o, th[i]) for fn, o, th in zip(fns, overlaps, threshs)]
        combined = np.all(np.asarray(ov), 0).astype(np.float32)
        stats.append(list(inst_bench_image(dt, gt, {"minoverlap": 0.5}, combined)))
    return stats


def inst_bench_image(dt, gt, b_opts, overlap):
    n_dt = len(dt["sc"])
    n_gt = len(gt["diff"])
    num_inst = int(np.sum(gt["diff"] == False))  # noqa: E712
    det = np.zeros((n_gt, 1), bool)
    tp = np.zeros((n_dt, 1), bool)
    fp = np.zeros((n_dt, 1), bool)
    dup = np.zeros((n_dt, 1), bool)
    inst_id = np.zeros((n_dt, 1), np.int32)
    ov_out = np.zeros((n_dt, 1), np.float32)
    for i in range(n_dt):
        if n_gt > 0:
            max_ov = overlap[i, :].max()
            max_ind = overlap[i, :].argmax()
            inst_id[i] = max_ind
            ov_out[i] = max_ov
        else:
            max_ov, max_ind = 0, -1
            inst_id[i] = -1
        if max_ov >= b_opts["minoverlap"]:
            if not gt["diff"][max_ind]:
                if not det[max_ind]:
                    tp[i] = True
                    det[max_ind] = True
                else:
                    fp[i] = True
                    dup[i] = True
        else:
            fp[i] = True
    return tp, fp, dt["sc"], num_inst, dup, inst_id, ov_out


def inst_bench(tp, fp, score, num_inst):
    tp = np.vstack(tp)
    fp = np.vstack(fp)
    sc = np.vstack(score)
    cat = np.hstack((tp, fp, sc))
    order = np.argsort(cat[:, 2])[::-1]
    cat = cat[order]
    tp_c = np.cumsum(cat[:, 0])
    fp_c = np.cumsum(cat[:, 1])
    npos = np.sum(num_inst)
    rec = tp_c / npos
    prec = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    return voc_ap(rec, prec), rec, prec, npos


_FORKED_EV: Optional[Evaluator] = None  # the evaluator the forked workers inherit


def _evaluate_chunk(chunk: List[int]) -> Dict[int, dict]:
    return _FORKED_EV.evaluate_by_list(chunk)


def multiprocess_by_list(ev: Evaluator, num_process: int, idx_list: List[int]) -> Dict[int, dict]:
    """evaluate_ap_by_idx of every pair, over `num_process` forked workers
    in contiguous chunks, as `eval.py`'s: each inherits the evaluator and is
    sent only its chunk's indices."""
    global _FORKED_EV
    if num_process <= 1:
        return ev.evaluate_by_list(idx_list)
    per = int(np.ceil(len(idx_list) / num_process))
    chunks = [idx_list[i * per:(i + 1) * per] for i in range(num_process)]
    _FORKED_EV = ev
    try:
        with multiprocessing.get_context("fork").Pool(num_process) as pool:
            parts = pool.map(_evaluate_chunk, chunks)
    finally:
        _FORKED_EV = None
    return {idx: d for part in parts for idx, d in part.items()}


def ap_table(ev: Evaluator, num_process: int) -> Dict[str, float]:
    """The full-scene AP (in [0, 1]) of each threshold setting, EP_AP_STR's
    order, printed as `eval.py` prints it."""
    idxs = list(range(len(ev.rcnn_data)))
    error_dict = multiprocess_by_list(ev, num_process, idxs)
    bench_stats = [evaluate_by_idx(error_dict[idx]) for idx in idxs]
    bb = list(zip(*bench_stats))
    aps = {}
    for i, name in enumerate(EP_AP_STR):
        tp, fp, sc, num_inst, *_ = zip(*bb[i])
        aps[name] = inst_bench(tp, fp, sc, num_inst)[0]
        print("{:>20s}: {:5.3f}".format(name, aps[name] * 100.0))
    return aps


def load_optimized_dict(ev: Evaluator, path: str) -> bool:
    """Set ev.optimized_dict from continuous.pkl at `path`; without one, from
    the cached-camera branch (every pair's camera decoded, no matches). False
    when there is neither."""
    if path and os.path.exists(path):
        print(f"reading from {path}")
        with open(path, "rb") as f:
            ev.optimized_dict = pickle.load(f)
    elif ev.camera_branch is not None:
        print("no optimized dict; using cached-camera branch poses")
        ev.optimized_dict = {
            idx: {
                "best_camera": ev.get_camera_info(idx, 0, 0),
                "best_assignment": np.zeros((1, 1)),
                "plane_param_override": None,
            }
            for idx in range(len(ev.rcnn_data))
        }
    else:
        return False
    return True


def main(args) -> int:
    ev = Evaluator(args, dataset=args.dataset_phase)
    if not load_optimized_dict(ev, args.optimized_dict_path):
        print("Error: No optimized dict found!")
        return 1
    if args.evaluate == "AP":
        ap_table(ev, args.num_process)
    elif args.evaluate == "camera":
        ev.evaluate_camera(ev.optimized_dict)
    elif args.evaluate == "matching":
        ev.evaluate_matching_precision_recall()
    else:
        # the reference's if/elif chain does nothing for any other mode,
        # its own default --evaluate correspondence included
        print(f"--evaluate {args.evaluate}: nothing to do "
              "(supported: AP / camera / matching)")
    return 0


def argument_parser() -> argparse.ArgumentParser:
    """`eval.py`'s flags."""
    parser = argparse.ArgumentParser(description="Evaluation")
    parser.add_argument("--config-file", default="", help="path to config file")
    parser.add_argument("--rcnn-cached-file", required=True,
                        help="path to instances_predictions.pth")
    parser.add_argument("--evaluate", default="correspondence",
                        help="AP / camera / matching")
    parser.add_argument("--num-process", default=8, type=int)
    parser.add_argument("--camera-cached-file", default="", required=False)
    parser.add_argument("--num-data", default=-1, type=int)
    parser.add_argument("--dataset-phase", default="mp3d_test", type=str)
    parser.add_argument("--optimized-dict-path", default="", type=str)
    parser.add_argument("--dataset-json", default="", type=str,
                        help="direct path to a cached_set json (bypasses the catalog)")
    parser.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    return parser


def cli(argv: Optional[List[str]] = None) -> int:
    args = argument_parser().parse_args(argv)
    print(args)
    return main(args)


if __name__ == "__main__":
    sys.exit(cli())
