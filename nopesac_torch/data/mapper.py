"""Pair mapper: pair dicts -> fixed-shape numpy samples, and `collate`
(counterpart of the JAX package's `data/mapper.py:PairMapper`, augmentation
off).

Training (`is_train=True`): normalised f32 images and targets. Every view is
padded to NQ plane slots with validity masks; the targets leave in the wire
format of `data/packing.py` (bit-packed masks, k_inv) and are restored on the
device by `packing.unpack_targets`. Evaluation (`is_train=False`): the
images stay uint8 (the eval step normalises them on the device) and targets
are attached only with `eval_gt_box`. Both carry the pair's metas, pose and
correspondences.

Images come from the pair dict (`data/synthetic.py` renders them) or from
`file_name` (the reference jsons' MP3D prefix replaced by `root_dir`,
resized to the mapper's size); a view with neither is black.
Plane masks come from an annotation's dense `mask` or its COCO
`segmentation`. The MP3D observation and ScanNet annotation pickles,
augmentation and the loader are not ported.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..utils import rle
from . import packing

MP3D_PATH_PREFIX = "/Pool1/users/jinlinyi/dataset/mp3d_rpnet_v4_sep20/"
DEFAULT_FOCAL = 517.97
DEFAULT_K = np.array([[DEFAULT_FOCAL, 0, 320.0], [0, DEFAULT_FOCAL, 240.0], [0, 0, 1.0]],
                     np.float32)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((w, h)), np.uint8)


class PairMapper:
    """Callable mapping one pair dict to fixed-shape numpy arrays."""

    def __init__(self, num_queries: int = 50, image_size=(480, 640),
                 pixel_mean=(123.675, 116.280, 103.530), pixel_std=(58.395, 57.120, 57.375),
                 is_train: bool = True, eval_gt_box: bool = False, root_dir: str = ""):
        self.nq = num_queries
        self.h, self.w = image_size
        if self.w % 8:
            raise ValueError(f"the wire format bit-packs masks along W; width {self.w} is not a "
                             f"multiple of 8")
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_inv_std = (1.0 / np.asarray(pixel_std, np.float32)).astype(np.float32)
        self.k_inv = np.linalg.inv(np.asarray(DEFAULT_K, np.float64)).astype(np.float32)
        self.is_train = is_train
        self.eval_gt_box = eval_gt_box
        self.root_dir = root_dir

    def image(self, view: dict) -> np.ndarray:
        """The view's uint8 image [H, W, 3]: in memory, else read from
        `file_name`, else black."""
        fname = view.get("file_name", "").replace(MP3D_PATH_PREFIX, self.root_dir)
        if view.get("image") is not None:
            img = np.asarray(view["image"], np.uint8)
        elif fname and os.path.exists(fname):
            from PIL import Image

            img = np.asarray(Image.open(fname).convert("RGB"), np.uint8)
        else:
            return np.zeros((self.h, self.w, 3), np.uint8)
        if img.shape[:2] != (self.h, self.w):
            img = _resize(img, self.h, self.w)
        return img

    def _mask(self, ann: dict, view: dict) -> np.ndarray:
        if "mask" in ann:
            return ann["mask"]
        return rle.seg_to_mask(ann["segmentation"], view.get("height", self.h),
                               view.get("width", self.w))

    def view_targets(self, view: dict) -> Dict[str, np.ndarray]:
        """gt_valid [NQ], gt_params [NQ, 3], gt_centers [NQ, 2], depth [H, W],
        gt_masks_packed [NQ, H, W/8], k_inv [3, 3]."""
        nq, h, w = self.nq, self.h, self.w
        annos = view.get("annotations", [])[:nq]
        n = len(annos)
        gt_masks = np.zeros((nq, h, w), np.uint8)
        for i, ann in enumerate(annos):
            mask = self._mask(ann, view)
            if mask.shape != (h, w):
                raise ValueError(f"mask {mask.shape} does not match the mapper's {(h, w)}")
            gt_masks[i] = mask
        if n > 1:
            # GT masks must be disjoint (the Q-loss rewrite and the pixel-centre
            # map assume one plane per pixel): the first annotation wins
            claimed = gt_masks[0].copy()
            free = np.empty_like(claimed)
            for i in range(1, n):
                np.subtract(1, claimed, out=free)
                gt_masks[i] *= free
                claimed |= gt_masks[i]
        gt_valid = np.zeros((nq,), bool)
        gt_valid[:n] = True
        gt_params = np.zeros((nq, 3), np.float32)
        if n:
            gt_params[:n] = np.asarray([ann["plane"] for ann in annos], np.float32)

        # plane centres in normalised xy from the row and column marginals
        ys = np.arange(h, dtype=np.float32) / h
        xs = np.arange(w, dtype=np.float32) / w
        m8 = gt_masks[:n]
        row = m8.sum(axis=1, dtype=np.float32)  # [n, w]
        col = m8.sum(axis=2, dtype=np.float32)  # [n, h]
        areas = row.sum(axis=1) + 1e-10
        gt_centers = np.zeros((nq, 2), np.float32)
        gt_centers[:n, 0] = row @ xs / areas
        gt_centers[:n, 1] = col @ ys / areas

        depth = view.get("depth")
        depth = np.zeros((h, w), np.float32) if depth is None else np.asarray(depth, np.float32)
        return {"gt_valid": gt_valid, "gt_params": gt_params, "gt_centers": gt_centers,
                "depth": depth, "gt_masks_packed": packing.pack_mask_bits_np(gt_masks),
                "k_inv": self.k_inv}

    def __call__(self, pair: dict) -> Dict:
        sample: Dict = {"meta": {
            "image_id0": pair["0"]["image_id"], "image_id1": pair["1"]["image_id"],
            "file_name0": pair["0"].get("file_name", ""),
            "file_name1": pair["1"].get("file_name", ""),
            "rel_pose": pair.get("rel_pose"), "gt_corrs": pair.get("gt_corrs"),
        }}
        for i in ("0", "1"):
            img = self.image(pair[i])
            if not self.is_train:
                sample[f"image{i}"] = img
                continue
            img = img.astype(np.float32)
            img -= self.pixel_mean
            img *= self.pixel_inv_std
            sample[f"image{i}"] = img
        if self.is_train or self.eval_gt_box:
            sample["targets0"] = self.view_targets(pair["0"])
            sample["targets1"] = self.view_targets(pair["1"])

        # relative pose with the quaternion sign-canonical (w >= 0)
        rel = pair.get("rel_pose")
        if rel is not None:
            rot = np.asarray(rel["rotation"], np.float32)
            if rot[0] < 0:
                rot = -rot
            tran = np.asarray(rel["position"], np.float32)
            sample["gt_pose"] = np.concatenate([tran, rot]).astype(np.float32)
        else:
            sample["gt_pose"] = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)

        # GT correspondences, capped at NQ
        corr_idx1 = np.zeros((self.nq,), np.int32)
        corr_idx2 = np.zeros((self.nq,), np.int32)
        corr_valid = np.zeros((self.nq,), bool)
        kept = [(a, b) for a, b in (pair.get("gt_corrs") or [])
                if a < self.nq and b < self.nq][: self.nq]
        for k, (a, b) in enumerate(kept):
            corr_idx1[k], corr_idx2[k], corr_valid[k] = a, b, True
        sample["corr_idx1"] = corr_idx1
        sample["corr_idx2"] = corr_idx2
        sample["corr_valid"] = corr_valid
        return sample


def collate(samples: List[Dict]) -> Dict:
    """Stack mapper outputs into one batched dict (metas listed)."""
    out: Dict = {"meta": [s["meta"] for s in samples]}
    for key in samples[0]:
        if key == "meta":
            continue
        if key.startswith("targets"):
            out[key] = {k: np.stack([s[key][k] for s in samples]) for k in samples[0][key]}
        else:
            out[key] = np.stack([s[key] for s in samples])
    return out
