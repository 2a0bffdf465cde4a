"""Pair mapper: pair dicts -> fixed-shape numpy samples, and `collate`
(counterpart of the JAX package's `data/mapper.py:PairMapper`).

Training (`is_train=True`): normalised f32 images and targets. Every view is
padded to NQ plane slots with validity masks; the targets leave in the wire
format of `data/packing.py` (bit-packed masks, k_inv) and are restored on the
device by `packing.unpack_targets`. With `augmentation` the training images
go through `data/augmentation.py:simclr_augment`, drawn from a generator
seeded by the loader per item (`aug_seed`), else from the mapper's own.
Evaluation (`is_train=False`): the images stay uint8 (the eval step
normalises them on the device) and targets are attached only with
`eval_gt_box`. Both carry the pair's metas, pose and correspondences. The
pose's quaternion is sign-canonical (w >= 0) unless `camera_cls_on`
(MODEL.CAMERA_HEAD.CLASSIFICATION_ON: the camera bins fix the sign). The
JAX mapper's `load_bins` (the pose's bins in the meta) has no counterpart:
nothing reads them, the offline evaluator's cached-camera branch decodes
bins through `data/cam_bins.py` itself.

Images come from the pair dict (`data/synthetic.py` renders them) or from
`file_name` (the reference jsons' MP3D prefix replaced by `root_dir`,
resized to the mapper's size); a view with neither is black.
Plane masks, depth and intrinsics, in this order of preference:
  1. mp3d: the view's observation pickle,
     `root_dir/observations/<house>/<image>.pkl` (`semantic_sensor`: one mask
     per non-zero id in ascending order; `depth_sensor`);
  2. scannet: the view's `root_dir/twoView_Anns/<scene>/<image>.pkl`
     (`plane_masks`, `camera_K`), with the depth png beside its image
     (`color` -> `depth`, `.jpg` -> `.png`, millimetres);
  3. the annotations themselves: a dense `mask` or the COCO `segmentation`,
     with the view's in-memory `depth`.
Depth always loads where there is one: the Q-loss reads it whatever
MODEL.DEPTH_ON says. (The JAX mapper's `depth_on` argument changes nothing,
so this one has none.)
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..utils import rle
from .augmentation import simclr_augment

MP3D_PATH_PREFIX = "/Pool1/users/jinlinyi/dataset/mp3d_rpnet_v4_sep20/"
DEFAULT_FOCAL = 517.97
DEFAULT_K = np.array([[DEFAULT_FOCAL, 0, 320.0], [0, DEFAULT_FOCAL, 240.0], [0, 0, 1.0]],
                     np.float32)


def pack_mask_bits_np(masks: np.ndarray) -> np.ndarray:
    """[..., H, W] 0/1 uint8 -> [..., H, W // 8] uint8 (MSB first), the
    wire format that `data/packing.py:unpack_mask_bits` reads."""
    if masks.shape[-1] % 8:
        raise ValueError(f"width {masks.shape[-1]} not divisible by 8")
    return np.packbits(masks, axis=-1)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((w, h)), np.uint8)


def _resize_masks(masks: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N, H', W'] 0/1 uint8 -> [N, h, w], PIL's default resample > 127."""
    return np.stack([_resize(m * 255, h, w) > 127 for m in masks]).astype(np.uint8)


class PairMapper:
    """Callable mapping one pair dict to fixed-shape numpy arrays."""

    def __init__(self, num_queries: int = 50, image_size=(480, 640),
                 pixel_mean=(123.675, 116.280, 103.530), pixel_std=(58.395, 57.120, 57.375),
                 is_train: bool = True, eval_gt_box: bool = False, root_dir: str = "",
                 dataset_kind: str = "mp3d", augmentation: bool = False, seed: int = 42,
                 camera_cls_on: bool = False):
        self.nq = num_queries
        self.h, self.w = image_size
        if self.w % 8:
            raise ValueError(f"the wire format bit-packs masks along W; width {self.w} is not a "
                             f"multiple of 8")
        if dataset_kind not in ("mp3d", "scannet"):
            raise ValueError(f"dataset_kind must be mp3d or scannet, got {dataset_kind!r}")
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_inv_std = (1.0 / np.asarray(pixel_std, np.float32)).astype(np.float32)
        self.k_inv = np.linalg.inv(np.asarray(DEFAULT_K, np.float64)).astype(np.float32)
        self.is_train = is_train
        self.eval_gt_box = eval_gt_box
        self.root_dir = root_dir
        self.kind = dataset_kind
        self.augmentation = augmentation and is_train
        self._aug_rng = np.random.default_rng(seed)
        self.camera_cls_on = camera_cls_on

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

    def _pickle(self, folder: str, group: str, name: str):
        """The pickle at root_dir/folder/group/name.pkl, or None."""
        path = os.path.join(self.root_dir, folder, group, name + ".pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def _split_masks(self, view: dict):
        """(masks [N, H', W'] uint8, depth or None, k_inv) of a view from
        its dataset's pickle, or (None, None, default k_inv) without one."""
        if self.kind == "mp3d":
            house, image = view["image_id"].split("_", 1)
            obs = self._pickle("observations", house, image)
            if obs is not None:
                sem = np.asarray(obs["semantic_sensor"])
                ids = np.unique(sem)
                ids = ids[ids != 0][: self.nq]
                # masks in ascending semantic id, parameters in annotation
                # order: the reference pairs them so (siamese_planeTR.py:488-496)
                return ((ids[:, None, None] == sem[None]).astype(np.uint8),
                        np.asarray(obs["depth_sensor"], np.float32), self.k_inv)
        else:
            scene, image = view["image_id"].split("-")
            ann = self._pickle("twoView_Anns", scene, image)
            if ann is not None and len(ann["plane_masks"]) > 0:
                masks = np.stack([np.asarray(m, np.uint8) for m in ann["plane_masks"]])[: self.nq]
                k_inv = np.linalg.inv(np.asarray(ann["camera_K"], np.float64)).astype(np.float32)
                dpath = view["file_name"].replace("color", "depth").replace(".jpg", ".png")
                depth = None
                if os.path.exists(dpath):
                    from PIL import Image

                    depth = np.asarray(Image.open(dpath), np.float32) / 1000.0
                return masks, depth, k_inv
        return None, None, self.k_inv

    def _annotation_masks(self, view: dict) -> np.ndarray:
        """[N, H', W'] uint8: each annotation's dense `mask`, else its
        `segmentation` at the view's size, else zeros."""
        masks = []
        for ann in view.get("annotations", [])[: self.nq]:
            if "mask" in ann:
                masks.append(np.asarray(ann["mask"], np.uint8))
            elif ann.get("segmentation") is None:
                masks.append(np.zeros((self.h, self.w), np.uint8))
            else:
                masks.append(rle.seg_to_mask(ann["segmentation"], view.get("height", self.h),
                                             view.get("width", self.w)))
        masks = [m if m.shape == (self.h, self.w) else _resize_masks(m[None], self.h, self.w)[0]
                 for m in masks]
        return np.stack(masks) if masks else np.zeros((0, self.h, self.w), np.uint8)

    def view_targets(self, view: dict) -> Dict[str, np.ndarray]:
        """gt_valid [NQ], gt_params [NQ, 3], gt_centers [NQ, 2], depth [H, W],
        gt_masks_packed [NQ, H, W/8], k_inv [3, 3]."""
        nq, h, w = self.nq, self.h, self.w
        masks, depth, k_inv = self._split_masks(view)
        if masks is None:
            masks = self._annotation_masks(view)
        if depth is None:
            depth = view.get("depth")
            depth = np.zeros((h, w), np.float32) if depth is None else np.asarray(depth, np.float32)
        n = min(masks.shape[0], nq)
        if masks.shape[1:] != (h, w) and masks.size:
            masks = _resize_masks(masks, h, w)
        gt_masks = np.zeros((nq, h, w), np.uint8)
        gt_masks[:n] = masks[:n]
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
        planes = [ann["plane"] for ann in view.get("annotations", [])][:n]
        gt_params = np.zeros((nq, 3), np.float32)
        if planes:
            gt_params[:len(planes)] = np.asarray(planes, np.float32)

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

        if depth.shape != (h, w):
            from PIL import Image

            depth = np.asarray(Image.fromarray(depth).resize((w, h)), np.float32)
        return {"gt_valid": gt_valid, "gt_params": gt_params, "gt_centers": gt_centers,
                "depth": depth, "gt_masks_packed": pack_mask_bits_np(gt_masks),
                "k_inv": k_inv}

    def __call__(self, pair: dict, aug_seed: Optional[int] = None) -> Dict:
        """One sample. `aug_seed` seeds this item's augmentation draws (the
        loader passes one per item: a mapper pickled into a worker would
        otherwise repeat its generator's draws)."""
        aug_rng = self._aug_rng if aug_seed is None else np.random.default_rng(aug_seed)
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
            if self.augmentation:
                img = simclr_augment(img, aug_rng)
            img -= self.pixel_mean
            img *= self.pixel_inv_std
            sample[f"image{i}"] = img
        if self.is_train or self.eval_gt_box:
            sample["targets0"] = self.view_targets(pair["0"])
            sample["targets1"] = self.view_targets(pair["1"])

        # relative pose with the quaternion sign-canonical (w >= 0), but where
        # the camera bins' convention fixes the sign (siamese_planeTR.py:556)
        rel = pair.get("rel_pose")
        if rel is not None:
            rot = np.asarray(rel["rotation"], np.float32)
            if rot[0] < 0 and not self.camera_cls_on:
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
