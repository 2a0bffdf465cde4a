"""Legacy camera branch: the pose from cached SparsePlanes camera logits (the
port's copy of the JAX package's `models/camera_branch.py`, cut to what the
offline evaluator calls; spec modeling/meta_arch/camera_branch.py:7-133,
Camera_Branch).

The offline evaluator (`engine/offline_eval.py`) uses it as the camera of a
pair whose `best_camera` is missing: it decodes the top-k kmeans-bin logits
into (position, rotation) through the bin centres (`data/cam_bins.py`).
Host numpy, no model.
"""
from __future__ import annotations

import pickle
from typing import List

import numpy as np

from ..data.cam_bins import CameraBins


class CameraBranch:
    def __init__(self, dataset: str, cached_logits_path: str):
        self.bins = CameraBins(dataset=dataset)
        with open(cached_logits_path, "rb") as f:
            self.cached = pickle.load(f)
        # key -> row, built once (a test split has ~13k pairs)
        self._key_index = {k: i for i, k in enumerate(self.cached["keys"])}

    def cached_rel_camera(self, pair_dicts: List[dict], tran_topk: int = 0,
                          rot_topk: int = 0) -> List[dict]:
        """Decode the cached-logits file for these pairs (camera_branch.py:82-117:
        key file_name0 + file_name1, fields `keys`, `logits_sms` {tran, rot},
        `gts` {tran, rot}). Each topk == -1 selects that field's cached GT."""
        out = []
        for pair in pair_dicts:
            key = pair["0"].get("file_name", "") + pair["1"].get("file_name", "")
            idx = self._key_index.get(key)
            if idx is None:
                raise KeyError(
                    f"pair {key!r} not present in the cached camera logits file")
            tl = np.asarray(self.cached["logits_sms"]["tran"][idx])
            rl = np.asarray(self.cached["logits_sms"]["rot"][idx])
            if tran_topk == -1:
                tran, tran_p = np.asarray(self.cached["gts"]["tran"][idx]), 1.0
            else:
                ti = int(np.argsort(tl)[::-1][tran_topk])
                tran, tran_p = self.bins.class2xyz(ti), float(tl[ti])
            if rot_topk == -1:
                rot, rot_p = np.asarray(self.cached["gts"]["rot"][idx]), 1.0
            else:
                ri = int(np.argsort(rl)[::-1][rot_topk])
                rot, rot_p = self.bins.class2quat(ri), float(rl[ri])
            out.append({"position": np.asarray(tran).reshape(3),
                        "position_prob": tran_p,
                        "rotation": np.asarray(rot).reshape(4),
                        "rotation_prob": rot_p})
        return out
