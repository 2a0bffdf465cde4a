"""Camera pose bins: nearest-centre classification over the kmeans centres
of `camCls/cam_bins.npz` (the port's copy of the JAX package's
`data/cam_bins.py`; the 32x3 translation and 32x4 rotation centres replace
the reference's sklearn/spherecluster pickles, planercnn_transforms.py:408-420).

The bins decode the SparsePlanes cached camera logits of the offline
evaluator (`models/camera_branch.py`).
"""
from __future__ import annotations

import os

import numpy as np

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "camCls", "cam_bins.npz")


class CameraBins:
    def __init__(self, path: str = _DEFAULT_PATH, dataset: str = "mp3d"):
        data = np.load(path)
        prefix = "mp3d" if "mp3d" in dataset else "scannet"
        self.trans_centers = data[f"{prefix}_trans_centers"]  # [32, 3]
        self.rots_centers = data[f"{prefix}_rots_centers"]  # [32, 4]

    def xyz2class(self, x, y, z) -> int:
        """Nearest translation centre by euclidean distance (sklearn KMeans.predict)."""
        v = np.asarray([x, y, z], dtype=np.float64)
        d = np.linalg.norm(self.trans_centers - v[None], axis=1)
        return int(np.argmin(d))

    def quat2class(self, w, xi, yi, zi) -> int:
        """Nearest rotation centre by cosine similarity (SphericalKMeans.predict
        assigns by maximum dot product on the unit sphere)."""
        v = np.asarray([w, xi, yi, zi], dtype=np.float64)
        n = np.linalg.norm(v)
        if n > 0:
            v = v / n
        c = self.rots_centers / np.maximum(
            np.linalg.norm(self.rots_centers, axis=1, keepdims=True), 1e-12
        )
        return int(np.argmax(c @ v))

    def class2xyz(self, cls) -> np.ndarray:
        return self.trans_centers[cls]

    def class2quat(self, cls) -> np.ndarray:
        return self.rots_centers[cls]
