"""Numpy host-side geometry (the port's copy of the JAX package's
`utils/np_geometry.py`, the same arithmetic): the Euler rotations of the
GT-matcher noise ablation (`engine/test.py:perturb_planes`).
"""
from __future__ import annotations

import numpy as np


def rotmat_from_euler_deg(a1: np.ndarray, a2: np.ndarray, a3: np.ndarray) -> np.ndarray:
    """R = Rx(a1) @ Ry(a2) @ Rz(a3), angles in degrees, [...] -> [..., 3, 3].
    Spec: camera_modules.py:53-102 (build_rot_matrix_from_angle)."""
    a1, a2, a3 = np.deg2rad(a1), np.deg2rad(a2), np.deg2rad(a3)
    c1, s1 = np.cos(a1), np.sin(a1)
    c2, s2 = np.cos(a2), np.sin(a2)
    c3, s3 = np.cos(a3), np.sin(a3)
    one, zero = np.ones_like(c1), np.zeros_like(c1)
    rx = np.stack([one, zero, zero, zero, c1, -s1, zero, s1, c1], -1).reshape(a1.shape + (3, 3))
    ry = np.stack([c2, zero, s2, zero, one, zero, -s2, zero, c2], -1).reshape(a2.shape + (3, 3))
    rz = np.stack([c3, -s3, zero, s3, c3, zero, zero, zero, one], -1).reshape(a3.shape + (3, 3))
    return rx @ ry @ rz
