"""Numpy host-side geometry (the port's copy of the JAX package's
`utils/np_geometry.py`, the same float64 arithmetic): the ray map, the
quaternion helpers and the plane frame changes of the offline evaluator and
the mesh tools, and the Euler rotations of the GT-matcher noise ablation
(`engine/test.py:perturb_planes`). Quaternions are (w, x, y, z).
"""
from __future__ import annotations

import numpy as np

SUNCG_TO_HABITAT = np.array([1.0, -1.0, -1.0])


def get_coordinate_map(h: int = 480, w: int = 640, k_matrix=None) -> np.ndarray:
    """K^-1 @ [x, y, 1] ray map [3, h, w] f32, the pixel grid rescaled to the
    640x480 frame (siamese_planeTR.py:815-839)."""
    if k_matrix is None:
        focal = 517.97
        k_matrix = np.array(
            [[focal, 0.0, 320.0], [0.0, focal, 240.0], [0.0, 0.0, 1.0]], np.float64)
    k_inv = np.linalg.inv(np.asarray(k_matrix, np.float64))
    x = np.tile((np.arange(w, dtype=np.float64) / w * 640.0)[None, :], (h, 1))
    y = np.tile((np.arange(h, dtype=np.float64) / h * 480.0)[:, None], (1, w))
    xy1 = np.stack([x, y, np.ones((h, w))], axis=0).reshape(3, -1)
    return (k_inv @ xy1).reshape(3, h, w).astype(np.float32)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """[..., 4] -> [..., 3, 3] (does not normalise)."""
    q = np.asarray(q, dtype=np.float64)
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y,
        2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x,
        2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y,
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return np.asarray(q) * np.array([1.0, -1.0, -1.0, -1.0])


def rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix [3, 3] -> unit quaternion [4] (Shepperd's
    construction, the largest pivot first)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    pivots = [tr, m[0, 0], m[1, 1], m[2, 2]]
    best = int(np.argmax(pivots))
    if best == 0:
        s = max(np.sqrt(max(1.0 + tr, 0.0)) * 2.0, 1e-12)
        q = [s / 4.0, (m[2, 1] - m[1, 2]) / s,
             (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif best == 1:
        s = max(np.sqrt(max(1.0 + m[0, 0] - m[1, 1] - m[2, 2], 0.0)) * 2.0, 1e-12)
        q = [(m[2, 1] - m[1, 2]) / s, s / 4.0,
             (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif best == 2:
        s = max(np.sqrt(max(1.0 - m[0, 0] + m[1, 1] - m[2, 2], 0.0)) * 2.0, 1e-12)
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
             s / 4.0, (m[1, 2] + m[2, 1]) / s]
    else:
        s = max(np.sqrt(max(1.0 - m[0, 0] - m[1, 1] + m[2, 2], 0.0)) * 2.0, 1e-12)
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, s / 4.0]
    q = np.asarray(q, np.float64)
    return q / max(np.linalg.norm(q), 1e-12)


def plane_params_to_global(planes: np.ndarray, position, rotation) -> np.ndarray:
    """n*d plane parameters in the camera's (suncg) frame -> the global
    (habitat) frame of the pose (mesh_utils.py:89-106,
    get_plane_params_in_global)."""
    planes = np.asarray(planes, dtype=np.float64).reshape(-1, 3)
    tran = np.asarray(position, dtype=np.float64).reshape(3)
    q = np.asarray(rotation, dtype=np.float64).reshape(4)
    q = q / max(np.linalg.norm(q), 1e-12)
    rot = quat_to_rotmat(q)
    start = np.ones((len(planes), 3)) * tran
    end = (rot @ (planes * SUNCG_TO_HABITAT).T).T + tran
    a = end
    b = end - start
    denom = np.maximum(np.linalg.norm(b, axis=1) ** 2, 1e-12)
    return ((a * b).sum(axis=1) / denom).reshape(-1, 1) * b


def plane_params_to_local(planes: np.ndarray, position, rotation) -> np.ndarray:
    """Inverse of `plane_params_to_global` (mesh_utils.py:108-130)."""
    planes = np.asarray(planes, dtype=np.float64).reshape(-1, 3)
    tran = np.asarray(position, dtype=np.float64).reshape(3)
    q = np.asarray(rotation, dtype=np.float64).reshape(4)
    q = q / np.linalg.norm(q)
    b = planes
    a = np.ones((len(planes), 3)) * tran
    denom = np.maximum(np.linalg.norm(b, axis=1) ** 2, 1e-12)
    planes_world = a + b - ((a * b).sum(axis=1) / denom).reshape(-1, 1) * b
    r_inv = quat_to_rotmat(quat_conjugate(q))
    end = (r_inv @ (planes_world - tran).T).T
    return end * SUNCG_TO_HABITAT


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
