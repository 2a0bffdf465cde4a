"""Planar meshes and their OBJ/PLY export (the port's copy of the JAX
package's `utils/mesh.py`: host numpy in float64, the same files byte for
byte but for the writer's name in the OBJ comment line).

Spec: utils/vis.py:103-243 (get_single_image_mesh_plane, get_pcd),
utils/mesh_utils.py:21-343 (transform_meshes, save_obj, get_camera_meshes),
utils/camera.py (frustum meshes, PLY/OBJ writers). A plain dict {verts,
faces, vert_colors} stands in for pytorch3d's Meshes/Textures containers.

Geometry: pixels inside each plane mask are back-projected onto the plane
along K^-1 rays, X = ray * d / (n . ray); the mesh is a stride-`step` grid
triangulation of the mask. The textured export warps each plane's texture
with OpenCV's `warpPerspective`, imported where it is called.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .np_geometry import SUNCG_TO_HABITAT, quat_to_rotmat


def backproject_plane_points(mask: np.ndarray, plane: np.ndarray, k_inv_dot_xy1: np.ndarray):
    """Pixel mask + plane (n*d, suncg frame) -> 3D points in the camera
    (habitat) frame for every masked pixel. Spec: utils/vis.py:52-74 (get_pcd)."""
    plane = np.asarray(plane, np.float64) * SUNCG_TO_HABITAT
    offset = np.linalg.norm(plane)
    normal = plane / max(offset, 1e-8)
    ys, xs = np.nonzero(mask)
    rays = k_inv_dot_xy1[:, ys, xs]  # [3, P]; habitat-style rays flip y and z
    rays = rays * np.array([[1.0], [-1.0], [-1.0]])
    denom = normal @ rays
    denom = np.where(np.abs(denom) < 1e-6, 1e-6, denom)
    depth = offset / denom
    return (rays * depth).T, ys, xs  # [P, 3]


def plane_to_mesh(mask: np.ndarray, plane: np.ndarray, k_inv_dot_xy1: np.ndarray,
                  image: Optional[np.ndarray] = None, step: int = 2) -> Optional[Dict]:
    """One plane instance -> {verts, faces, vert_colors, pix_xy} grid mesh,
    or None under 3 points."""
    h, w = mask.shape
    sub = np.zeros_like(mask)
    sub[::step, ::step] = mask[::step, ::step]
    pts, ys, xs = backproject_plane_points(sub, plane, k_inv_dot_xy1)
    if len(pts) < 3:
        return None
    idx_map = -np.ones((h, w), np.int64)
    idx_map[ys, xs] = np.arange(len(pts))

    a = idx_map[:-step:step, :-step:step]
    b = idx_map[:-step:step, step::step]
    c = idx_map[step::step, :-step:step]
    d = idx_map[step::step, step::step]
    quad = (a >= 0) & (b >= 0) & (c >= 0) & (d >= 0)
    qa, qb, qc, qd = a[quad], b[quad], c[quad], d[quad]
    faces = np.concatenate([np.stack([qa, qb, qc], axis=1), np.stack([qb, qd, qc], axis=1)])

    colors = None
    if image is not None:
        colors = np.asarray(image, np.float64)[ys, xs] / 255.0
    return {"verts": pts, "faces": faces, "vert_colors": colors,
            "pix_xy": np.stack([xs, ys], axis=1)}


def planes_to_meshes(masks, planes, k_inv_dot_xy1, image=None, step: int = 2) -> List[Dict]:
    """All plane instances of one view -> list of meshes
    (utils/vis.py:103-243)."""
    out = []
    for mask, plane in zip(masks, planes):
        m = plane_to_mesh(np.asarray(mask) > 0, plane, k_inv_dot_xy1, image, step)
        if m is not None:
            out.append(m)
    return out


def transform_mesh(mesh: Dict, position, rotation) -> Dict:
    """Apply an SE(3) camera pose to a mesh (mesh_utils.py:21-48)."""
    r = quat_to_rotmat(np.asarray(rotation, np.float64).reshape(4))
    verts = mesh["verts"] @ r.T + np.asarray(position, np.float64)
    return {**mesh, "verts": verts}


def join_meshes(meshes: List[Dict]) -> Dict:
    verts, faces, colors = [], [], []
    off = 0
    for m in meshes:
        verts.append(m["verts"])
        faces.append(m["faces"] + off)
        if m.get("vert_colors") is not None:
            colors.append(m["vert_colors"])
        off += len(m["verts"])
    return {
        "verts": np.concatenate(verts) if verts else np.zeros((0, 3)),
        "faces": np.concatenate(faces) if faces else np.zeros((0, 3), np.int64),
        "vert_colors": np.concatenate(colors) if colors else None,
    }


def camera_frustum_mesh(position, rotation, scale: float = 0.3,
                        color=(0.2, 0.9, 0.2)) -> Dict:
    """A pyramid marker for a camera pose (the reference's utils/camera.py:54-302
    builds cylinder and cone markers; a pyramid carries the same pose)."""
    s = scale
    local = np.array([
        [0, 0, 0],
        [-s, -0.75 * s, -1.5 * s],
        [s, -0.75 * s, -1.5 * s],
        [s, 0.75 * s, -1.5 * s],
        [-s, 0.75 * s, -1.5 * s],
    ])
    faces = np.array([
        [0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4],
    ])
    r = quat_to_rotmat(np.asarray(rotation, np.float64).reshape(4))
    verts = local @ r.T + np.asarray(position, np.float64)
    colors = np.tile(np.asarray(color, np.float64), (len(verts), 1))
    return {"verts": verts, "faces": faces, "vert_colors": colors}


# ---------------------------------------------------------------------------
# textured export (UV via plane-rectifying homography)
# ---------------------------------------------------------------------------

def plane_rectify_homography(plane: np.ndarray, k_matrix: Optional[np.ndarray] = None,
                             image_hw=None):
    """Projective map H [3, 3]: image pixel (x, y, 1) -> 2D coordinates in
    the plane's own frame, in closed form (the reference fits it from 4
    control points, utils/vis.py:150-180). With F = diag(1, -1, -1) (the
    suncg -> habitat ray flip), a masked pixel p back-projects to
    X = offset * F K^-1 p / (n . F K^-1 p); its in-plane coordinates (a, b)
    along an orthonormal basis (dir1, dir2) of the plane are projective in p:
        (a, b, 1) ~ [offset*dir1^T; offset*dir2^T; n^T] F K^-1 p.

    image_hw: for an image other than 640x480 with the default MP3D
    intrinsics, pixel coordinates are rescaled to the 640x480 grid first, as
    the mapper's ray map does.
    """
    if k_matrix is None:
        focal = 517.97
        k_matrix = np.array([[focal, 0, 320.0], [0, focal, 240.0], [0, 0, 1.0]])
        if image_hw is not None and tuple(image_hw) != (480, 640):
            # ray(x, y) = K^-1 [x*640/w, y*480/h, 1]  =>  K_eff = S^-1 K,
            # S = diag(640/w, 480/h, 1)
            h_, w_ = image_hw
            k_matrix = np.diag([w_ / 640.0, h_ / 480.0, 1.0]) @ k_matrix
    plane = np.asarray(plane, np.float64) * SUNCG_TO_HABITAT
    offset = np.linalg.norm(plane)
    normal = plane / max(offset, 1e-8)
    seed = np.array([1.0, 0.0, 0.0])
    if abs(normal @ seed) > 0.9:
        seed = np.array([0.0, 1.0, 0.0])
    dir1 = np.cross(seed, normal)
    dir1 /= np.linalg.norm(dir1)
    dir2 = np.cross(normal, dir1)
    flip = np.diag([1.0, -1.0, -1.0])
    k_inv = np.linalg.inv(np.asarray(k_matrix, np.float64))
    return np.stack([offset * dir1, offset * dir2, normal]) @ flip @ k_inv


def plane_texture_and_uvs(mesh: Dict, image: np.ndarray, plane: np.ndarray,
                          k_matrix: Optional[np.ndarray] = None,
                          target_size: int = 300):
    """Rectified texture [T, T, 3] uint8 + per-vertex UVs [N, 2] for one
    plane mesh (utils/vis.py:150-223: warpPerspective to a targetSize^2
    texture, UVs with a flipped v axis)."""
    import cv2

    h = plane_rectify_homography(plane, k_matrix,
                                 image_hw=np.asarray(image).shape[:2])
    xy = np.asarray(mesh["pix_xy"], np.float64)  # [N, 2]
    p = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)  # [N, 3]
    ab = p @ h.T
    ab = ab[:, :2] / ab[:, 2:3]
    lo = ab.min(axis=0)
    span = max(float((ab - lo).max()), 1e-6)
    scale = target_size / span
    shuffle = np.array([[scale, 0, -lo[0] * scale],
                        [0, scale, -lo[1] * scale],
                        [0, 0, 1.0]])
    m = shuffle @ h
    texture = cv2.warpPerspective(
        np.asarray(image, np.uint8), m.astype(np.float64),
        (target_size, target_size))
    uv_px = (ab - lo) * scale
    uvs = np.stack([uv_px[:, 0] / target_size, 1.0 - uv_px[:, 1] / target_size],
                   axis=1)
    return texture, uvs


def planes_to_textured_meshes(masks, planes, k_inv_dot_xy1, image,
                              k_matrix: Optional[np.ndarray] = None,
                              step: int = 2, target_size: int = 300) -> List[Dict]:
    """All plane instances -> meshes carrying {uvs, texture} for OBJ+MTL
    export (utils/vis.py:103-243)."""
    out = []
    for mask, plane in zip(masks, planes):
        m = plane_to_mesh(np.asarray(mask) > 0, plane, k_inv_dot_xy1, image, step)
        if m is None:
            continue
        tex, uvs = plane_texture_and_uvs(m, image, plane, k_matrix, target_size)
        m["texture"] = tex
        m["uvs"] = uvs
        out.append(m)
    return out


def save_obj_textured(folder: str, prefix: str, meshes: List[Dict]) -> str:
    """Write a textured OBJ + MTL + per-plane texture PNGs
    (mesh_utils.py:132-271 save_obj). A mesh without a texture gets a
    flat material."""
    os.makedirs(folder, exist_ok=True)
    obj_path = os.path.join(folder, f"{prefix}.obj")
    mtl_path = os.path.join(folder, f"{prefix}.mtl")
    with open(obj_path, "w") as obj, open(mtl_path, "w") as mtl:
        obj.write(f"mtllib {prefix}.mtl\n")
        v_off, vt_off = 0, 0
        for mi, m in enumerate(meshes):
            name = f"{prefix}_plane{mi}"
            tex = m.get("texture")
            mtl.write(f"newmtl {name}\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\n"
                      "Ks 0.0 0.0 0.0\nd 1.0\nillum 1\n")
            if tex is not None:
                tex_name = f"{prefix}_tex{mi}.png"
                from PIL import Image

                Image.fromarray(np.asarray(tex, np.uint8)).save(
                    os.path.join(folder, tex_name))
                mtl.write(f"map_Kd {tex_name}\n")
            mtl.write("\n")

            obj.write(f"o {name}\nusemtl {name}\n")
            for v in m["verts"]:
                obj.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            uvs = m.get("uvs")
            if uvs is not None:
                for uv in uvs:
                    obj.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
                for f_ in np.asarray(m["faces"], np.int64):
                    a, b, c = f_ + 1
                    obj.write(f"f {a + v_off}/{a + vt_off} {b + v_off}/{b + vt_off} "
                              f"{c + v_off}/{c + vt_off}\n")
                vt_off += len(uvs)
            else:
                for f_ in np.asarray(m["faces"], np.int64):
                    a, b, c = f_ + 1
                    obj.write(f"f {a + v_off} {b + v_off} {c + v_off}\n")
            v_off += len(m["verts"])
    return obj_path


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def save_obj(folder: str, prefix: str, mesh: Dict) -> str:
    """Write an OBJ, vertex colours per vertex in the common `v x y z r g b`
    extension. Spec: mesh_utils.py:132-271."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{prefix}.obj")
    verts = mesh["verts"]
    faces = np.asarray(mesh["faces"], np.int64)
    colors = mesh.get("vert_colors")
    with open(path, "w") as f:
        f.write(f"# nopesac_torch mesh: {len(verts)} verts, {len(faces)} faces\n")
        if colors is None:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        else:
            for v, c in zip(verts, colors):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
    return path


def save_ply(path: str, mesh: Dict) -> str:
    """ASCII PLY writer (utils/camera.py writers)."""
    verts = mesh["verts"]
    faces = np.asarray(mesh["faces"], np.int64)
    colors = mesh.get("vert_colors")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
    return path
