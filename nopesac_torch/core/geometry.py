"""Core 3D geometry on torch tensors (counterpart of the JAX package's
`core/geometry.py`, same conventions).

  * Planes are parameterised as ``n * d`` (unit normal times offset), a 3-vec.
  * Relative camera pose is (translation[3], quaternion[4] w-first), with the
    quaternion sign canonicalised to w >= 0 at several points in the pipeline.
  * Plane params live in "suncg" camera axes; warping to the global (habitat)
    frame flips the y/z axes via ``[1, -1, -1]``.
"""
from __future__ import annotations

import functools

import torch

# suncg -> habitat axis flip applied to plane parameters before SE(3) warps.
SUNCG_TO_HABITAT = (1.0, -1.0, -1.0)


@functools.lru_cache(maxsize=None)
def _flip_vector(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """SUNCG_TO_HABITAT on `device`, made once per (device, dtype): a host
    value copied per call would make the host wait for the device. Made
    outside inference mode, so training can save it for the backward."""
    with torch.inference_mode(False):
        return torch.tensor(SUNCG_TO_HABITAT, dtype=dtype).to(device)


def _flip(planes: torch.Tensor) -> torch.Tensor:
    return planes * _flip_vector(planes.device, planes.dtype)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix; [..., 4] -> [..., 3, 3].
    Does NOT normalise q."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * y * y - 2 * z * z,
            2 * x * y - 2 * w * z,
            2 * x * z + 2 * w * y,
            2 * x * y + 2 * w * z,
            1 - 2 * x * x - 2 * z * z,
            2 * y * z - 2 * w * x,
            2 * x * z - 2 * w * y,
            2 * y * z + 2 * w * x,
            1 - 2 * x * x - 2 * y * y,
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def canonicalize_quat_sign(q: torch.Tensor) -> torch.Tensor:
    """Flip the quaternion sign so that w >= 0."""
    sig = ((q[..., 0:1] >= 0.0).to(q.dtype) - 0.5) * 2.0
    return q * sig


def safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm that is exactly 0 (not NaN-prone) at v == 0."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    is_zero = sq == 0
    sq_safe = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq_safe))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalisation with torch.nn.functional.normalize semantics
    (v / max(|v|, eps)), zero-safe at v == 0."""
    n = safe_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp_min(n, eps)


def quat_from_rotvec(rotvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion (w, x, y, z); [..., 3] -> [..., 4],
    in the sinc form that is stable at angle -> 0."""
    angle = torch.linalg.vector_norm(rotvec, dim=-1, keepdim=True)
    small = angle < 1e-8
    k = torch.where(small, torch.full_like(angle, 0.5),
                    torch.sin(0.5 * angle) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(0.5 * angle), rotvec * k], dim=-1)


def warp_planes_to_global(planes: torch.Tensor, quat: torch.Tensor,
                          tran: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Warp view-0 plane params (n*d) through the relative pose into the
    global frame. planes [..., P, 3], quat [..., 4], tran [..., 3] -> [..., P, 3].

    With end = R(p*flip) + t and b = end - t:
    warped = (<end, b> / (|b| + eps)^2) * b.
    R is computed in the quaternion's dtype; the product runs in the
    promoted dtype of the planes and R, as jnp.einsum promotes (f32 planes
    warped by a bf16 pose give f32).
    """
    rot = quat_to_rotmat(quat)  # [..., 3, 3]
    dt = torch.promote_types(planes.dtype, rot.dtype)
    t = tran.unsqueeze(-2)
    end = torch.matmul(_flip(planes).to(dt), rot.to(dt).transpose(-1, -2)) + t
    b = end - t
    scale = torch.sum(end * b, dim=-1) / torch.square(safe_norm(b, dim=-1) + eps)
    return scale.unsqueeze(-1) * b


def warp_planes_identity(planes: torch.Tensor) -> torch.Tensor:
    """View-1 planes into the global frame: a pure axis flip."""
    return _flip(planes)
