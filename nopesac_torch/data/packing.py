"""Wire format of the training targets: packed on the host (numpy), unpacked
on the device (torch). Counterpart of the JAX package's `data/packing.py`.

  * gt_masks [NQ, H, W] uint8 0/1 travel bit-packed along W (np.packbits,
    MSB first): 8x fewer bytes;
  * gt_pixel_centers [H, W, 2] is rebuilt from (gt_masks, gt_centers): the
    masks are disjoint, so it is one einsum;
  * k_inv_dot_xy1 [3, H, W] is rebuilt from k_inv [3, 3] (inverted on the
    host in f64).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.device import DeviceLike


def pack_mask_bits_np(masks: np.ndarray) -> np.ndarray:
    """[..., H, W] 0/1 uint8 -> [..., H, W // 8] uint8 (MSB first)."""
    if masks.shape[-1] % 8:
        raise ValueError(f"width {masks.shape[-1]} not divisible by 8")
    return np.packbits(masks, axis=-1)


def unpack_mask_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., H, W // 8] uint8 -> [..., H, W] uint8 (MSB first)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def coordinate_map_from_kinv(k_inv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """k_inv [..., 3, 3] -> ray map [..., 3, h, w] over the pixel grid
    rescaled to the canonical 640 x 480."""
    dev = k_inv.device
    x = (torch.arange(w, dtype=torch.float32, device=dev) / w * 640.0)[None, :].repeat(h, 1)
    y = (torch.arange(h, dtype=torch.float32, device=dev) / h * 480.0)[:, None].repeat(1, w)
    xy1 = torch.stack([x, y, torch.ones((h, w), dtype=torch.float32, device=dev)]).reshape(3, -1)
    out = torch.matmul(k_inv.to(torch.float32), xy1)
    return out.reshape(k_inv.shape[:-2] + (3, h, w))


def unpack_targets(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The classic per-view target keys (gt_masks, gt_pixel_centers
    [B, H, W, 2], k_inv_dot_xy1) from the wire format; a dict that already
    has gt_masks passes through."""
    if "gt_masks" in t:
        return t
    out = dict(t)
    masks = unpack_mask_bits(out.pop("gt_masks_packed"))  # [B, NQ, H, W] uint8
    out["gt_masks"] = masks
    h, w = masks.shape[-2:]
    out["gt_pixel_centers"] = torch.einsum("...nhw,...nc->...hwc", masks.to(torch.float32),
                                           t["gt_centers"])
    out["k_inv_dot_xy1"] = coordinate_map_from_kinv(out.pop("k_inv"), h, w)
    return out


def batch_to_device(batch: Dict, device: DeviceLike) -> Dict:
    """A collated numpy batch as tensors on `device` (the meta list is
    dropped); targets stay in the wire format."""
    out = {}
    for key, v in batch.items():
        if key == "meta":
            continue
        if isinstance(v, dict):
            out[key] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for k, a in v.items()}
        else:
            out[key] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out
