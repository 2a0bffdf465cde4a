"""Kernel B4: fused 1x1 conv + FrozenBN (+ residual) (+ ReLU), the tail of a
ResNet identity block at inference.

Counterpart of the JAX package's `ops/bottleneck_pallas.py:conv1x1_bn_add_relu`.
The port is NCHW, so for each image the kernel computes
Y_b[Cout, P] = W[Cout, Cin] . X_b[Cin, P] over the P = H * W pixels, with
FrozenBN folded into an f32 epilogue: y = act(acc * scale + shift [+ res]).
On a CUDA tensor the wrapper launches `csrc/bottleneck_wgmma.cu` (bf16 on the
tensor cores) or `csrc/bottleneck.cu` (f32, and bf16 off the `wgmma` shapes);
on a CPU tensor it runs `conv1x1_bn_act_plain`. There is no backward: the
block takes this path only in eval mode.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.device import LAUNCHES, refuse_autograd
from . import _build

KERNEL = "bottleneck_tail"
_DTYPES = (torch.float32, torch.bfloat16)


def conv1x1_bn_act_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                         relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: an f32 product over pixels, then the epilogue,
    rounded once to x's dtype. The weight is cast to x's dtype first, as the
    TPU kernel does."""
    b, cin = x.shape[:2]
    w2 = w.reshape(w.shape[0], -1).to(x.dtype).to(torch.float32)
    acc = torch.matmul(w2, x.reshape(b, cin, -1).to(torch.float32))  # [B, Cout, P]
    acc = acc * scale.to(torch.float32)[:, None] + shift.to(torch.float32)[:, None]
    if residual is not None:
        acc = acc + residual.reshape(acc.shape).to(torch.float32)
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype).reshape(b, w2.shape[0], *x.shape[2:])


SMS = 132            # H100 SXM
BLOCKS_PER_SM = 2    # resident blocks per SM of either kernel (their launch bounds)
TILE_COLS = 128      # pixels per block
MAX_SPLIT = 8        # the portable thread-block cluster size
MIN_PART = 128       # Cin per split part
WGMMA_K = 64         # Cin per stage of the wgmma variant
WGMMA_MIN_PART = 256  # its Cin per split part


def b4_config(b: int, cin: int, cout: int, p: int, dtype: torch.dtype = torch.float32,
              aligned: bool = True) -> dict:
    """The compiled variant and launch config of one call (the tables in the
    source notes of `csrc/bottleneck.cu` and `csrc/bottleneck_wgmma.cu`).
    `wgmma` (bf16, Cin % 64 == 0, P % 4 == 0, 16-byte aligned tensors) runs
    on the tensor cores with BM 64, X by TMA per image where P % 8 == 0 and
    by cp.async over the flattened B * P pixels otherwise; `vec` (f32, P %
    4 == 0, Cin % 4 == 0, aligned) takes the cp.async FFMA path; anything
    else the masked scalar one. Off `wgmma`, BM is 64 where Cout <= 64, else
    128. Cin is split in 2, 4 or 8 while the grid is under one wave of SMS x
    BLOCKS_PER_SM blocks (`wgmma`, parts >= WGMMA_MIN_PART) or two (`vec`,
    parts >= MIN_PART). On `wgmma` with X by TMA and no split, one wave of
    blocks (at most) walks the tiles; `blocks` is the grid the library
    launches."""
    return dict(_config(b, cin, cout, p, dtype, aligned))


@functools.lru_cache(maxsize=None)
def _config(b, cin, cout, p, dtype, aligned):
    wgmma = dtype == torch.bfloat16 and aligned and p % 4 == 0 and cin % WGMMA_K == 0
    bm = 64 if wgmma or cout <= 64 else 128
    vec = dtype == torch.float32 and aligned and p % 4 == 0 and cin % 4 == 0
    tma_x = wgmma and p % 8 == 0
    cols = b * -(-p // TILE_COLS) if tma_x else -(-(b * p) // TILE_COLS)
    tiles = -(-cout // bm) * cols
    if wgmma:
        grid, step, min_part = SMS * BLOCKS_PER_SM, WGMMA_K, WGMMA_MIN_PART
    else:
        grid, step, min_part = 2 * SMS * BLOCKS_PER_SM, 16, MIN_PART
    split = 1
    while ((wgmma or vec) and tiles * split < grid and 2 * split <= MAX_SPLIT
           and cin % (step * 2 * split) == 0 and cin // (2 * split) >= min_part):
        split *= 2
    walk = tma_x and split == 1
    cfg = {"variant": "wgmma" if wgmma else "vec" if vec else "scalar", "bm": bm,
           "split": split, "tiles": tiles,
           "blocks": min(tiles, SMS * BLOCKS_PER_SM) if walk else tiles * split}
    if wgmma:
        cfg["x_load"] = "tma" if tma_x else "cp.async"
    return cfg


last_config: dict = {}  # the config of the latest CUDA launch


# x, w, scale, shift, residual, out; the ints of each variant's call (8 of
# `wgmma`'s, 9 of the others'); stream
_SIGNATURE = {"bottleneck_wgmma": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
              "bottleneck": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]}


def conv1x1_bn_act_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = True) -> torch.Tensor:
    """Launch the variant `b4_config` picks on x [B, Cin, *spatial] and the
    conv weight [Cout, Cin(, 1, 1)]; residual [B, Cout, *spatial] or None.
    A bf16 call takes the card 20-80 us, about what this wrapper takes the
    host, so it does no work twice: the config and the C entry points are
    cached, and tensors already in their dtype and layout are not copied."""
    dev, dtype, shape = x.device, x.dtype, x.shape
    if dev.type != "cuda":
        raise ValueError(f"bottleneck kernel takes CUDA tensors, got {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"bottleneck kernel takes f32 or bf16 inputs, got {dtype}")
    if len(shape) < 3:
        raise ValueError(f"bottleneck kernel takes x [B, Cin, *spatial], got {tuple(shape)}")
    b, cin, cout = shape[0], shape[1], w.shape[0]
    if w.numel() != cout * cin:
        raise ValueError(f"weight {tuple(w.shape)} is not a 1x1 conv from {cin} channels")
    out_shape = (b, cout, *shape[2:])
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale/shift must be [{cout}], got {tuple(scale.shape)}, "
                         f"{tuple(shift.shape)}")
    if residual is not None and (residual.shape != out_shape or residual.dtype != dtype):
        raise ValueError(f"residual must be {dtype} {out_shape}, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    if (w.device != dev or scale.device != dev or shift.device != dev
            or (residual is not None and residual.device != dev)):
        raise ValueError("bottleneck inputs must lie on one device")
    refuse_autograd(KERNEL, x, w, scale, shift, *(() if residual is None else (residual,)))
    x = x.contiguous()
    w = (w if w.dtype == dtype else w.to(dtype)).contiguous()
    scale = (scale if scale.dtype == torch.float32 else scale.float()).contiguous()
    shift = (shift if shift.dtype == torch.float32 else shift.float()).contiguous()
    res = None if residual is None else residual.contiguous()
    out = torch.empty(out_shape, dtype=dtype, device=dev)
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | (ptrs[4] or 0) | ptrs[5]) % 16 == 0
    p = math.prod(shape[2:])
    cfg = _config(b, cin, cout, p, dtype, aligned)
    if cfg["variant"] == "wgmma":
        lib, name = "bottleneck_wgmma", "nopesac_conv1x1_bn_act_wgmma"
        args = (b, cin, cout, p, int(relu), int(cfg["x_load"] == "tma"), cfg["split"],
                cfg["blocks"])
    else:
        lib, name = "bottleneck", "nopesac_conv1x1_bn_act"
        args = (b, cin, cout, p, int(relu), int(dtype == torch.bfloat16), cfg["bm"],
                int(cfg["variant"] == "vec"), cfg["split"])
    fn = _build.entry(lib, name, _SIGNATURE[lib])
    # the launch goes to x's card, on its current stream (the raw handle:
    # `torch.cuda.current_stream` builds a Stream object per call)
    with torch.cuda.device(dev):
        fn(*ptrs, *args, torch._C._cuda_getCurrentRawStream(dev.index))
    LAUNCHES.bump(KERNEL)
    last_config.clear()
    last_config.update(cfg)
    return out


def kernel_attributes(dtype: torch.dtype, bm: int, variant: str, x_load: str = "tma") -> dict:
    """Registers, shared memory and spill bytes of one compiled variant
    (cudaFuncGetAttributes), and for `wgmma` the blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the record of a run
    on the card."""
    names = ("registers", "static_smem", "dynamic_smem", "local_bytes", "max_threads")
    if variant == "wgmma":
        return _build.attributes("bottleneck_wgmma", "nopesac_conv1x1_bn_act_wgmma_attrs",
                                 names + ("blocks_per_sm",), int(x_load == "tma"))
    return _build.attributes("bottleneck", "nopesac_conv1x1_bn_act_attrs", names,
                             int(dtype == torch.bfloat16), bm, int(variant == "vec"))


def conv1x1_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """relu((W . x) * scale + shift [+ residual]) per pixel, in x's dtype."""
    if x.device.type == "cpu":
        return conv1x1_bn_act_plain(x, w, scale, shift, residual, relu)
    return conv1x1_bn_act_cuda(x, w, scale, shift, residual, relu)
