"""Kernel H1: the DETR matcher's batched linear sum assignment.

Counterpart of the JAX package's on-device matcher `hungarian_device`
(`losses/hungarian.py`, Jonker-Volgenant under `vmap`; XLA while-loops, no
Pallas kernel). On a CUDA tensor the whole function, from the costs
[P, NQ, NG] of every supervision level to the match [P, NQ] (padding,
sanitising, transposing, solving, inverting), is one launch of
`csrc/hungarian.cu`, and nothing is read back to the host. Its plain version
is `losses/hungarian.py:hungarian_plain`, which `losses/hungarian.py:hungarian`
takes for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.device import LAUNCHES
from . import _build

KERNEL = "hungarian"
MAX_N = 128  # queries: at most 4 columns per lane of a warp


def kernel_attributes() -> dict:
    """Registers, static shared memory, spill bytes and the most threads per
    block of the kernel (cudaFuncGetAttributes), for the record of a run on
    the card."""
    return _build.attributes("hungarian", "nopesac_hungarian_attrs",
                             ("registers", "static_smem", "local_bytes", "max_threads"))


# cost, num_gt, match; p, nq, ng; stream
_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def hungarian_cuda(cost: torch.Tensor, num_gt: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/hungarian.cu`: one warp per problem. cost f32 [P, NQ, NG]
    with NG <= NQ <= 128, num_gt int64 [P] (the kernel clamps it to
    [0, NG]) -> match int64 [P, NQ]. Checks dtypes and shapes from the
    metadata alone, before the device: no value is read on the host."""
    if cost.dtype != torch.float32 or cost.dim() != 3:
        raise TypeError(f"hungarian kernel takes f32 costs [P, NQ, NG], got {cost.dtype} "
                        f"{tuple(cost.shape)}")
    p, nq, ng = cost.shape
    if nq > MAX_N:
        raise ValueError(f"hungarian kernel takes at most {MAX_N} queries, got {nq}")
    if ng > nq:
        raise ValueError(f"hungarian kernel takes at most as many GT planes as queries, got "
                         f"NQ {nq}, NG {ng}")
    if num_gt.dtype != torch.int64:
        raise TypeError(f"hungarian num_gt must be int64, got {num_gt.dtype}")
    if tuple(num_gt.shape) != (p,):
        raise ValueError(f"hungarian num_gt must be [{p}], got {tuple(num_gt.shape)}")
    dev = cost.device
    if dev.type != "cuda" or num_gt.device != dev:
        raise ValueError(f"hungarian kernel takes CUDA tensors on one device, got cost on {dev}, "
                         f"num_gt on {num_gt.device}")
    out = torch.empty((p, nq), dtype=torch.int64, device=dev)
    if p == 0 or nq == 0:
        return out
    cost, num_gt = cost.detach().contiguous(), num_gt.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.entry("hungarian", "nopesac_hungarian", _SIGNATURE)(
            cost.data_ptr(), num_gt.data_ptr(), out.data_ptr(), p, nq, ng, stream)
    LAUNCHES.bump(KERNEL)
    return out
