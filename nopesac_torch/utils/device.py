"""Device resolution, the dtype resolver, the precision policy and the kernel
launch counters."""
from __future__ import annotations

from typing import Dict, Union

import torch

from .graphs import on_replay

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`cuda` unless the caller names another device. A missing card on a
    CUDA request is an error: there is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nopesac_torch runs on CUDA by default but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(value: str, key: str) -> torch.dtype:
    """A config dtype string (MODEL.COMPUTE_DTYPE, BACKBONE_TRAIN_DTYPE,
    FPN_TRAIN_DTYPE) as a torch dtype; a typo such as "bf16" or "fp32"
    raises instead of falling back to f32."""
    if value not in DTYPES:
        raise ValueError(f"MODEL.{key} must be one of {sorted(DTYPES)}, got {value!r}")
    return DTYPES[value]


def set_f32_parity() -> None:
    """The precision policy on the card: full-f32 matmuls and convolutions
    (cuDNN convolutions default to TF32, which keeps about three decimal
    digits and breaks parity with the f32 JAX reference), and bf16 GEMMs
    that accumulate in f32 throughout, as XLA does (cuBLAS may otherwise
    reduce split-K partial sums in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class LaunchCounters:
    """One integer per kernel, bumped by its wrapper where it launches the
    CUDA kernel and nowhere else (the plain CPU path does not count). A
    launch captured in a CUDA graph counts at each of the graph's replays
    (`utils/graphs.py:on_replay`)."""

    def __init__(self, names):
        self._counts: Dict[str, int] = {n: 0 for n in names}

    def bump(self, name: str) -> None:
        on_replay(lambda: self._add(name))

    def _add(self, name: str) -> None:
        self._counts[name] += 1

    def reset(self) -> None:
        for n in self._counts:
            self._counts[n] = 0

    def snapshot(self) -> Dict[str, int]:
        return dict(self._counts)

    def __getitem__(self, name: str) -> int:
        return self._counts[name]


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward would cut the graph: its
    output carries no grad_fn, so a loss downstream would silently send no
    gradient to what produced the inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {kernel} kernel has no backward; call it under torch.no_grad() "
                           f"or use its plain version where a gradient is needed")


# the kernels of the port; each `ops/` wrapper bumps its own name (B3 counts
# its bf16-logit variant under a name of its own)
KERNEL_NAMES = ("select_maps", "sinkhorn", "mask_loss_fwd", "mask_loss_bwd", "mask_loss_fwd_bf16",
                "mask_loss_bwd_bf16", "bottleneck_tail", "hungarian")
LAUNCHES = LaunchCounters(KERNEL_NAMES)
