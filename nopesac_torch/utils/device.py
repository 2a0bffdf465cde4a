"""Device resolution, the f32 precision policy and the kernel launch counters."""
from __future__ import annotations

from typing import Dict, Union

import torch

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


def set_f32_parity() -> None:
    """Full-f32 matmuls and convolutions on the card. cuDNN convolutions
    default to TF32, which keeps about three decimal digits and breaks parity
    with the f32 JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class LaunchCounters:
    """One integer per kernel, bumped by its wrapper where it launches the
    CUDA kernel and nowhere else (the plain CPU path does not count)."""

    def __init__(self, names):
        self._counts: Dict[str, int] = {n: 0 for n in names}

    def bump(self, name: str) -> None:
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


# the kernels of the port; each `ops/` wrapper bumps its own name
KERNEL_NAMES = ("select_maps", "sinkhorn", "mask_loss_fwd", "mask_loss_bwd", "bottleneck_tail")
LAUNCHES = LaunchCounters(KERNEL_NAMES)
