"""Device resolution, the dtype resolver and the precision policy."""
from __future__ import annotations

from typing import Union

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
