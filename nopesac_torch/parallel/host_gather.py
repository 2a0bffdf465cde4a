"""Gathering of Python objects across ranks (counterpart of the JAX
package's `parallel/host_gather.py`): the evaluator's per-rank predictions,
its shared results, the trainer's checkpoint agreement. Each object is
pickled by `torch.distributed.all_gather_object`, which moves the bytes as
CPU tensors under gloo and as tensors on the rank's card under NCCL."""
from __future__ import annotations

from typing import Any, List

import torch.distributed as dist

from .dist import is_main_process, world_size

__all__ = ["all_gather_objects", "is_main_process"]


def all_gather_objects(obj: Any) -> List[Any]:
    """[obj of rank 0, obj of rank 1, ...]; [obj] without a group."""
    n = world_size()
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj)
    return out
