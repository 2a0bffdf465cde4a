"""Ranks, their process group and the launcher (counterpart of the JAX
package's `parallel/mesh.py`).

A rank is one process on one card, the counterpart of one JAX process. The
JAX train step is one global program over a data mesh, so every batch-wide
sum in it (the loss normalisers, the trainable-BN statistics, the skip
guard) runs over the global batch; N ranks compute the same through the
collectives below: `all_reduce_sum` of the normalisers, `share_mean` for the
means over the batch, the synced statistics of `models/layers.py:BatchNorm2d`
and the gradient all-reduce of `engine/train.py`. Without a process group,
or with a group of one rank, every helper here is the identity and calls no
collective.

`launch(fn, num_gpus, ...)` follows detectron2's `launch()`: one spawned
process per local card (`torch.cuda.set_device(local_rank)`), NCCL on
`cuda` and gloo on `cpu` unless `backend` names another. Naming gloo on
`cuda` lets ranks share the visible cards in turn (local rank r on card
r mod count), which NCCL refuses: two ranks on one card. With one rank in
all and no backend named it calls `fn` in this process with no group. A
rank that raises, exits or outlives `timeout_s` makes `launch` raise.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def init(backend: str, init_method: str, world_size: int, rank: int,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: `init_method` is `tcp://host:port` or
    `file://path`; a collective that waits longer than `timeout_s` raises."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, through one all-reduce of their
    f32 concatenation; the tensors themselves at world size 1. For counts
    and normalisers: the result carries no gradient."""
    tensors = list(tensors)
    if world_size() == 1:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape).to(t.dtype))
        k += t.numel()
    return out


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (SUM) whose backward all-reduces the incoming gradient:
    each rank's input feeds every rank's output, so its gradient is the sum
    of every rank's gradient of the output."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiably (a process group of more
    than one rank must be up)."""
    return _SumOverRanks.apply(x)


def share_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the global batch: the sum of
    its own elements over the count of all ranks' (`x.mean()` at world size
    1). The shares of the ranks sum to the global mean, and each is linear
    in its rank's samples, so the gradients summed over the ranks are those
    of the global mean."""
    if world_size() == 1:
        return x.mean()
    (count,) = all_reduce_sum([torch.tensor(float(x.numel()), device=x.device)])
    return x.sum() / count.to(x.dtype)


def all_true(flag: bool, device: torch.device) -> bool:
    """Whether `flag` holds on every rank (an all-reduce of MIN)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor(1 if flag else 0, dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Give every rank rank `src`'s parameters and buffers."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


# ----------------------------------------------------------------- launch

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(local_rank: int, fn: Callable, args: tuple, world: int, num_gpus: int,
            machine_rank: int, backend: str, init_method: str, device: str, out_dir: str,
            timeout_s: float) -> None:
    """The body of one spawned rank: bind the card, join the group, run
    `fn(*args)` and pickle its return value to out_dir/rank{local_rank}.pkl."""
    global_rank = machine_rank * num_gpus + local_rank
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {global_rank}: torch.cuda.is_available() is False")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    init(backend, init_method, world, global_rank, timeout_s)
    try:
        value = fn(*args)
        with open(os.path.join(out_dir, f"rank{local_rank}.pkl"), "wb") as f:
            pickle.dump(value, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, num_gpus: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "auto", device: str = "cuda", backend: Optional[str] = None,
           args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run `fn(*args)` on `num_gpus` ranks of this machine, ranks
    machine_rank * num_gpus ... of num_gpus * num_machines. `fn` must be
    importable by a spawned process. Returns the local ranks' return values
    in rank order ([fn(*args)] when it ran in this process). `dist_url` is
    the group's rendezvous (`tcp://...` or `file://...`); "auto" takes a free
    localhost port, on one machine only. The kernels are built once here,
    before the ranks start."""
    world = num_gpus * num_machines
    if world == 1 and backend is None:
        return [fn(*args)]
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("--dist-url auto serves one machine; name a tcp:// or file:// "
                             "address that every machine reaches")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        visible = torch.cuda.device_count()
        if visible == 0 or (num_gpus > visible and backend != "gloo"):
            raise RuntimeError(f"{num_gpus} ranks over {backend} on cuda requested but "
                               f"{visible} device(s) visible")
        from ..ops._build import build_all

        build_all()
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="nopesac_launch_") as out_dir:
        ctx = mp.start_processes(
            _worker, args=(fn, tuple(args), world, num_gpus, machine_rank, backend, dist_url,
                           device, out_dir, timeout_s),
            nprocs=num_gpus, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5):  # raises when a rank fails
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: the ranks did not finish in {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        values = []
        for r in range(num_gpus):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                values.append(pickle.load(f))
        return values
