"""A cell over several ranks of one machine: the parent's run starts the
ranks through the port's own launcher (`parallel/dist.py:launch`: one
spawned process per card, NCCL on `cuda`, gloo on `cpu`), each rank builds
a `runner.Run` of the same cell, seed and clock and calls its driver's
`rank_run(ctx)`, and the parent takes what the ranks return.

The ranks agree on when the window ends over a gloo group of their own
(`control_group`): the host broadcasts one flag per step, so no collective
of the harness runs on the card inside the window, where the device trace
reads the program's own."""
from __future__ import annotations

import os
import time
from typing import Dict, List

import torch

from . import cells, runner

LAUNCH_TIMEOUT_S = 300.0  # a rank that waits longer in a collective fails the run


def spec_of(ctx) -> Dict:
    """What a rank needs to build the parent's run again (picklable)."""
    return {"cell": ctx.cell.name, "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "t_start": ctx.t_start, "device": ctx.device.type,
            "tree": ctx.tree, "traffic": ctx.traffic, "threads": torch.get_num_threads()}


def entry(spec: Dict) -> Dict:
    """The body of one spawned rank: the parent's run built again, on this
    rank's card, handed to the driver's `rank_run`."""
    import torch.distributed as tdist

    cores = pin(tdist.get_rank(), tdist.get_world_size())
    torch.set_num_threads(max(1, min(spec["threads"], cores)))
    cell = cells.load_cell(spec["cell"])
    device = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
              else torch.device("cpu"))
    run = runner.Run(cell, spec["seed"], spec["seconds"], spec["trace"], spec["t_start"],
                     device=str(device))
    run.tree, run.traffic = spec["tree"], spec["traffic"]
    out = cells.load_module("drivers", cell.driver).rank_run(run)
    out["forbidden"] = runner.forbidden_modules()
    return out


def pin(rank: int, world: int) -> int:
    """Bind this rank (and the threads it starts from now on) to its own
    share of the cores the process may use, consecutive cores in rank order,
    so that the ranks' host threads neither share nor change cores; the
    number of cores it holds."""
    cores = sorted(os.sched_getaffinity(0))
    share = len(cores) // world
    if share == 0:
        return len(cores)
    os.sched_setaffinity(0, cores[rank * share:(rank + 1) * share])
    return share


def launch(ctx, world: int) -> List[Dict]:
    """Run the cell's driver on `world` ranks; their returns in rank order.
    The launcher is looked up when called, so that a test can wrap it."""
    from nopesac_torch.parallel import dist

    return dist.launch(entry, num_gpus=world, device=ctx.device.type, args=(spec_of(ctx),),
                       timeout_s=LAUNCH_TIMEOUT_S)


def control_group():
    """A gloo group of every rank, for the harness's own host-side
    agreement."""
    import torch.distributed as tdist

    return tdist.new_group(backend="gloo")


class Window:
    """The window's clock, shared by the ranks: rank 0 reads it before each
    step and broadcasts over `group` whether to take the step."""

    def __init__(self, seconds: float, rank: int, group):
        self.seconds = seconds
        self.rank = rank
        self.group = group
        self._go = torch.ones(1, dtype=torch.int32)
        self.t0 = time.perf_counter()

    def more(self) -> bool:
        import torch.distributed as tdist

        if self.rank == 0:
            self._go[0] = int(time.perf_counter() - self.t0 < self.seconds)
        tdist.broadcast(self._go, 0, group=self.group)
        return bool(self._go[0])

    def close(self, ctx) -> float:
        """Every rank synchronises its card, then meets the others; the wall
        since the window began."""
        meet(ctx, self.group)
        return time.perf_counter() - self.t0


def meet(ctx, group) -> None:
    """Synchronise this rank's card, then wait for every rank to do so."""
    import torch.distributed as tdist

    ctx.synchronize()
    tdist.barrier(group=group)


def state_gaps(model: torch.nn.Module) -> Dict[str, float]:
    """This rank's state after the checked steps against rank 0's (rank 0
    broadcasts it): "ranks.param_gap" over the trained parameters and
    "ranks.buffer_gap" over the floating buffers (the trainable BatchNorms'
    running statistics among them, which synced moments keep equal). Each
    is the largest |difference|, inf where one side is not finite: 0 where
    the ranks hold the same bits."""
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    return {"ranks.param_gap": _gap(params), "ranks.buffer_gap": _gap(buffers)}


def _gap(tensors: List[torch.Tensor]) -> float:
    import torch.distributed as tdist

    if not tensors:
        return 0.0
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        theirs = flat.clone()
        tdist.broadcast(theirs, 0)
        ok = bool(torch.isfinite(flat).all() and torch.isfinite(theirs).all())
        return float((flat - theirs).abs().max()) if ok else float("inf")
