"""The shipped curriculum train step over `ranks` ranks of one machine, as
`Trainer.train` runs it under the port's `parallel/dist.py:launch`: one
process per card (NCCL on `cuda`, gloo on `cpu`), each holding the same
model and weights and a `TrainStep` seeded with the run's step seed (its
generator: seed + rank), and at each step rank r takes pairs
[r * n, (r + 1) * n) of the ring's batch of SOLVER.IMS_PER_BATCH pairs
(n = SOLVER.IMS_PER_BATCH / ranks), `batch_to_device` on its own card, then
`TrainStep`: its share of the global loss, the synced BatchNorm moments,
the normalisers and the gradients summed over the ranks, the optimizer.

Set-up (from the process's start, so it counts spawning the ranks and
joining the group) drives every rank through the three checked steps of
`drivers/train_step.py`, and rank 0 keeps what the reference follows: the
losses, its first gradients, the parameters before and after, and a host
copy of the state it hands the window. After those steps each rank's
parameters and buffers are held to rank 0's (`ranks.param_gap`,
`ranks.buffer_gap`: broadcast from rank 0).
The window runs steps until rank 0's clock says its seconds are over (over
a gloo group, `harness/ranks.py:Window`); every rank synchronises and meets
the others before it ends. Its first step's state is captured on rank 0, as
in `train_step`. With `--trace 1`, rank 0 records the program's own spans
(`nopesac_torch/utils/trace.py`) over the window and profiles `trace_steps`
steps after it, which every rank takes.

Once every rank has left the window, rank 0 frees the program's state and
runs the reference of the one global step (`reference/ranks.py`) on its
card: its three steps from the run's weights on the ring's whole batches,
each rank's random stream drawn for its slice, and the window's first step
from rank 0's state. The numbers compared are `harness/rankcheck.py`'s.

Traffic parameters: those of `train_step` (`ring_batches`, `planes`,
`trace_steps`) and `ranks`, which divides SOLVER.IMS_PER_BATCH."""
from __future__ import annotations

import contextlib
import sys

from cardbench.harness import rankcheck, ranks, traincheck
from cardbench.harness.collectives import CollectiveTraceWindow
from cardbench.reference.ranks import global_step

CHECKED_STEPS = traincheck.CHECKED_STEPS


def _world(ctx):
    """(ranks, pairs per rank)."""
    world = int(ctx.traffic["ranks"])
    bs = int(ctx.tree["SOLVER"]["IMS_PER_BATCH"])
    if world < 2 or bs % world:
        raise ValueError(f"{bs} pairs per step do not split over {world} ranks")
    return world, bs // world


def run(ctx) -> None:
    """The parent: start the ranks, wait for them, and take rank 0's record
    and every rank's memory peak and state gaps."""
    world, _ = _world(ctx)
    out = ranks.launch(ctx, world)
    found = sorted({name for r in out for name in r["forbidden"]})
    if found:
        raise RuntimeError(f"a rank loaded {', '.join(found)}")
    first = out[0]
    ctx.stamps = first["stamps"]
    ctx.setup_s = first["setup_s"]
    ctx.memory_peak = max(r["memory_peak"] for r in out)
    ctx.attempted, ctx.failed = first["attempted"], first["failed"]
    ctx.e2e.update(first["e2e"])
    ctx.e2e["train_peak_gib"] = max(r["window_peak"] for r in out) / 2**30
    ctx.record.update(first["record"])
    print(f"window: {ctx.record['steps']} steps, {ctx.record['window_s']!r} s, "
          f"{ctx.e2e['train_pairs_per_s']!r} pairs/s", file=sys.stderr, flush=True)
    ctx.checks.extend(first["checks"])
    for name in first["state_gaps"]:
        ctx.check(name, max(r["state_gaps"][name] for r in out))
    if ctx.trace:
        print("rank 0 by span: " + _by_span(ctx.record), file=sys.stderr, flush=True)


def _by_span(record) -> str:
    """The program's `train.*` spans on rank 0: host ms per window step
    (the recorder) and device ms per traced step, NCCL's apart."""
    steps = record.get("steps") or 1
    host = {}
    for row in record.get("program", {}).get("spans", []):
        if row["name"].startswith("train."):
            host[row["name"]] = host.get(row["name"], 0.0) + row["host_ms"] / steps
    tr = record.get("trace", {})
    device = tr.get("collectives", {}).get("spans", {})
    n = tr.get("steps") or 1
    return "; ".join(
        f"{name} host {host.get(name, 0.0):.3f} device "
        f"{1e3 * device.get(name, {}).get('device_s', 0.0) / n:.3f} nccl "
        f"{1e3 * device.get(name, {}).get('nccl_s', 0.0) / n:.3f} ms"
        for name in sorted(set(host) | {k for k in device if k.startswith("train.")}))


def rank_run(ctx) -> dict:
    """One rank's run (see the module's doc); rank 0 returns the record."""
    from nopesac_torch.data.mapper import PairMapper, collate
    from nopesac_torch.data.packing import batch_to_device
    from nopesac_torch.engine import train as train_mod
    from nopesac_torch.parallel import dist

    try:
        from nopesac_torch.utils import trace as program_trace
    except ImportError:
        program_trace = None

    tr = ctx.traffic
    world, per_rank = _world(ctx)
    rank = dist.rank()
    group = ranks.control_group()
    ctx.stamp("imports and group")
    cfg = ctx.program_cfg()
    bs = int(cfg.SOLVER.IMS_PER_BATCH)
    model = ctx.program_model(cfg, train=True)
    step = train_mod.TrainStep(model, cfg, seed=traincheck.step_seed(ctx))
    ctx.stamp("model")
    pairs = traincheck.make_pairs(ctx)
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, tuple(cfg.INPUT.IMAGE_SIZE),
                        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    lo = rank * per_rank
    ring = [collate([mapper(p) for p in pairs[k * bs + lo:k * bs + lo + per_rank]])
            for k in range(tr["ring_batches"])]
    ctx.stamp("scenes")

    lead = rank == 0
    prog = {"start": traincheck.params(model) if lead else None, "losses": []}
    for k in range(CHECKED_STEPS):
        metrics = step(batch_to_device(ring[k], ctx.device))
        prog["losses"].append(float(metrics["total_loss"]))
        if k == 0 and lead:
            prog["grads"] = traincheck.first_gradients(model, step.optimizer)
    state_gaps = ranks.state_gaps(model)
    state = window = None
    if lead:
        state = traincheck.snapshot(model, step.optimizer)
        prog["end"] = state["params"]
        window = traincheck.WindowCapture(state, pin=ctx.cuda)
    recording = ctx.trace and lead and program_trace is not None
    if ctx.trace and lead:
        # the breakdown's idle gaps by phase: the backward is what of
        # `forward_backward` lies outside `forward` and `reduce`
        ctx.spans.wrap(step, "forward_backward", "forward_backward")
        ctx.spans.wrap(model, "train_forward", "forward")
        ctx.spans.wrap(train_mod, "reduce_gradients", "reduce")
        ctx.spans.wrap(step, "apply_gradients", "update")
    ranks.meet(ctx, group)
    ctx.mark_setup()

    if recording:
        program_trace.reset()
        program_trace.enable()
    clock = ranks.Window(ctx.seconds, rank, group)
    steps = skipped = 0
    while clock.more():
        metrics = step(batch_to_device(ring[(CHECKED_STEPS + steps) % len(ring)], ctx.device))
        if steps == 0 and lead:
            window.take(model, step.optimizer, metrics["total_loss"])
        skipped += int(metrics["skipped_nonfinite"])
        steps += 1
    wall = clock.close(ctx)
    if recording:
        program_trace.disable()
    window_peak = ctx.close_window()
    out = {"memory_peak": ctx.memory_peak, "window_peak": window_peak, "state_gaps": state_gaps}
    if lead:
        prog["window"] = window.record()
        out.update(setup_s=ctx.setup_s, attempted=steps, failed=skipped,
                   e2e={"train_pairs_per_s": steps * bs / wall})
        ctx.record.update(window_s=wall, steps=steps, pairs=steps * bs, ranks=world,
                          step_flops=ctx.cell.config["flops"]["train_per_step"],
                          peak_flop_per_s=ctx.cell.config["flops"]["peak_flop_per_s"])
        if recording:
            ctx.record["program"] = program_trace.snapshot()
    if ctx.trace:
        with CollectiveTraceWindow() if lead else contextlib.nullcontext() as traced:
            for i in range(tr["trace_steps"]):
                step(batch_to_device(ring[i % len(ring)], ctx.device))
        if lead:
            ctx.record["trace"] = dict(traced.summary, steps=tr["trace_steps"])
        ranks.meet(ctx, group)
    ctx.spans.unwrap()
    del step, model, ring, window
    ctx.free()
    if lead:
        with global_step(world, per_rank):
            ref = traincheck.reference_steps(ctx, pairs, traincheck.step_seed(ctx), state=state)
        compared, shown = rankcheck.all_gaps(prog, ref)
        print("not compared: " + ", ".join(f"{k} {v!r}" for k, v in shown.items()),
              file=sys.stderr, flush=True)
        for name, value in compared.items():
            ctx.check(name, value)
        out.update(stamps=ctx.stamps, record=ctx.record, checks=ctx.checks)
    return out

