"""The shipped curriculum train step as `Trainer.train` runs it between its
hooks: `batch_to_device`, then `TrainStep` (forward, backward, the skip
verdict, AdamW), on a ring of host batches of seeded synthetic pairs made
at set-up. Set-up builds the step and drives it through its first three
steps on three different batches (the warm-up, and what the reference
follows) and keeps a host copy of the state it hands the window; the window
then runs steps until its seconds are over, ending in a synchronise. The
window's first step queues a copy of its parameters and first moments to
pinned host memory, which the reference's step from that state is held to
after the window.

Traffic parameters: `ring_batches` batches of the configuration's
SOLVER.IMS_PER_BATCH pairs with `planes` planes per view (at least three:
the checked steps see rows that all differ), and `trace_steps` steps
profiled after the window in a traced run."""
from __future__ import annotations

import time

from cardbench.harness import traincheck
from cardbench.harness.bounds import Bounds
from cardbench.harness.tracing import TraceWindow

CHECKED_STEPS = traincheck.CHECKED_STEPS


def run(ctx) -> None:
    from nopesac_torch.data.mapper import PairMapper, collate
    from nopesac_torch.data.packing import batch_to_device
    from nopesac_torch.engine import train as train_mod
    from nopesac_torch.losses import criterion

    tr = ctx.traffic
    ctx.stamp("imports")
    cfg = ctx.program_cfg()
    bs = int(cfg.SOLVER.IMS_PER_BATCH)
    model = ctx.program_model(cfg, train=True)
    step = train_mod.TrainStep(model, cfg, seed=traincheck.step_seed(ctx))
    ctx.stamp("model")
    pairs = traincheck.make_pairs(ctx)
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, tuple(cfg.INPUT.IMAGE_SIZE),
                        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    ring = [collate([mapper(p) for p in pairs[k * bs:(k + 1) * bs]])
            for k in range(tr["ring_batches"])]
    ctx.stamp("scenes")

    bounds = Bounds()
    try:
        if ctx.trace:
            ctx.spans.wrap(model, "train_forward", "forward")
            bounds.mask_loss(criterion)
        prog = {"start": traincheck.params(model), "losses": []}
        for k in range(CHECKED_STEPS):
            metrics = step(batch_to_device(ring[k], ctx.device))
            prog["losses"].append(float(metrics["total_loss"]))
            if k == 0:
                prog["grads"] = traincheck.first_gradients(model, step.optimizer)
        state = traincheck.snapshot(model, step.optimizer)
        prog["end"] = state["params"]
        window = traincheck.WindowCapture(state, pin=ctx.cuda)
        ctx.mark_setup()

        ctx.spans.collect = ctx.trace
        steps = skipped = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            metrics = step(batch_to_device(ring[(CHECKED_STEPS + steps) % len(ring)], ctx.device))
            if steps == 0:
                window.take(model, step.optimizer, metrics["total_loss"])
            skipped += int(metrics["skipped_nonfinite"])
            steps += 1
        ctx.synchronize()
        wall = time.perf_counter() - t0
        peak = ctx.close_window()
        prog["window"] = window.record()
        ctx.spans.collect = False
        ctx.attempted, ctx.failed = steps, skipped
        ctx.e2e["train_pairs_per_s"] = steps * bs / wall
        ctx.e2e["train_peak_gib"] = peak / 2**30
        ctx.record.update(window_s=wall, steps=steps, pairs=steps * bs,
                          step_flops=ctx.cell.config["flops"]["train_per_step"],
                          peak_flop_per_s=ctx.cell.config["flops"]["peak_flop_per_s"])
        if ctx.trace:
            ctx.record["spans"] = {k: {"device_ms": v, "calls": ctx.spans.calls[k]}
                                   for k, v in ctx.spans.device_ms().items()}
            bounds.capture = True
            with TraceWindow() as tw:
                for i in range(tr["trace_steps"]):
                    step(batch_to_device(ring[i % len(ring)], ctx.device))
            bounds.capture = False
            ctx.record["trace"] = dict(tw.summary, steps=tr["trace_steps"])
            ctx.record["bounds"] = bounds.settle()
    finally:
        bounds.unwrap()
        ctx.spans.unwrap()
    del step, model, ring, window
    ctx.free()
    check(ctx, prog, pairs, seed=traincheck.step_seed(ctx), state=state)


def check(ctx, prog, pairs, seed: int, state) -> None:
    ref = traincheck.reference_steps(ctx, pairs, seed, state=state)
    for name, value in traincheck.all_gaps(prog, ref).items():
        ctx.check(name, value)
