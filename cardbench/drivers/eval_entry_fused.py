"""The evaluation entry point with the backbone's identity-block tails fused
(MODEL.RESNETS.FUSE_TAIL, kernel B4): the `eval_entry` driver's closed
loop, window and check, with B4's calls watched at the program's call site
(`harness/fused_tail.py`) and the reference on its plain fused tail.

Beside `eval_entry`'s numbers it compares `fused_tail_calls_gap`: |the
tail's calls per window batch, counted where the device ran them - 24|, so
a run that did not fuse is not correct. With `--trace 1` the traced split
also gives `B4_roofline`'s record: the least time of the calls replayed in
it ("b4") and the device time between their markers (the trace's "tail").
Traffic parameters as `eval_entry`'s."""
from __future__ import annotations

import sys

from cardbench.harness import cells, fused_tail


def run(ctx) -> None:
    from nopesac_torch.models import resnet

    base = cells.load_module("drivers", "eval_entry")
    watch = fused_tail.TailWatch(marks=ctx.trace and ctx.cuda)
    watch.install(resnet)
    mark_setup, close_window, reference_model = (ctx.mark_setup, ctx.close_window,
                                                  ctx.reference_model)

    def window_opens():
        mark_setup()
        watch.counting = True

    def window_closes():
        watch.counting = False
        return close_window()

    ctx.mark_setup, ctx.close_window = window_opens, window_closes
    ctx.reference_model = lambda train: fused_tail.fuse(reference_model(train))
    base.TraceWindow = watch.trace_window()
    try:
        base.run(ctx)
    finally:
        watch.unwrap()
        del ctx.mark_setup, ctx.close_window, ctx.reference_model
    batches = ctx.record["batches"]
    ctx.check("fused_tail_calls_gap", abs(watch.calls / batches - fused_tail.CALLS_PER_BATCH))
    ctx.record["b4"] = {"calls": watch.traced_calls, "bound_s": watch.traced_bound_s}
    print(f"fused tail: {watch.calls} calls over the window's {batches} batches, "
          f"{watch.eager} of them eager; {watch.captured} captured in all; traced "
          f"{watch.traced_calls} replayed, {ctx.record.get('trace', {}).get('tail')}",
          file=sys.stderr)

