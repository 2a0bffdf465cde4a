"""The evaluation entry point as `--eval-only` runs it: a closed loop with
one caller, `EvalRunner.test(split)` (the mapper, the eval step, the
one-deep pipeline, the host fetch, the postprocess, `MP3DEvaluator`) on
consecutive synthetic splits drawn at set-up from a pool of seeded scenes,
until the first split that ends after the window's seconds.

Traffic parameters: `pool_pairs` distinct scenes of `planes` planes per
view, splits of `split_pairs`, a warm-up split of `warmup_pairs`, and
`check_batches` batches of the window (a seeded sample) held to the
reference afterwards."""
from __future__ import annotations

import time

from cardbench.harness import evalcheck, scenes
from cardbench.harness.bounds import Bounds
from cardbench.harness.capture import Sample
from cardbench.harness.tracing import TraceWindow


def run(ctx) -> None:
    from nopesac_torch.engine import test as entry
    from nopesac_torch.evaluation.evaluator import MP3DEvaluator
    from nopesac_torch.models import matching_head, nopesac

    tr = ctx.traffic
    ctx.stamp("imports")
    cfg = ctx.program_cfg()
    h, w = cfg.INPUT.IMAGE_SIZE
    model = ctx.program_model(cfg, train=False)
    ctx.stamp("model")
    runner = entry.EvalRunner(cfg, model)
    pool = scenes.pool(ctx.rng(1), tr["pool_pairs"], tr["planes"], h, w)
    ctx.stamp("scenes")
    split_rng = ctx.rng(2)
    sample = Sample(tr["check_batches"], ctx.rng(3))

    # what the evaluator is handed: the fetched inference dict (numpy) of a
    # batch, then the pairs and the records it accumulates for them
    post_fn, process_fn = entry.postprocess_batch, MP3DEvaluator.process
    last, processed = {}, [0]

    def postprocess_batch(out, metas, **kwargs):
        last["out"] = out
        return post_fn(out, metas, **kwargs)

    def process(self, inputs, outputs):
        process_fn(self, inputs, outputs)
        processed[0] += len(inputs) if sample.active else 0
        sample.offer((list(inputs), last.pop("out"), self._predictions[-len(inputs):]))

    entry.postprocess_batch = postprocess_batch
    MP3DEvaluator.process = process
    bounds = Bounds()
    try:
        if ctx.trace:
            ctx.spans.wrap(model.backbone, "forward", "backbone")
            ctx.spans.wrap(model.matching_head, "forward", "matching_head")
            ctx.spans.wrap(entry, "postprocess_batch", "postprocess", device=False)
            ctx.spans.wrap(MP3DEvaluator, "process", "evaluator", device=False)
            bounds.select(nopesac)
            bounds.sinkhorn(matching_head)
        uid = 0

        def next_split(n):
            nonlocal uid
            split = scenes.split(split_rng, pool, n, uid)
            uid += n
            return split

        runner.test(next_split(tr["warmup_pairs"]))
        ctx.mark_setup()

        sample.active = True
        ctx.spans.collect = ctx.trace
        pairs = 0
        t0 = time.perf_counter()
        while True:
            split = next_split(tr["split_pairs"])
            runner.test(split)
            pairs += len(split)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        wall = time.perf_counter() - t0
        ctx.close_window()
        sample.active = False
        ctx.spans.collect = False
        ctx.attempted, ctx.failed = pairs, pairs - processed[0]
        ctx.e2e["eval_pairs_per_s"] = pairs / wall
        bs = int(cfg.TEST.IMS_PER_BATCH)
        ctx.record.update(window_s=wall, pairs=pairs, batches=pairs // bs,
                          pair_flops=ctx.cell.config["flops"]["eval_per_pair"],
                          peak_flop_per_s=ctx.cell.config["flops"]["peak_flop_per_s"])
        if ctx.trace:
            ctx.record["spans"] = {k: {"device_ms": v, "calls": ctx.spans.calls[k]}
                                   for k, v in ctx.spans.device_ms().items()}
            ctx.record["host_ms"] = {k: v * 1e3 for k, v in ctx.spans.host_s.items()}
            split = next_split(tr["split_pairs"])
            bounds.capture = True
            with TraceWindow() as tw:
                runner.test(split)
            bounds.capture = False
            ctx.record["trace"] = dict(tw.summary, batches=len(split) // bs)
            ctx.record["bounds"] = bounds.settle()
    finally:
        bounds.unwrap()
        ctx.spans.unwrap()
        entry.postprocess_batch = post_fn
        MP3DEvaluator.process = process_fn
    del runner, model
    ctx.free()
    check(ctx, sample.items)


def check(ctx, items) -> None:
    """Every sampled batch's inference dict and the evaluator's records of
    its pairs against the reference's on the same images."""
    ref = ctx.reference_model(train=False)
    refs = evalcheck.reference_outputs(ctx, ref, [pairs for pairs, _, _ in items])
    rows, recs = [], []
    for (pairs, out, records), r in zip(items, refs):
        rows.append(evalcheck.gaps(out, r))
        recs.append(evalcheck.record_gaps(records, r))
    for name, value in evalcheck.worst(rows).items():
        ctx.check(name, value)
    for name, value in evalcheck.worst(recs).items():
        ctx.check("evaluator." + name, value)
