"""`nopesac_torch/utils/trace.py` and the spans the port opens with it: the
recorder's nesting, parents and self time, threads, the null path when
tracing is off, profiler ranges, the spans of `EvalRunner.test` and of one
`TrainStep` at 96x128, the batch copy's counters, and results bit-equal with
tracing on and off."""
import os
import threading
import time

import numpy as np
import pytest
import torch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.mapper import PairMapper, collate
from nopesac_torch.data.packing import batch_to_device
from nopesac_torch.data.synthetic import make_pair
from nopesac_torch.engine import test as entry
from nopesac_torch.engine.test import EvalRunner, build_eval_model
from nopesac_torch.engine.train import TrainStep, build_train_model
from nopesac_torch.utils import trace
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_synthetic.yaml")


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _rows():
    return {(r["name"], r["parent"]): r for r in trace.snapshot()["spans"]}


def _calls():
    return {k: v["calls"] for k, v in trace.by_name(trace.snapshot()).items()}


def test_nesting_parents_and_self_time():
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with trace.span("inner"):
                time.sleep(0.001)
    with trace.span("inner"):
        pass
    trace.count("copies")
    trace.count("bytes", 12)
    trace.count("bytes", 30)
    trace.disable()
    rows = _rows()
    assert set(rows) == {("outer", None), ("inner", "outer"), ("inner", None)}
    outer, inner = rows[("outer", None)], rows[("inner", "outer")]
    assert outer["calls"] == 1 and inner["calls"] == 2 and rows[("inner", None)]["calls"] == 1
    assert inner["host_ms"] >= 2.0 and outer["host_ms"] >= 4.0
    assert inner["self_ms"] == inner["host_ms"]  # no children
    assert outer["self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"], abs=1e-9)
    assert trace.snapshot()["counts"] == {"copies": 1, "bytes": 42}
    assert trace.by_name(trace.snapshot())["inner"]["calls"] == 3


def test_second_thread_has_its_own_parents():
    def work():
        with trace.span("worker"):
            pass

    trace.enable()
    with trace.span("main"):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    rows = _rows()
    assert set(rows) == {("main", None), ("worker", None)}
    # the worker's time is not a child of the main thread's span
    assert rows[("main", None)]["self_ms"] == rows[("main", None)]["host_ms"]


def test_off_is_one_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = trace.span("a"), trace.span("b")
    assert first is second
    with first:
        trace.count("n", 5)
    assert trace.snapshot() == {"spans": [], "counts": {}}


def test_profiler_ranges_with_the_recorder_off():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.randn(3).sum()
    names = [e.name for e in prof.events() if e.name.startswith(trace.PREFIX)]
    assert sorted(names) == ["nopesac:inner", "nopesac:outer"]
    assert trace.snapshot()["spans"] == []


def _cfg(tmp_path, test_batch=2):
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TEST.IMS_PER_BATCH = test_batch
    cfg.MODEL.SEM_SEG_HEAD.DROPOUT = 0.0
    cfg.freeze()
    return cfg


def test_eval_runner_spans_and_counts(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    runner = EvalRunner(cfg, build_eval_model(cfg, device="cpu", seed=0))
    outs = []
    post = entry.postprocess_batch

    def keep(out, metas, **kwargs):
        outs.append((out, len(metas)))
        return post(out, metas, **kwargs)

    monkeypatch.setattr(entry, "postprocess_batch", keep)
    trace.enable()
    runner.test()
    trace.disable()
    rows = _rows()
    calls = _calls()
    batches = 2  # synthetic_test's 4 pairs in batches of 2
    for name in ("eval.mapper", "eval.step", "eval.drain", "eval.postprocess", "eval.evaluator",
                 "model.backbone", "model.plane_head", "model.select_planes",
                 "model.pixel_camera", "model.matching_head", "model.matching_gnn",
                 "model.sinkhorn", "model.refine"):
        assert calls[name] == batches, name
    assert calls["eval.test"] == calls["eval.evaluate"] == 1
    assert "eval.fetch_wait" not in calls  # no card: nothing to wait for
    assert rows[("eval.mapper", "eval.test")]["calls"] == batches
    assert rows[("model.backbone", "eval.step")]["calls"] == batches
    assert rows[("model.sinkhorn", "model.matching_head")]["calls"] == batches
    assert rows[("eval.postprocess", "eval.drain")]["calls"] == batches
    assert rows[("eval.evaluate", "eval.test")]["calls"] == 1
    # planes and matches per pair from the arrays the drain held
    pairs = sum(n for _, n in outs)
    planes = sum(o[v]["valid"][:n].sum() for o, n in outs for v in ("view0", "view1"))
    matches = sum(o["assignment"][:n].sum() for o, n in outs)
    stats = runner.last_eval_stats
    assert pairs == 4 and planes > 0
    assert stats["planes_per_view"] == round(planes / (2 * pairs), 3)
    assert stats["matches_per_pair"] == round(float(matches) / pairs, 3)


def _host_batch(cfg, seed):
    h, w = cfg.INPUT.IMAGE_SIZE
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, (h, w), cfg.MODEL.PIXEL_MEAN,
                        cfg.MODEL.PIXEL_STD)
    rng = np.random.default_rng(seed)
    return collate([mapper(make_pair(rng, n_planes=4, h=h, w=w, pair_id=i))
                    for i in range(cfg.SOLVER.IMS_PER_BATCH)])


def _train_once(cfg, host_batch, on: bool):
    model = build_train_model(cfg, device="cpu", seed=0)
    step = TrainStep(model, cfg, seed=0)
    if on:
        trace.enable()
    try:
        metrics = step(batch_to_device(host_batch, "cpu"))
    finally:
        trace.disable()
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_train_step_spans_counters_and_bit_equal(tmp_path):
    cfg = _cfg(tmp_path)
    host_batch = _host_batch(cfg, seed=3)
    got_off, params_off = _train_once(cfg, host_batch, on=False)
    assert trace.snapshot() == {"spans": [], "counts": {}}
    got_on, params_on = _train_once(cfg, host_batch, on=True)

    rows = _rows()
    for name, parent in (("data.batch_to_device", None), ("train.step", None),
                         ("train.forward", "train.step"), ("train.backward", "train.step"),
                         ("train.reduce_gradients", "train.step"),
                         ("train.verdict", "train.step"), ("train.optimizer", "train.step"),
                         ("train.matcher", "train.forward"), ("train.criterion", "train.forward"),
                         ("model.backbone", "train.forward"),
                         ("model.matching_head", "train.forward"),
                         ("model.sinkhorn", "model.matching_head"),
                         ("model.pixel_camera", "train.forward"),
                         ("model.refine", "train.forward")):
        assert rows[(name, parent)]["calls"] == 1, (name, parent)
    n_bytes = sum(a.nbytes for k, v in host_batch.items() if k != "meta"
                  for a in (v.values() if isinstance(v, dict) else [v]))
    n_copies = sum(len(v) if isinstance(v, dict) else 1 for k, v in host_batch.items()
                   if k != "meta")
    assert trace.snapshot()["counts"] == {"data.h2d_bytes": n_bytes, "data.h2d_copies": n_copies}

    assert float(got_on["skipped_nonfinite"]) == 0.0
    assert set(got_on) == set(got_off)
    for k in got_on:
        assert torch.equal(got_on[k], got_off[k]), k
    for k in params_on:
        assert torch.equal(params_on[k], params_off[k]), k


def test_eval_outputs_bit_equal_under_the_profiler(tmp_path):
    cfg = _cfg(tmp_path)
    model = build_eval_model(cfg, device="cpu", seed=0)
    from nopesac_torch.engine.predict import make_eval_step, synthetic_pairs

    h, w = cfg.INPUT.IMAGE_SIZE
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    images = synthetic_pairs(2, h, w, seed=5, device="cpu")
    off = step(*images)
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = step(*images)
    trace.disable()
    assert _calls()["model.refine"] == 1

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        return {prefix: tree}

    a, b = flat(off), flat(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
