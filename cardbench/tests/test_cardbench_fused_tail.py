"""The fused-tail evaluation cell (`drivers/eval_entry_fused.py`,
`harness/fused_tail.py`, `metrics/B4_roofline.py`).

On the CPU at the small sizes: a run is correct with every gap 0 (the
plain tails on both sides), and a run whose program does not fuse is not
(`fused_tail_calls_gap` 24); the configuration's FLOPs; B4's least time by
hand; the marked device time and the reader on made-up profile events. On
the card: the fp8 control fails a limit on every seed, and the reader's
work is the same whether the tails run kernel B4 or its plain version."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch

from cardbench.harness import cells, flops, fused_tail, runner

from conftest import SMALL, SMALL_TRAFFIC

CELL = "eval_entry_bs4_bf16_fused"
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _small(seed, **overrides):
    cell = cells.load_cell(CELL)
    return runner.Run(cell, seed, 0.1, False, time.perf_counter(), device="cpu",
                      overrides=dict(SMALL, **overrides),
                      traffic_overrides=SMALL_TRAFFIC["eval_entry"])


@pytest.mark.parametrize("seed", (5, 2**31 + 1))
def test_fused_cell_agrees_with_the_reference(seed):
    run = _small(seed)
    result = runner.execute(run)
    assert result["correct"], result["compared"]
    assert run.attempted > 0 and run.failed == 0
    assert {name for name, _, _ in result["compared"]} == set(run.cell.limits)
    for name, value, _ in result["compared"]:
        assert value == 0.0, (name, value)


def test_a_run_that_does_not_fuse_is_not_correct():
    result = runner.execute(_small(7, **{"MODEL.RESNETS.FUSE_TAIL": False}))
    compared = {name: value for name, value, _ in result["compared"]}
    assert not result["correct"]
    assert compared["fused_tail_calls_gap"] == fused_tail.CALLS_PER_BATCH == 24


def test_the_configuration_counts_the_eval_flops():
    spec = cells.data_file("configs", "nopesac_mp3d_eval_bf16_fused")
    assert flops.count(spec["cfg"], train=False)["forward"] == spec["flops"]["eval_per_pair"]
    assert spec["cfg"]["MODEL"]["COMPUTE_DTYPE"] == "bfloat16"
    assert spec["cfg"]["MODEL"]["RESNETS"]["FUSE_TAIL"] is True


def test_the_tail_bound_by_hand():
    """res4 conv3 of a batch of 4 pairs: x [8, 256, 30, 40] bf16 to 1024
    channels with the residual: 2 B per element of x, W, the residual and
    y, 8 B per channel of scale and shift; bound by bytes at 3.35 TB/s."""
    n_bytes, n_ops = fused_tail.tail_cost((8, 256, 30, 40), 1024, True, 2)
    p = 30 * 40
    assert n_bytes == 2 * (8 * 256 * p + 1024 * 256 + 2 * 8 * 1024 * p) + 8 * 1024
    assert n_ops == 8 * p * 1024 * (2 * 256 + 4)
    bound = fused_tail.tail_bound_s((8, 256, 30, 40), 1024, True, 2)
    assert bound == max(n_bytes / 3.35e12, n_ops / 989e12)


def _event(start, end, name, launch):
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name=name, id=launch,
                           time_range=SimpleNamespace(start=start, end=end))


def test_marked_device_time_reads_between_the_markers_of_each_launch():
    mark = "spin"
    events = [  # launch 1: two bracketed calls; launch 2: a lost marker; launch 3: none
        _event(0, 1, "conv", 1), _event(1, 2, mark, 1), _event(2, 5, "b4", 1),
        _event(5, 6, mark, 1), _event(6, 8, "conv", 1), _event(8, 9, mark, 1),
        _event(9, 10, "cast", 1), _event(10, 14, "b4", 1), _event(14, 15, mark, 1),
        _event(20, 21, mark, 2), _event(21, 25, "b4", 2),
        _event(30, 40, "b4", 3)]
    got = fused_tail.marked_device_s(events, mark)
    assert got["calls"] == 2 and got["broken"] == 1
    assert got["seconds"] == pytest.approx((3 + 1 + 4) * 1e-6)


def test_the_reader():
    read = cells.load_module("metrics", "B4_roofline").read
    tail = {"seconds": 2e-3, "calls": 48, "broken": 0}
    record = {"trace": {"tail": tail}, "b4": {"calls": 48, "bound_s": 1e-3}}
    assert read(record) == pytest.approx(50.0)
    # a launch left out: the bound of the share of calls found
    assert read({"trace": {"tail": dict(tail, calls=24)},
                 "b4": {"calls": 48, "bound_s": 1e-3}}) == pytest.approx(25.0)
    for record in ({}, {"trace": {}}, {"trace": {"tail": tail}},
                   {"trace": {"tail": tail}, "b4": {"calls": 0, "bound_s": 0.0}},
                   {"trace": {"tail": dict(tail, calls=49)}, "b4": {"calls": 48, "bound_s": 1.0}}):
        assert read(record) is None


@pytest.mark.gpu
def test_control_fails(cuda_card):
    """The reference with every bf16 product's operands, the fused tails'
    included, rounded to fp8 e4m3 fails at least one of the cell's limits
    on each seed; each seed's readings are printed as one JSON line."""
    cell = cells.load_cell(CELL)
    for seed in SEEDS:
        run = runner.Run(cell, seed, 0.0, False, time.perf_counter(), device="cuda")
        readings = fused_tail.control_readings(run, cell.traffic["check_batches"],
                                               int(run.tree["TEST"]["IMS_PER_BATCH"]))
        run.free()
        print(json.dumps({"cell": CELL, "seed": seed, "control": readings}), flush=True)
        assert any(readings[k] > cell.limits[k] for k in readings if k in cell.limits), readings


@pytest.mark.gpu
@pytest.mark.parametrize("tail", ("kernel", "plain"))
def test_the_marked_work_is_the_same_for_either_tail(cuda_card, monkeypatch, tail):
    """The bf16 fused backbone at a batch of 4 pairs, replayed from its CUDA
    graph under the watch with markers: 24 calls per replay found between
    markers, the same bound whichever implements the tail, and a roofline
    share in (0, 100]."""
    from nopesac_torch.models import resnet
    from nopesac_torch.ops import bottleneck
    from nopesac_torch.utils import graphs

    if tail == "plain":
        monkeypatch.setattr(bottleneck, "conv1x1_bn_act_cuda", bottleneck.conv1x1_bn_act_plain)
    run = runner.Run(cells.load_cell(CELL), SEEDS[0], 0.0, True, time.perf_counter(),
                     device="cuda")
    model = run.program_model(run.program_cfg(), train=False)
    watch = fused_tail.TailWatch(marks=True)
    watch.install(resnet)
    try:
        x = torch.randn(8, 3, 480, 640, device=cuda_card)
        with torch.inference_mode():
            for _ in range(3):  # eager, capture, replay
                with graphs.opened(model, x):
                    model.backbone(x)
            with watch.trace_window()() as tw:
                for _ in range(2):
                    with graphs.opened(model, x):
                        model.backbone(x)
    finally:
        watch.unwrap()
        graphs.drop(model)
    record = {"trace": tw.summary, "b4": {"calls": watch.traced_calls,
                                          "bound_s": watch.traced_bound_s}}
    share = cells.load_module("metrics", "B4_roofline").read(record)
    print(json.dumps({"tail": tail, "marked": tw.summary["tail"], "b4": record["b4"],
                      "B4_roofline": share}), flush=True)
    assert watch.captured == 24 and watch.traced_calls == 48
    assert tw.summary["tail"]["calls"] == 48 and tw.summary["tail"]["broken"] == 0
    want = 2 * sum(fused_tail.tail_bound_s(*c) for c in _eval_calls())
    assert watch.traced_bound_s == pytest.approx(want, rel=1e-12)
    assert 0 < share <= 100


def _eval_calls():
    """(x shape, Cout, residual, bytes per element) of the 24 calls of one
    480x640 batch of 4 pairs (8 views)."""
    calls = []
    for (blocks, mid, out), (h, w) in zip(flops.STAGES, ((120, 160), (60, 80), (30, 40),
                                                         (15, 20))):
        for _ in range(blocks - 1):
            calls += [((8, out, h, w), mid, False, 2), ((8, mid, h, w), out, True, 2)]
    return calls
