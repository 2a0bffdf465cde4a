"""The four-rank cell on the CPU: four gloo ranks of the port's `TrainStep`,
started by the port's launcher as on the card, are held to the one-process
reference of the global step (`reference/ranks.py`) within the cell's
limits, at the smoke sizes (96x128, 4 pairs per rank), with their
parameters and buffers equal bit for bit; and each fault, planted in every
rank underneath a run (2 pairs per rank), turns `correct` false: those of
the exchange between ranks (BatchNorm moments of the rank's own slice,
gradients averaged, a rank that keeps its own gradients, every rank on one
random stream) and those of any training cell that this cell's numbers can
see (a state left unchanged, half of the batch left out, no exchange at
all). A loss altered where it is produced is not among them: doubling
`loss_ce`, as `test_cardbench_faults.py` plants in the one-card cell, moves
the median leaf's gradient by 8e-5 at these sizes, and doubling every
detection loss by 6.7e-3, against sound runs' 1.9e-3 on the card (PERF.md);
the one-card cell, which runs the same criterion with a forward bit-equal
to the reference's, is the one that catches it."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from cardbench.harness import cells, runner

from conftest import SMALL

CELL = "train_step3_ddp4"
AGREE = dict(SMALL, **{"SOLVER.IMS_PER_BATCH": 16})
FAULTS = dict(SMALL, **{"SOLVER.IMS_PER_BATCH": 8})
TRAFFIC = {"planes": 4, "trace_steps": 1}


@pytest.fixture
def two_threads():
    """Four ranks share the cores: two threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(overrides, seed=2**31 + 11):
    run = runner.Run(cells.load_cell(CELL), seed, 0.1, False, time.perf_counter(),
                     device="cpu", overrides=overrides, traffic_overrides=TRAFFIC)
    return run, runner.execute(run)


def test_ranks_agree_with_the_global_reference(two_threads):
    run, result = _run(AGREE)
    assert result["correct"], result["compared"]
    assert run.attempted > 0 and run.failed == 0
    compared = {name: value for name, value, _ in result["compared"]}
    assert compared["ranks.param_gap"] == 0.0 and compared["ranks.buffer_gap"] == 0.0
    for name in ("grad_gap.median_leaf", "window.grad_gap.median_leaf"):
        assert compared[name] <= 1e-3, compared


# -- faults, planted in every rank (each runs in a spawned process) --------

def _planted(plant, fn, *args):
    plant()
    return fn(*args)


def _bn_own_slice():
    """The trainable BatchNorms take their moments from the rank's own
    slice."""
    from nopesac_torch.models import layers

    layers.sum_over_ranks = lambda x: x


def _grads_averaged():
    """The gradients averaged over the ranks instead of summed."""
    from nopesac_torch.engine import train
    from nopesac_torch.parallel import dist

    reduce = train.reduce_gradients

    def averaged(params):
        n = reduce(params)
        for p in params:
            p.grad = p.grad / dist.world_size()
        return n

    train.reduce_gradients = averaged


def _one_rank_keeps_its_own():
    """Rank 1 takes part in the gradient all-reduce but keeps its own
    gradients (it skips the reduce)."""
    from nopesac_torch.engine import train
    from nopesac_torch.parallel import dist

    reduce = train.reduce_gradients

    def skipped(params):
        own = [None if p.grad is None else p.grad.clone() for p in params]
        n = reduce(params)
        if dist.rank() == 1:
            for p, g in zip(params, own):
                p.grad = g
        return n

    train.reduce_gradients = skipped


def _streams_unranked():
    """Every rank draws from the step's seed, not seed + rank."""
    from nopesac_torch.engine import train

    init = train.TrainStep.__init__

    def same_stream(self, model, cfg, seed=0):
        init(self, model, cfg, seed=seed)
        self.gen.manual_seed(seed)

    train.TrainStep.__init__ = same_stream


def _state_unchanged():
    """The step returns its state unchanged (no optimizer step)."""
    from nopesac_torch.engine import train

    def no_update(self, finite_total=True):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        return torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])), True

    train.TrainStep.apply_gradients = no_update


def _half_batch():
    """Each rank leaves out half of its slice, the mean taken over the
    rest."""
    from nopesac_torch.engine import train

    forward_backward = train.TrainStep.forward_backward

    def half(self, batch, *args, **kwargs):
        b = batch["image0"].shape[0]
        keep = max(b // 2, 1)

        def cut(v):
            if isinstance(v, dict):
                return {k: cut(x) for k, x in v.items()}
            return v[:keep] if isinstance(v, torch.Tensor) and v.shape[:1] == (b,) else v

        return forward_backward(self, cut(batch), *args, **kwargs)

    train.TrainStep.forward_backward = half


def _exchange_left_out():
    """No gradient all-reduce: each rank steps on its own share."""
    from nopesac_torch.engine import train

    train.reduce_gradients = lambda params: 0


EXCHANGE_FAULTS = (_bn_own_slice, _grads_averaged, _one_rank_keeps_its_own, _streams_unranked)


@pytest.mark.parametrize("plant", EXCHANGE_FAULTS + (_state_unchanged, _half_batch,
                                                     _exchange_left_out))
def test_exchange_faults(plant, two_threads, monkeypatch):
    from nopesac_torch.parallel import dist

    launch = dist.launch

    def planted(fn, *args, **kwargs):
        kwargs["args"] = (plant, fn) + tuple(kwargs.get("args", ()))
        return launch(_planted, *args, **kwargs)

    monkeypatch.setattr(dist, "launch", planted)
    _, result = _run(FAULTS)
    print(json.dumps({"fault": plant.__name__, "compared": result["compared"]}), flush=True)
    assert not result["correct"], result["compared"]


def test_reference_of_ranks_loads_no_program():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1])\n"
            "import cardbench.reference.ranks, cardbench.harness.rankcheck\n"
            "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code, str(cells.ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "nopesac_tpu", "nopesac_torch"}, tops


def test_collectives_reading():
    """NCCL device time, the part of it with no other kernel running, and
    device time by the program's spans, from a made-up trace."""
    from types import SimpleNamespace

    from cardbench.harness import collectives

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def evt(name, start, end, device, eid=0, link=0):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                               device_type=device, id=eid, linked_correlation_id=link)

    events = [evt("nopesac:train.backward", 0, 50, cpu), evt("cudaLaunchKernel", 1, 2, cpu, 7),
              evt("nopesac:train.reduce_gradients", 60, 90, cpu),
              evt("cudaLaunchKernel", 61, 62, cpu, 8),
              evt("sm90_gemm", 10, 70, cuda, link=7),
              evt("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 65, 100, cuda, link=8),
              evt("elementwise", 80, 85, cuda)]
    out = collectives.summarize(events)
    assert out["kernels"] == 1
    assert out["nccl_s"] == pytest.approx(35e-6) and out["exposed_s"] == pytest.approx(25e-6)
    assert out["spans"]["train.backward"] == {"device_s": pytest.approx(60e-6), "nccl_s": 0.0,
                                              "ops": 1}
    assert out["spans"]["train.reduce_gradients"]["nccl_s"] == pytest.approx(35e-6)
