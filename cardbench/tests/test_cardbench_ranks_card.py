"""The four-rank cell's control and faults on the card, at the cell's own
size. The reference of the global step (`reference/ranks.py`) with every
bf16 product's operands rounded to fp8 fails at least one of the cell's
limits on three seeds; its readings (`harness/rankcheck.py`'s numbers) and
those of the stated reference against itself, from the same state, are
printed as one JSON line per seed. Each fault of the exchange
(`test_cardbench_ranks.py`), planted in every rank of a run, turns
`correct` false on the same three seeds. With fewer cards than ranks the
ranks share the cards over gloo (NCCL refuses two ranks on one card): the
same program and check, for these readings only."""
from __future__ import annotations

import json
import time

import pytest
import torch

from cardbench.harness import cells, control, rankcheck, runner, traincheck
from cardbench.reference.ranks import global_step

from test_cardbench_ranks import CELL, EXCHANGE_FAULTS, _planted

SEEDS = (2**31 + 1901, 2**31 + 1902, 2**31 + 1903)


def _world(cell):
    world = int(cell.traffic["ranks"])
    return world, int(cell.config["cfg"]["SOLVER"]["IMS_PER_BATCH"]) // world


@pytest.mark.gpu
def test_ranks_control_fails(cuda_card):
    cell = cells.load_cell(CELL)
    world, per_rank = _world(cell)
    for seed in SEEDS:
        run = runner.Run(cell, seed, 0.0, False, time.perf_counter(), device="cuda")
        pairs = traincheck.make_pairs(run)
        step_seed = traincheck.step_seed(run)
        with global_step(world, per_rank):
            with control.fp8_products():
                got = traincheck.reference_steps(run, pairs, step_seed)
            want = traincheck.reference_steps(run, pairs, step_seed, state=got["own"])
            readings, shown = rankcheck.all_gaps(got, want)
            again = traincheck.reference_steps(run, pairs, step_seed, state=got["own"])
            itself, itself_shown = rankcheck.all_gaps(again, want)
        del got, want, again
        run.free()
        print(json.dumps({"cell": CELL, "seed": seed, "control": readings, "control_shown": shown,
                          "reference_against_itself": itself,
                          "reference_against_itself_shown": itself_shown}), flush=True)
        assert any(readings[k] > cell.limits[k] for k in readings if k in cell.limits), readings


@pytest.mark.gpu
@pytest.mark.parametrize("plant", EXCHANGE_FAULTS)
def test_ranks_faults_on_the_card(plant, cuda_card, monkeypatch):
    from nopesac_torch.parallel import dist

    cell = cells.load_cell(CELL)
    world, _ = _world(cell)
    launch = dist.launch

    def planted(fn, *args, **kwargs):
        kwargs["args"] = (plant, fn) + tuple(kwargs.get("args", ()))
        if torch.cuda.device_count() < world:
            kwargs["backend"] = "gloo"
        return launch(_planted, *args, **kwargs)

    monkeypatch.setattr(dist, "launch", planted)
    for seed in SEEDS:
        run = runner.Run(cell, seed, 2.0, False, time.perf_counter(), device="cuda")
        result = runner.execute(run)
        print(json.dumps({"cell": CELL, "fault": plant.__name__, "seed": seed,
                          "compared": result["compared"]}), flush=True)
        assert not result["correct"], result["compared"]
