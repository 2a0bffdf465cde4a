"""The control of each cell comes out as not correct: the reference one
precision below the configuration's (TF32 for the f32 eval cells, fp8
products for the bf16 train cell), at the cell's own size, on three seeds,
fails at least one of the cell's limits. On the card only (TF32 does not
exist on the CPU); each seed's readings are printed as one JSON line."""
from __future__ import annotations

import json
import time

import pytest

from cardbench.harness import cells, control, runner

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("eval_entry_bs4", "train_step3_bs16"))
def test_control_fails(name, cuda_card):
    cell = cells.load_cell(name)
    for seed in SEEDS:
        run = runner.Run(cell, seed, 0.0, False, time.perf_counter(), device="cuda")
        if cell.driver == "train_step":
            readings = control.train_readings(run)
        else:
            readings = control.eval_readings(run, cell.traffic["check_batches"],
                                             int(run.tree["TEST"]["IMS_PER_BATCH"]))
        run.free()
        print(json.dumps({"cell": name, "seed": seed, "control": readings}), flush=True)
        assert any(readings[k] > cell.limits[k] for k in readings if k in cell.limits), readings
