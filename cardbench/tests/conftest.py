"""Shared fixtures of the benchmark's CPU tests: small sizes of each cell
(the smoke configuration's 96x128, few Sinkhorn iterations, tiny pools) and
a run of a cell on the CPU."""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"INPUT.IMAGE_SIZE": [96, 128], "MODEL.MATCHING_HEAD.SINKHORN_ITERS": 5,
         "TEST.IMS_PER_BATCH": 2, "SOLVER.IMS_PER_BATCH": 2}
SMALL_TRAFFIC = {
    "eval_entry": {"pool_pairs": 4, "split_pairs": 4, "warmup_pairs": 2, "check_batches": 2,
                   "planes": 4},
    "train_step": {"ring_batches": 3, "planes": 4, "trace_steps": 1},
}


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(4)


def small_run(name: str, seed: int = 2**31 + 11, seconds: float = 0.5):
    """A Run of cell `name` on the CPU at the small sizes."""
    from cardbench.harness import cells, runner

    cell = cells.load_cell(name)
    return runner.Run(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                      overrides=SMALL, traffic_overrides=SMALL_TRAFFIC[cell.driver])


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
