"""CPU thread budget of the port's tests.

The tier-1 run puts six pytest workers on the machine. torch's default of
one OpenMP thread per core in each of them oversubscribes the cores about
six times over, and the threads' spin-waits then slow the torch-heavy tests
by an order of magnitude (three of the port's test files on three workers
took 393 s with the default and 52 s with two threads each). Each port test
module that runs torch on the CPU imports the fixture below; CLI tests pass
SUBPROCESS_ENV to their subprocess.
"""
import os

import pytest
import torch

THREADS = 2
SUBPROCESS_ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                  "OMP_NUM_THREADS": str(THREADS)}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, THREADS))
    yield
    torch.set_num_threads(before)
