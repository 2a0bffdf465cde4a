"""The reference agrees with the port on the CPU at the smoke sizes
(96x128), through each driver's own check: the numbers that decide
`correct` read nought to rounding, on two seeds."""
from __future__ import annotations

import pytest

from cardbench.harness import runner

from conftest import small_run

CELLS = ("eval_entry_bs4", "train_step3_bs16")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", (5, 2**31 + 1))
def test_reference_agrees_with_the_port(name, seed):
    run = small_run(name, seed=seed, seconds=0.1)
    result = runner.execute(run)
    assert result["correct"], result["compared"]
    assert run.attempted > 0 and run.failed == 0
    for check, value, limit in result["compared"]:
        assert value <= 1e-5, (check, value)
