"""A run's process and the reference load none of JAX, jaxlib, Flax or the
JAX package, and the reference loads nothing of the program; names are
compared by their whole top-level part."""
from __future__ import annotations

import json
import subprocess
import sys

from cardbench.harness import cells, runner

ROOT = str(cells.ROOT)
REFERENCE = ["cardbench.reference.build", "cardbench.harness.control",
             "cardbench.harness.flops", "cardbench.traffic.synthetic"]


def _top_levels(code: str) -> list:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_reference_loads_no_program_and_no_jax():
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r})\n"
            + "".join(f"import {m}\n" for m in REFERENCE)
            + "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))\n")
    tops = _top_levels(code)
    assert not set(tops) & {"jax", "jaxlib", "flax", "nopesac_tpu", "nopesac_torch"}, tops


def test_a_run_loads_no_jax():
    """A whole run of each driver on the CPU at the small sizes."""
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r}); "
            f"sys.path.insert(0, {ROOT + '/cardbench/tests'!r})\n"
            "from conftest import small_run\n"
            "from cardbench.harness import runner\n"
            "for name in ('eval_entry_bs4', 'train_step3_bs16'):\n"
            "    assert runner.execute(small_run(name, seconds=0.1))['correct']\n"
            "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))\n")
    tops = _top_levels(code)
    assert "nopesac_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "nopesac_tpu"}, tops


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "nopesac_tpu_extra", sys)
    assert "jaxfoo" not in runner.forbidden_modules()
    assert "nopesac_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in runner.forbidden_modules()
