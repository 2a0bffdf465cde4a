"""BENCHMARK.json and the files it names: characters, references, and a
cell, a configuration, a traffic mix, a driver and a metric added as files
to a copy are found with no edit."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from cardbench.harness import cells

ROOT = str(cells.ROOT)
BENCH = cells.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and LINE.fullmatch(c["source"])
        assert LINE.fullmatch(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"] == f"cardbench/configs/{c['name']}.json"
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(WORKLOADS) // 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_files_and_metrics(name):
    cell = cells.load_cell(name)
    assert (cells.BENCH_DIR / "drivers" / f"{cell.driver}.py").is_file()
    assert (cells.BENCH_DIR / "configs" / f"{cell.config_name}.json").is_file()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert hasattr(cells.load_module("metrics", m["name"]), "read")
    assert set(cells.data_file("workloads", name)["limits"]) == set(cell.limits)


def test_metric_moves_is_reported_everywhere():
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", WORKLOADS):
            assert m["moves"] in {e["name"] for e in cells.load_cell(w).end_to_end}


def test_names_are_checked():
    for bad in ("../x", "a/b", "", " x", "x" * 65):
        with pytest.raises(ValueError):
            cells.check_name(bad, "test")


DUMMY_DRIVER = '''
def run(ctx):
    ctx.mark_setup()
    ctx.e2e["dummy_rate"] = float(ctx.traffic["rate"])
    ctx.record["dummy"] = 2.5
    ctx.attempted = 1
    ctx.check("dummy_gap", 0.0)
'''
DUMMY_METRIC = '''
def read(record):
    return record.get("dummy")
'''


def test_added_files_are_found(tmp_path):
    """A copy of the benchmark with a configuration, traffic mix, cell,
    driver and metric added as files and entries runs the new cell."""
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "cardbench"), copy / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (copy / "cardbench/configs/dummy_cfg.json").write_text(json.dumps({"cfg": {}}))
    (copy / "cardbench/traffic/dummy_mix.json").write_text(json.dumps({"rate": 3}))
    (copy / "cardbench/workloads/dummy_cell.json").write_text(json.dumps(
        {"config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1, "driver": "dummy_driver",
         "why": "a test", "limits": {"dummy_gap": 0.0}}))
    (copy / "cardbench/drivers/dummy_driver.py").write_text(DUMMY_DRIVER)
    (copy / "cardbench/metrics/dummy.layer_ms.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "cardbench/configs/dummy_cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy_cell"]})
    bench["per_layer"].append({"name": "dummy.layer_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "dummy", "moves": "dummy_rate",
                               "workloads": ["dummy_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time\n"
            f"sys.path.insert(0, {str(copy)!r})\n"
            "from cardbench.harness import cells, runner\n"
            "assert str(cells.ROOT) == sys.path[0]\n"
            "out = {}\n"
            "for trace in (False, True):\n"
            "    run = runner.Run(cells.load_cell('dummy_cell'), 1, 0.1, trace, time.perf_counter(),"
            " device='cpu')\n"
            "    out[trace] = runner.execute(run)\n"
            "print(json.dumps({str(k): v for k, v in out.items()}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["False"]["correct"] and out["False"]["metrics"]["dummy_rate"]["value"] == 3.0
    assert "setup_s" in out["False"]["metrics"]
    assert out["True"]["metrics"] == {"dummy.layer_ms": {"value": 2.5, "unit": "ms"}}
