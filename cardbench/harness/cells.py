"""The benchmark's data: `BENCHMARK.json` at the root of the checkout and,
found by name under `cardbench/`, each cell's file (`workloads/<name>.json`),
its configuration (`configs/<name>.json`), its traffic mix
(`traffic/<name>.json`), its driver (`drivers/<name>.py`) and each per-layer
metric's reader (`metrics/<name>.py`). Adding a cell, a configuration or a
metric adds files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str, what: str) -> str:
    """`name` as a file name under `cardbench/`, or ValueError: only the
    characters a benchmark name may have, so it can name no other path."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a benchmark name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def data_file(kind: str, name: str) -> dict:
    """`cardbench/<kind>/<name>.json`."""
    path = BENCH_DIR / kind / f"{check_name(name, kind)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return load_json(path)


def load_module(kind: str, name: str) -> ModuleType:
    """`cardbench/<kind>/<name>.py`, imported under a name of its own (a
    metric's name may hold dots)."""
    path = BENCH_DIR / kind / f"{check_name(name, kind)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"cardbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything its files say."""

    name: str
    chips: int
    driver: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell `name`: its entry in BENCHMARK.json and its files. Its
    end-to-end metrics are those that name it (or name no cells); its
    per-layer metrics those that name it, or name none and move one of its
    end-to-end metrics."""
    bench = bench if bench is not None else benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == check_name(name, "workload")]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    spec = data_file("workloads", name)
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]), driver=check_name(spec["driver"], "driver"),
                config_name=entry["config"], config=data_file("configs", entry["config"]),
                traffic_name=entry["traffic"], traffic=data_file("traffic", entry["traffic"]),
                limits=dict(spec["limits"]), end_to_end=e2e, per_layer=per_layer)
