"""One run of one cell: the context a driver works in, and the result line.

A driver (`cardbench/drivers/<name>.py`) exposes `run(ctx)`. It builds the
program and its inputs from the seed, warms up every shape the window
uses, calls `ctx.mark_setup()`, measures for `ctx.seconds`, calls
`ctx.close_window()` (which reads the memory peak), frees the program's
state and checks what the window produced against the reference
(`ctx.check`). With `ctx.trace` it then records spans and one profiled
unit for the per-layer readers (`cardbench/metrics/<name>.py`), which read
`ctx.record`."""
from __future__ import annotations

import copy
import gc
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import cells as cells_mod
from .spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "nopesac_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that a run must not load, each compared
    whole (the part before the first dot)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _set_path(tree: dict, dotted: str, value) -> None:
    node = tree
    *head, last = dotted.split(".")
    for k in head:
        node = node[k]
    if last not in node:
        raise KeyError(f"no config key {dotted}")
    node[last] = value


class Run:
    """What a driver needs: the cell's data, the seed, the clock, the
    program's configuration and weights, the spans and the record."""

    def __init__(self, cell: cells_mod.Cell, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda", overrides: Optional[Dict] = None,
                 traffic_overrides: Optional[Dict] = None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.tree = copy.deepcopy(cell.config["cfg"])
        for key, value in (overrides or {}).items():
            _set_path(self.tree, key, value)
        self.traffic = dict(cell.traffic, **(traffic_overrides or {}))
        self.spans = Spans(cuda=self.cuda)
        self.record: Dict = {}
        self.e2e: Dict[str, float] = {}
        self.checks: List[Tuple[str, float, float]] = []
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.memory_peak = 0
        self._setup_peak = 0
        self.stamps: List[Tuple[str, float]] = []

    # -- seeds ----------------------------------------------------------
    def rng(self, stream: int) -> np.random.Generator:
        """A numpy generator of the run's seed and a stream number."""
        return np.random.default_rng([self.seed % 2**64, stream])

    def torch_seed(self, stream: int) -> int:
        return int(np.random.SeedSequence([self.seed % 2**64, stream]).generate_state(1)[0])

    # -- the program ----------------------------------------------------
    def program_cfg(self):
        from nopesac_torch.config.config import get_cfg

        cfg = get_cfg()
        cfg._merge_dict(copy.deepcopy(self.tree))
        # where the evaluator writes its log: inside the checkout's build tree
        cfg.OUTPUT_DIR = str(cells_mod.ROOT / "build" / "cardbench" / "output" / self.cell.name)
        cfg.freeze()
        return cfg

    def ref_cfg(self):
        from ..reference.build import Cfg

        return Cfg(self.tree)

    def params(self) -> Dict[str, torch.Tensor]:
        """The configuration's weights on the device, drawn from its
        `weights_seed` and named by the reference's model (built on the meta
        device, so it costs no memory)."""
        from ..reference.build import build_model
        from .weights import param_specs, seeded_params

        with torch.device("meta"):
            specs = param_specs(build_model(self.ref_cfg()))
        return seeded_params(specs, int(self.cell.config["weights_seed"]), self.device)

    def program_model(self, cfg, train: bool):
        """The program's model of `cfg` with the run's weights, built on the
        device (its modules' default init runs there, then is overwritten)."""
        from nopesac_torch.engine.predict import build_model_from_cfg
        from .weights import load_params

        with torch.device(self.device):
            model = build_model_from_cfg(cfg, device=self.device)
        load_params(model, self.params())
        return model.train() if train else model

    def reference_model(self, train: bool):
        from ..reference.build import build_model, set_precision
        from .weights import load_params

        set_precision()
        with torch.device(self.device):
            model = build_model(self.ref_cfg())
        load_params(model, self.params())
        return model.train() if train else model

    # -- the clock ------------------------------------------------------
    def synchronize(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def stamp(self, what: str) -> None:
        """Note how far set-up has come (seconds since the process began)."""
        self.synchronize()
        self.stamps.append((what, time.perf_counter() - self.t_start))

    def mark_setup(self) -> None:
        self.stamp("warm-up")
        self.setup_s = time.perf_counter() - self.t_start
        if self.cuda:
            self._setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def close_window(self) -> int:
        """Synchronise and read the window's memory peak (bytes); the
        device's peak is the larger of it and set-up's."""
        self.synchronize()
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.memory_peak = max(self.memory_peak, self._setup_peak, peak)
        return peak

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit: Optional[float] = None) -> None:
        """One compared number beside its limit (the cell's own by name)."""
        limit = self.cell.limits[name] if limit is None else limit
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(np.isfinite(v) and v <= lim for _, v, lim in self.checks)


def execute(run: Run) -> Dict:
    """Drive the cell and assemble the result (without printing it)."""
    driver = cells_mod.load_module("drivers", run.cell.driver)
    driver.run(run)
    if run.trace:
        metrics = {}
        for m in run.cell.per_layer:
            value = cells_mod.load_module("metrics", m["name"]).read(run.record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for m in run.cell.end_to_end:
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
    return {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "compared": run.checks}


def result_line(run: Run, result: Dict) -> str:
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device}
    tr = run.record.get("trace")
    if run.trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["top_device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in result["compared"]}
    return json.dumps(line)
