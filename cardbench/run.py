"""Run one cell of the benchmark of `nopesac_torch` once on this machine's
card(s) and print its result as the last line of standard output.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`, `cardbench/workloads/<cell>.json`) names its
configuration, traffic mix and driver. With `--trace 0` the line carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics. Each number
compared with the plain reference is printed beside its limit, last on
standard error and under "compared" in the line. The run exits non-zero,
printing no result, without enough CUDA cards, or when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_THREADS = 4


def _environment() -> None:
    """Caches inside the checkout at fixed paths, and no JAX behind a
    library's back."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host path competes for the cores
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    build = os.path.join(ROOT, "build", "cardbench")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(build, "nv_compute_cache"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)

    import torch
    from cardbench.harness import cells, runner

    torch.set_num_threads(HOST_THREADS)

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, {count} visible",
              file=sys.stderr)
        return 2
    run = runner.Run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    result = runner.execute(run)
    found = runner.forbidden_modules()
    if found:
        print(f"cardbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = runner.result_line(run, result)
    print("set-up: " + ", ".join(f"{what} {t:.3f} s" for what, t in run.stamps), file=sys.stderr)
    for name, value, limit in result["compared"]:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
