"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with `ctypes`. Libraries go to `build/nopesac_torch/<hash>/` at the repo root,
keyed by a hash of the sources and flags, and are built at first use. All
missing libraries are compiled in parallel, one `nvcc` process per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "nopesac_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
            "nopesac_torch are built from source at first use")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing library, all `nvcc` processes at once.
    Returns the wall seconds spent. Raises with the compiler's output on
    failure."""
    nvcc = _nvcc()
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{log}")
            continue
        if log.strip():
            print(f"[nvcc {src.name}]\n{log.strip()}")
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        path = _build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _check_result(err, fn, args):
    check(err, fn.__name__)


def entry(lib: str, symbol: str, argtypes: Sequence):
    """The C entry point `symbol` of `csrc/<lib>.cu`, its library loaded (and
    built) on first use, returning a cudaError_t. Its signature is set once,
    on the function pointer that the library's handle keeps (a library
    loaded anew starts afresh), and a call raises through `check` when the
    error is non-zero."""
    fn = getattr(load(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fn.errcheck = _check_result
    return fn


def size(lib: str, symbol: str, *args: int) -> int:
    """What an entry point that returns a count (a scratch buffer's size)
    returns for these ints, asked of the library once per shape. Its
    signature and the counts it gave are kept as `entry` keeps a signature:
    on the function pointer of the library's handle."""
    fn = getattr(load(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype, fn.sizes = [ctypes.c_int] * len(args), ctypes.c_int, {}
    if args not in fn.sizes:
        fn.sizes[args] = fn(*args)
    return fn.sizes[args]


def attributes(lib: str, symbol: str, names: Sequence[str], *args: int) -> dict:
    """A kernel's attributes by name, from an `*_attrs` entry point that takes
    `args` and fills one int per name (cudaFuncGetAttributes and the like),
    for the record of a run on the card."""
    vals = (ctypes.c_int * len(names))()
    entry(lib, symbol, [ctypes.c_int] * len(args) + [ctypes.c_void_p])(*args, vals)
    return dict(zip(names, vals))
