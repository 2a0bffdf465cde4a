"""`engine/profile.py:host_waits` on a CPU profile: each chosen call summed by
the innermost StageTimer stage around it, per batch. (The waiting CUDA
runtime calls it sums on the card do not occur on the CPU, so CPU ops stand
in for them.)"""
import pytest
import torch

from nopesac_torch.engine.profile import SPAN, host_waits
from nopesac_torch.losses.hungarian import pad_and_sanitize
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)


def test_host_waits_by_stage():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN + "outer"):
            for _ in range(2):
                with torch.profiler.record_function(SPAN + "inner"):
                    pad_and_sanitize(torch.randn(3, 4, 2))
            torch.randn(3).amax()
    got = host_waits(prof.events(), 2, names=("aten::amax",))
    # pad_and_sanitize takes one amax per call, in "inner"; the loose one is in "outer"
    assert got["calls_per_batch"] == pytest.approx(1.5)
    stages = {d["at"]: d["calls"] for d in got["by_stage"]}
    assert stages == pytest.approx({"inner": 1.0, "outer": 0.5})
    assert got["ms_per_batch"] == pytest.approx(sum(d["ms"] for d in got["by_call"]))
