"""Package rules of the port: it imports torch and never JAX, flax, the
JAX package or the repo's `tools/` (nor PIL, matplotlib, OpenCV or
scipy.ndimage where a module is imported); its
entry points default to CUDA; its config reads the repo's
yaml files like the JAX package's does; its CLIs run on the CPU."""
import json
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import nopesac_torch
from nopesac_tpu.config.config import get_cfg as jax_get_cfg

from nopesac_torch.config.config import get_cfg
from nopesac_torch.utils.device import LAUNCHES, KERNEL_NAMES, resolve_device
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nopesac_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(nopesac_torch.__path__, "nopesac_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"nopesac_torch.engine.predict", "nopesac_torch.ops.select",
            "nopesac_torch.ops.bottleneck", "nopesac_torch.engine.test",
            "nopesac_torch.evaluation.evaluator", "nopesac_torch.evaluation.postprocess",
            "nopesac_torch.evaluation.coco_json", "nopesac_torch.utils.rle",
            "nopesac_torch.core.metrics", "nopesac_torch.data.datasets",
            "nopesac_torch.data.registry", "nopesac_torch.engine.trainer",
            "nopesac_torch.engine.checkpoint", "nopesac_torch.engine.precise_bn",
            "nopesac_torch.data.loader", "nopesac_torch.data.augmentation",
            "nopesac_torch.utils.tb_writer", "nopesac_torch.utils.np_geometry",
            "nopesac_torch.utils.mesh", "nopesac_torch.data.cam_bins",
            "nopesac_torch.models.camera_branch", "nopesac_torch.engine.offline_eval",
            "nopesac_torch.engine.vis", "nopesac_torch.visualization.vis2d",
            "nopesac_torch.tools.generate_scannetv2_data",
            "nopesac_torch.tools.sparseplane_planeloss",
            "nopesac_torch.tools.synthetic_scans"} <= set(mods)
    # nor the image libraries: PIL, matplotlib, OpenCV and scipy.ndimage load
    # inside the functions that use them
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'nopesac_tpu', 'tools', 'PIL', 'matplotlib', 'cv2') or m.startswith('scipy.ndimage'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = SUBPROCESS_ENV
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_file_names_jax_or_the_jax_package():
    pattern = re.compile(r"nopesac_tpu|\bjax\b|\bflax\b")
    hits = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        if pattern.search(line):
                            hits.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_launch_counters_start_at_zero_and_reset():
    assert set(LAUNCHES.snapshot()) == set(KERNEL_NAMES)
    LAUNCHES.bump("sinkhorn")
    assert LAUNCHES["sinkhorn"] >= 1
    LAUNCHES.reset()
    assert all(v == 0 for v in LAUNCHES.snapshot().values())


@pytest.mark.parametrize("config", ["inference_mp3d.yaml", "inference_scannet.yaml",
                                    "smoke_synthetic.yaml"])
def test_config_copy_reads_repo_yamls_like_the_jax_package(config):
    ours, theirs = get_cfg(), jax_get_cfg()
    for cfg in (ours, theirs):
        cfg.merge_from_file(os.path.join(REPO, "configs", config))
        cfg.merge_from_list(["TEST.IMS_PER_BATCH", "2"])
    a, b = ours.to_dict(), theirs.to_dict()
    assert a["MODEL"].pop("DEVICE") == "cuda"
    b["MODEL"].pop("DEVICE")
    # the port's own key (B4 on the eval path), off unless a config sets it
    assert a["MODEL"]["RESNETS"].pop("FUSE_TAIL") is False
    assert a == b


def test_predict_cli_on_cpu():
    env = SUBPROCESS_ENV
    proc = subprocess.run(
        [sys.executable, "-m", "nopesac_torch.engine.predict",
         "--config-file", os.path.join(REPO, "configs", "inference_mp3d.yaml"),
         "--pairs", "3", "--seed", "1", "--device", "cpu",
         "INPUT.IMAGE_SIZE", "(64, 96)", "TEST.IMS_PER_BATCH", "2",
         "MODEL.MATCHING_HEAD.SINKHORN_ITERS", "5"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    pairs = [r for r in rows if "pair" in r]
    assert [r["pair"] for r in pairs] == [0, 1, 2]
    assert all(len(r["rot"]) == 4 and abs(sum(x * x for x in r["rot"]) - 1) < 1e-4
               for r in pairs)
    assert [r["pairs"] for r in rows if "batch" in r] == [2, 1]


def test_train_cli_on_cpu():
    env = SUBPROCESS_ENV
    proc = subprocess.run(
        [sys.executable, "-m", "nopesac_torch.engine.train",
         "--config-file", os.path.join(REPO, "configs", "smoke_synthetic.yaml"),
         "--device", "cpu", "--steps", "2", "--seed", "1", "INPUT.IMAGE_SIZE", "(64, 96)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert r["skipped_nonfinite"] == 0 and r["device"] == "cpu"
        assert np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
        assert "losses_emb_0" in r["losses"] and "loss_mask_1" in r["losses"]
