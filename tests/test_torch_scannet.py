"""The ScanNet data path of the port against the JAX package, from raw scans
to an offline evaluation, on synthetic scenes in the ScanNet layout
(`nopesac_torch/tools/synthetic_scans.py`: 480x640 frames, 6-12 planes per
view, 3-7 shared between consecutive frames).

Three scenes: two of the train split (frames every 20) and one of the test
split (frames every 40); the second train scene's first two frames share
only 2 planes, so the generator's correspondence gate rejects that pair.
The test scene is written at the smoke size, 96x128, with 4-5 planes per
view (the generator's 800-pixel plane gates need that few): the evaluator
scores predictions at INPUT.IMAGE_SIZE against the records' masks at their
own size, as the JAX package's does, so evaluating at 96x128 needs 96x128
records, and the eval model must be the 96x128 trainer's (its camera fc
layers depend on the image size).
The port's generator (`python -m nopesac_torch.tools.generate_scannetv2_data`)
and the repo's `tools/generate_scannetv2_data.py` run on the same scans and
must write the same records, `twoView_Anns` pickles and JSON contents (the
port's file is `cached_set_<split>V2.json`, the name the registries read).
The generated splits then load by name, the port's mapper and loader give
the JAX package's samples and batches from them, and the port trains two
steps on them, evaluates `scannet_test` and reads the artifacts offline.
"""
import contextlib
import io
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nopesac_tpu.data import datasets as jax_datasets
from nopesac_tpu.data.loader import PairLoader as JaxPairLoader
from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.packing import unpack_targets_np
from tools import generate_scannetv2_data as jax_gen

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data import datasets
from nopesac_torch.data.mapper import PairMapper
from nopesac_torch.data.packing import unpack_targets
from nopesac_torch.data.registry import DatasetCatalog
from nopesac_torch.engine import offline_eval
from nopesac_torch.engine.test import EvalRunner, build_eval_model
from nopesac_torch.engine.trainer import Trainer
from nopesac_torch.tools import generate_scannetv2_data as gen
from nopesac_torch.tools.synthetic_scans import write_scene
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
H, W = 96, 128
NQ = 50
# (scene, frames, frame step, seed, shares between consecutive frames, size,
# planes per view)
SCENES = {"train": [("scene0000_00", 4, 20, 1, None, (480, 640), (6, 12)),
                    ("scene0001_00", 4, 20, 2, [2, 5, 4], (480, 640), (6, 12))],
          "test": [("scene0002_00", 3, 40, 3, None, (H, W), (4, 5))]}
SPLIT_ARGS = {"train": dict(sample_step=20, max_hit_num=1),
              "test": dict(sample_step=40, max_hit_num=2)}


def _run_main(main, argv):
    """A generator's main on `argv`, its printed lines."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = ["generate_scannetv2_data"] + argv
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = saved
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The scans, each split generated by both tools (port: out_port, repo
    tool: out_jax), and their printed lines."""
    base = tmp_path_factory.mktemp("scannet")
    scans = str(base / "scans")
    printed = {}
    for split, scenes in SCENES.items():
        for name, frames, step, seed, shares, size, planes in scenes:
            write_scene(scans, name, frames, step, seed, shares=shares, size=size, planes=planes)
        split_file = str(base / f"{split}.txt")
        with open(split_file, "w") as f:
            f.write("\n".join(s[0] for s in scenes) + "\n")
        for tool, main in (("port", gen.main), ("jax", jax_gen.main)):
            printed[split, tool] = _run_main(main, [
                "--scans-dir", scans, "--output-dir", str(base / f"out_{tool}"),
                "--split", split, "--split-file", split_file])
    yield base, printed
    # the registries' default roots again, for the other tests of this worker
    for name, (_, rel) in datasets.SPLITS.items():
        datasets.register_pair_dataset(name, rel)
        jax_datasets.register_pair_dataset(name, rel)
    shutil.rmtree(base, ignore_errors=True)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _assert_pickles_equal(a_dir, b_dir):
    names = sorted(os.path.relpath(os.path.join(r, f), a_dir)
                   for r, _, fs in os.walk(a_dir) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b_dir)
                           for r, _, fs in os.walk(b_dir) for f in fs)
    for name in names:
        with open(os.path.join(a_dir, name), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(b_dir, name), "rb") as f:
            b = pickle.load(f)
        assert sorted(a) == sorted(b) == ["camera_K", "plane_masks"]
        assert np.array_equal(a["camera_K"], b["camera_K"])
        assert len(a["plane_masks"]) == len(b["plane_masks"]) >= 2
        for ma, mb in zip(a["plane_masks"], b["plane_masks"]):
            assert ma.dtype == mb.dtype == np.uint8 and np.array_equal(ma, mb), name
    return names


@pytest.mark.parametrize("split,scene", [(s, i) for s in SCENES for i in range(len(SCENES[s]))])
def test_scene_pairs_equal_jax(generated, tmp_path, split, scene):
    """`generate_scene_pairs` record for record, and the pickles it writes."""
    base, _ = generated
    name, *_, planes = SCENES[split][scene]
    sp = os.path.join(str(base / "scans"), name)
    ours = gen.generate_scene_pairs(sp, anns_dir=str(tmp_path / "a"), **SPLIT_ARGS[split])
    theirs = jax_gen.generate_scene_pairs(sp, anns_dir=str(tmp_path / "b"), **SPLIT_ARGS[split])
    assert ours and json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    for rec in ours:
        assert 3 <= len(rec["gt_corrs"]) <= 7
        assert all(3 <= rec[v]["gt_plane_num"] <= planes[1] for v in ("0", "1"))
        assert all(isinstance(a["segmentation"], list) for v in ("0", "1")
                   for a in rec[v]["annotations"])  # polygons: OpenCV imports here
    pairs = [(r["0"]["image_id"], r["1"]["image_id"]) for r in ours]
    if name == "scene0001_00":  # frames 0 and 20 share 2 planes: the gate rejects them
        assert not {(f"{name}-0", f"{name}-20"), (f"{name}-20", f"{name}-0")} & set(pairs)
    if split == "test":  # each frame in up to two pairs: both orders
        assert (pairs[0][1], pairs[0][0]) in pairs
    _assert_pickles_equal(str(tmp_path / "a"), str(tmp_path / "b"))


@pytest.mark.parametrize("split", list(SCENES))
def test_main_writes_the_jax_tools_json_under_the_registry_name(generated, split):
    base, printed = generated
    ours = _read_json(str(base / "out_port" / "scannet_json" / f"cached_set_{split}V2.json"))
    theirs = _read_json(str(base / "out_jax" / "scannet_json" / f"cached_set_{split}.json"))
    assert ours == theirs and ours["data"]
    assert not os.path.exists(base / "out_port" / "scannet_json" / f"cached_set_{split}.json")
    # the printed statistics, but for the file each names last
    port, jax_lines = printed[split, "port"], printed[split, "jax"]
    assert port[:-1] == jax_lines[:-1] and any(line.startswith("Accuracy") for line in port)
    assert port[-1].endswith(f"cached_set_{split}V2.json")
    names = _assert_pickles_equal(str(base / "out_port" / "twoView_Anns"),
                                  str(base / "out_jax" / "twoView_Anns"))
    assert len(names) >= 2


def test_generator_cli_writes_what_main_writes(generated, tmp_path):
    """`python -m nopesac_torch.tools.generate_scannetv2_data`, as a user
    runs it."""
    base, printed = generated
    proc = subprocess.run(
        [sys.executable, "-m", "nopesac_torch.tools.generate_scannetv2_data",
         "--scans-dir", str(base / "scans"), "--output-dir", str(tmp_path), "--split", "test",
         "--split-file", str(base / "test.txt")],
        cwd=REPO, env=SUBPROCESS_ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[:-1] == printed["test", "port"][:-1]
    name = os.path.join("scannet_json", "cached_set_testV2.json")
    assert _read_json(str(tmp_path / name)) == _read_json(str(base / "out_port" / name))


@pytest.fixture(scope="module")
def registered(generated):
    base, _ = generated
    root = str(base / "out_port")
    datasets.register_builtin(root)
    jax_datasets.register_builtin(root)
    return root


def _unpacked(sample):
    """A mapper sample or a batch with its targets unpacked to plain arrays:
    the port's through its torch unpacking, numpy otherwise."""
    out = {}
    for k, v in sample.items():
        if k.startswith("targets"):
            if isinstance(v["gt_masks_packed"], torch.Tensor):
                v = {t: a.numpy() for t, a in unpack_targets(v).items()}
            else:
                v = unpack_targets_np(v)
        out[k] = v
    return out


def _assert_samples_equal(ours, theirs):
    ours, theirs = _unpacked(ours), _unpacked(theirs)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if k == "meta":
            assert ours[k] == theirs[k]
        elif isinstance(ours[k], dict):
            assert sorted(ours[k]) == sorted(theirs[k])
            for t in ours[k]:
                a, b = ours[k][t], theirs[k][t]
                assert a.shape == b.shape and a.dtype == b.dtype, (k, t)
                if t == "depth":
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=t)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{k}.{t}")
        else:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _torch_targets(sample):
    return {k: ({t: torch.from_numpy(np.array(a)) for t, a in v.items()}
                if k.startswith("targets") else v) for k, v in sample.items()}


@pytest.mark.parametrize("is_train", [True, False])
def test_generated_split_loads_by_name_and_maps_like_jax(registered, is_train):
    """`scannet_train` / `scannet_test` are the generated files' records; the
    ScanNet mapper gives the JAX mapper's samples from them (the masks from
    the generator's pickles, depth from its png)."""
    for split in ("train", "test"):
        records = DatasetCatalog.get(f"scannet_{split}")
        assert records == _read_json(os.path.join(
            registered, "scannet_json", f"cached_set_{split}V2.json"))["data"]
        assert jax_datasets.DatasetCatalog.get(f"scannet_{split}") == records
        ours = PairMapper(NQ, (H, W), is_train=is_train, eval_gt_box=True, root_dir=registered,
                          dataset_kind="scannet")
        theirs = JaxPairMapper(is_train=is_train, eval_gt_box=True, dataset_kind="scannet",
                               root_dir=registered, num_queries=NQ, image_size=(H, W),
                               raw_uint8=not is_train)
        for rec in records:
            a, b = ours(rec), theirs(rec)
            t = a["targets0"]
            n = int(t["gt_valid"].sum())
            assert n == rec["0"]["gt_plane_num"] and t["depth"].min() > 0.3  # from the files
            _assert_samples_equal(_torch_targets(a), b)


def _cfg(out_dir, root, opts=()):
    """smoke_synthetic.yaml (camera and matching losses on) on the generated
    ScanNet splits."""
    cfg = get_cfg()
    cfg.merge_from_file(SMOKE)
    cfg.merge_from_list(["INPUT.IMAGE_SIZE", f"({H}, {W})", "OUTPUT_DIR", out_dir,
                         "DATASETS.TRAIN", '("scannet_train",)',
                         "DATASETS.TEST", '("scannet_test",)', "DATASETS.ROOT_DIR", root,
                         "SOLVER.MAX_ITER", "2", "TEST.PRECISE_BN.ENABLED", "False",
                         "TEST.EVAL_FULL_SCENE", "True", *opts])
    cfg.freeze()
    return cfg


def test_scannet_slice_on_cpu(registered, tmp_path):
    """The port's loader gives the JAX loader's first batch from the
    generated split; `Trainer` takes 2 steps on it (every loss finite, none
    skipped) and saves; `EvalRunner` evaluates `scannet_test` from the saved
    weights and writes the artifacts, which the offline evaluator reads."""
    out_dir = str(tmp_path / "train")
    cfg = _cfg(out_dir, registered)
    assert cfg.MODEL.CAMERA_ON and cfg.MODEL.EMBEDDING_ON and cfg.MODEL.CAMERA_HEAD.REFINE_ON
    trainer = Trainer(cfg, device="cpu")
    it = iter(trainer.loader)
    ours = next(it)
    it.close()
    jax_loader = JaxPairLoader(
        jax_datasets.DatasetCatalog.get("scannet_train"),
        JaxPairMapper(is_train=True, dataset_kind="scannet", root_dir=registered,
                      num_queries=NQ, image_size=(H, W), seed=cfg.SEED),
        batch_size=cfg.SOLVER.IMS_PER_BATCH, shuffle=True, drop_last=True, seed=cfg.SEED,
        infinite=True)
    it = iter(jax_loader)
    theirs = next(it)
    it.close()
    assert len(ours["meta"]) == cfg.SOLVER.IMS_PER_BATCH
    _assert_samples_equal(_torch_targets(ours), theirs)

    try:
        trainer.train()
    finally:
        trainer.close()
    with open(os.path.join(out_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["iteration"] for r in rows] == [0, 1]
    for r in rows:
        losses = {k: v for k, v in r.items() if k.startswith("loss")}
        assert "loss_rot_pixelReg" in losses and "losses_emb_0" in losses
        assert all(np.isfinite(v) for v in losses.values()) and r["skipped_nonfinite"] == 0
    final = os.path.join(out_dir, "model_final.pth")
    assert os.path.exists(final)
    del trainer

    eval_dir = str(tmp_path / "eval")
    ecfg = _cfg(eval_dir, registered, ["MODEL.WEIGHTS", final])
    runner = EvalRunner(ecfg, build_eval_model(ecfg, device="cpu"))
    results = runner.test()
    n_test = len(DatasetCatalog.get("scannet_test"))
    assert runner.last_eval_stats["pairs"] == n_test
    assert all(np.isfinite(v) for v in results.values())
    shutil.rmtree(out_dir)  # the checkpoint (model and AdamW moments) is ~0.9 GB
    pth = os.path.join(eval_dir, "NopeSAC_instances_predictions.pth")
    opt = os.path.join(eval_dir, "continuous.pkl")
    assert os.path.exists(pth) and os.path.exists(opt)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = offline_eval.cli(["--rcnn-cached-file", pth, "--optimized-dict-path", opt,
                               "--evaluate", "camera", "--dataset-phase", "scannet_test"])
    assert rc == 0
    lines = printed.getvalue().splitlines()
    med = [line for line in lines if line.startswith("Median Error [tran, rot]:")]
    assert len(med) == 1
    assert all(np.isfinite(float(x)) for x in med[0].split(":")[1].split(","))
