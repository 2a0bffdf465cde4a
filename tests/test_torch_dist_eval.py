"""Evaluation and the training entry point of the port across two gloo
ranks on the CPU.

One module-scoped launch of `tests/torch_dist_worker.py:eval_rank` (a
`file://` rendezvous under tmp_path) runs, on each rank: one
`all_gather_objects`; `MP3DEvaluator(distributed=True)` fed the rank's
strided slice of 5 pairs' fake predictions (tests/test_torch_eval.py's,
every metric family non-trivial; one image id in both slices, which each
rank scores and rank 0's reduction keeps once); `EvalRunner.test` over 5 synthetic pairs
with seeded weights (slices of 3 and 2 pairs); and the first batches of a
`Trainer`'s loader shard. Each is held against the same run in one process.
Then the trainer's CLI on two ranks (`--num-gpus 2 --device cpu`), and its
`--resume` as two "machines" (`--num-machines 2 --machine-rank r`), each a
process of its own, the counterpart of the JAX package's
tests/test_two_process.py.
"""
import copy
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.loader import PairLoader
from nopesac_torch.data.mapper import PairMapper
from nopesac_torch.data.packing import batch_to_device
from nopesac_torch.data.registry import DatasetCatalog
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.engine import trainer as trainer_mod
from nopesac_torch.engine.predict import build_model_from_cfg
from nopesac_torch.engine.test import EvalRunner
from nopesac_torch.engine.train import build_train_model
from nopesac_torch.evaluation.evaluator import MP3DEvaluator
from nopesac_torch.evaluation.postprocess import postprocess_batch
from nopesac_torch.parallel.dist import launch
from nopesac_torch.parallel.host_gather import all_gather_objects
from test_torch_eval import CAM_TOL, CAMERA_ERRORS, PLANE_ERRORS, assert_same, fake_inference
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)
from torch_dist_worker import SMOKE, eval_rank, smoke_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
N_PAIRS = 5   # rank 0 evaluates pairs 0, 2, 4 and rank 1 pairs 1, 3
WORLD = 2
RANK_MAJOR = [0, 2, 4, 1, 3]
OPTS = ["INPUT.IMAGE_SIZE", f"({H}, {W})", "TEST.EVAL_FULL_SCENE", "True"]
# the CLI runs: smoke_synthetic.yaml's own 96x128 (its synthetic_test split's
# size, which the evaluation hook needs), one pair per rank and step, no
# dropout and no AIM random poses (their streams differ per rank), so that
# the logged global losses equal one process's on the union of the ranks'
# batches
CLI_OPTS = ["SOLVER.IMS_PER_BATCH", "2",
            "MODEL.SEM_SEG_HEAD.DROPOUT", "0.0", "MODEL.CAMERA_HEAD.RAND_ON", "False",
            "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2",
            "TEST.PRECISE_BN.NUM_ITER", "1"]
LOSS_ABS, LOSS_REL = 1e-4, 1e-3   # tests/test_torch_train.py
CAMERA_LOSSES = ("Cam", "pixelReg")  # substrings of the camera head's loss keys


def _artifacts(out_dir):
    preds = torch.load(os.path.join(out_dir, "NopeSAC_instances_predictions.pth"),
                       weights_only=False)
    with open(os.path.join(out_dir, "continuous.pkl"), "rb") as f:
        return preds, pickle.load(f)


def _metrics_close(got, ref, exact_floats=False):
    """tests/test_torch_eval.py's rule; `exact_floats`: the same predictions
    in another order, so floats may differ only by their sums' order."""
    assert list(got) == list(ref)
    for k, v in ref.items():
        if exact_floats:
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-12, err_msg=k)
        elif k in CAMERA_ERRORS:
            assert abs(got[k] - v) <= CAM_TOL, (k, got[k], v)
        elif k in PLANE_ERRORS:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        else:  # AP, matching and accuracy percentages
            assert got[k] == v, (k, got[k], v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_eval")
    pairs = make_dataset(N_PAIRS, 4, seed=3, h=H, w=W)
    # an image id in both ranks' slices: pair 0's view 0 (rank 0) again as pair
    # 3's view 1 (rank 1), first in the rank-major order as in one process
    pairs[3]["1"] = copy.deepcopy(pairs[0]["0"])
    outputs = []
    for i, p in enumerate(pairs):
        meta = {"image_id0": p["0"]["image_id"], "image_id1": p["1"]["image_id"],
                "file_name0": p["0"]["file_name"], "file_name1": p["1"]["file_name"]}
        outputs.append(postprocess_batch(fake_inference([p], seed=4 + i), [meta], H, W)[0])
    spec = {"pairs": pairs, "outputs": outputs, "opts": OPTS, "seed": 1,
            "fake_dir": str(root / "fake_two"), "runner_dir": str(root / "runner_two"),
            "trainer_dir": str(root / "trainer"),
            "train_pairs": make_dataset(8, 4, seed=0, h=H, w=W)}
    spec_path = str(root / "spec.pt")
    torch.save(spec, spec_path)
    ranks = launch(eval_rank, WORLD, device="cpu", dist_url=f"file://{root}/rendezvous",
                   args=(spec_path,), timeout_s=600)

    cfg = smoke_cfg(OPTS + ["OUTPUT_DIR", str(root / "fake_one")])
    one = MP3DEvaluator("synthetic_test", cfg, dataset_list=pairs)
    one.process(pairs, outputs)
    fake_one = one.evaluate()
    cfg = smoke_cfg(OPTS + ["OUTPUT_DIR", str(root / "runner_one")])
    runner = EvalRunner(cfg, build_model_from_cfg(cfg, device="cpu", seed=spec["seed"]))
    runner_one = runner.test(pairs)
    yield dict(root=root, pairs=pairs, ranks=ranks, fake_one=fake_one, runner_one=runner_one,
               train_pairs=spec["train_pairs"])
    shutil.rmtree(root)


def test_all_gather_objects_at_one_and_two_ranks(runs):
    assert all_gather_objects({"x": 1}) == [{"x": 1}]  # no process group here
    want = [{"rank": 0, "items": [0]}, {"rank": 1, "items": [0, 1]}]
    assert [r["gathered"] for r in runs["ranks"]] == [want, want]


def test_distributed_evaluator_equals_one_process(runs):
    ranks = runs["ranks"]
    for r in ranks:
        _metrics_close(r["fake_results"], runs["fake_one"], exact_floats=True)
    assert 0 < runs["fake_one"]["mask_ap@0.5"] < 1 and 0 < runs["fake_one"]["precision"] < 1
    # rank 0 alone computed the metrics of all pairs, once per evaluator
    assert ranks[0]["evaluate_main_calls"] == [N_PAIRS, N_PAIRS]
    assert ranks[1]["evaluate_main_calls"] == []


def test_gathered_artifacts_are_rank_major_and_equal_one_process(runs):
    root, pairs = runs["root"], runs["pairs"]
    (preds, cont), (ref_preds, ref_cont) = (_artifacts(root / d) for d in ("fake_two", "fake_one"))
    ids = [p["0"]["image_id"] for p in pairs]
    assert [p["0"]["image_id"] for p in preds] == [ids[i] for i in RANK_MAJOR]
    assert sorted(cont) == list(range(N_PAIRS))
    for k, i in enumerate(RANK_MAJOR):
        assert_same(preds[k], ref_preds[i])
        assert_same(cont[k], ref_cont[i])


def test_eval_runner_on_two_ranks_equals_one_process(runs):
    root, pairs = runs["root"], runs["pairs"]
    for r in runs["ranks"]:
        _metrics_close(r["runner_results"], runs["runner_one"])
        assert r["runner_stats"]["pairs"] == N_PAIRS and r["runner_stats"]["pairs_per_sec"] > 0
    (preds, cont), (ref_preds, ref_cont) = (_artifacts(root / d)
                                            for d in ("runner_two", "runner_one"))
    ids = [p["0"]["image_id"] for p in pairs]
    assert [p["0"]["image_id"] for p in preds] == [ids[i] for i in RANK_MAJOR]
    for k, i in enumerate(RANK_MAJOR):
        np.testing.assert_array_equal(cont[k]["best_assignment"], ref_cont[i]["best_assignment"])
        assert cont[k]["image_ids"] == ref_cont[i]["image_ids"]
        for side in ("best_camera", "gt_camera"):
            for key in ("position", "rotation"):
                np.testing.assert_allclose(cont[k][side][key], ref_cont[i][side][key],
                                           atol=CAM_TOL)
        for v in ("0", "1"):
            assert len(preds[k][v]["instances"]) == len(ref_preds[i][v]["instances"])


def test_trainer_loader_shards_are_disjoint(runs):
    ids = [p["0"]["image_id"] for p in runs["train_pairs"]]
    shards = [r["shard_ids"] for r in runs["ranks"]]
    for r, got in enumerate(shards):
        assert len(got) == 4 and set(got) <= set(ids[r::WORLD]), (r, got)
    assert not set(shards[0]) & set(shards[1])


def test_resume_raises_when_ranks_disagree(tmp_path, monkeypatch):
    cfg = smoke_cfg(["INPUT.IMAGE_SIZE", "(64, 96)", "OUTPUT_DIR", str(tmp_path)])
    trainer = trainer_mod.Trainer(cfg, device="cpu")
    monkeypatch.setattr(trainer_mod, "all_gather_objects",
                        lambda obj: [obj, "model_0000002.pth"])
    with pytest.raises(RuntimeError, match="disagree"):
        trainer.resume_or_load(resume=True)
    trainer.close()


@pytest.mark.parametrize("visible, num_gpus, machines, want", [
    (8, None, 1, 8), (6, None, 1, 2), (8, 4, 2, 4), (0, 3, 1, ValueError),
    (8, 9, 1, ValueError), (8, 8, 3, ValueError), (None, None, 1, 1), (None, 2, 1, 2)])
def test_num_gpus_is_checked_as_the_jax_trainer_checks_it(monkeypatch, visible, num_gpus,
                                                          machines, want):
    """train_mp3d_step1_v5e8.yaml's global batch of 64 against the visible
    cards (None: --device cpu): the gcd by default, never more ranks than
    cards, and ranks of all machines dividing the batch."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "train_mp3d_step1_v5e8.yaml"))
    assert cfg.SOLVER.IMS_PER_BATCH == 64
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible or 0)
    device = "cpu" if visible is None else "cuda"
    if want is ValueError:
        with pytest.raises(ValueError):
            trainer_mod.resolve_num_gpus(cfg, num_gpus, machines, device)
    else:
        assert trainer_mod.resolve_num_gpus(cfg, num_gpus, machines, device) == want


# --------------------------------------------------------------------- CLIs

def _rows(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Two CLI steps on two ranks, then two more resumed as two machines."""
    root = tmp_path_factory.mktemp("dist_cli")
    out = str(root / "out")
    base = [sys.executable, "-m", "nopesac_torch.engine.trainer", "--config-file", SMOKE,
            "--device", "cpu"]
    first = subprocess.run(base + ["--num-gpus", "2", "--dist-url", f"file://{root}/rdv1"]
                           + CLI_OPTS + ["SOLVER.MAX_ITER", "2", "OUTPUT_DIR", out], cwd=REPO,
                           env=SUBPROCESS_ENV, capture_output=True, text=True, timeout=600)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    rows = _rows(out) if "metrics.json" in files else []
    if first.returncode == 0:
        os.remove(os.path.join(out, "model_0000002.pth"))  # ~0.9 GB; model_final stays
    machines = [subprocess.Popen(
        base + ["--resume", "--num-gpus", "1", "--num-machines", "2", "--machine-rank", str(r),
                "--dist-url", f"file://{root}/rdv2"] + CLI_OPTS
        + ["SOLVER.MAX_ITER", "4", "OUTPUT_DIR", out],
        cwd=REPO, env=SUBPROCESS_ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    resumed = []
    try:
        for p in machines:
            stdout, stderr = p.communicate(timeout=600)
            resumed.append((p.returncode, stdout, stderr))
    finally:
        for p in machines:
            if p.poll() is None:
                p.kill()
    yield dict(out=out, first=first, files=files, rows=rows, resumed=resumed,
               final_files=sorted(os.listdir(out)), final_rows=_rows(out))
    shutil.rmtree(root)


def test_trainer_cli_on_two_ranks(cli):
    first = cli["first"]
    assert first.returncode == 0, first.stderr[-3000:]
    lines = _json_lines(first.stdout)
    assert len(lines) == 1 and lines[0]["iteration"] == 2 and lines[0]["world_size"] == 2
    for name in ("config.yaml", "last_checkpoint", "log.txt", "metrics.json", "model_0000002.pth",
                 "model_final.pth"):
        assert name in cli["files"], name
    assert not [n for n in cli["files"] if n.endswith(".tmp")]
    loss_rows = [r for r in cli["rows"] if "eval" not in r]
    assert [r["iteration"] for r in loss_rows] == [0, 1]
    assert [r["iteration"] for r in cli["rows"] if "eval" in r] == [1]
    assert all(r["skipped_nonfinite"] == 0.0 for r in loss_rows)


def _concat(batches):
    """Collated batches as one, in order."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _concat([b[k] for b in batches]) for k in first}
    if isinstance(first, list):
        return [x for b in batches for x in b]
    return np.concatenate(batches)


def test_trainer_cli_logs_the_global_losses(cli):
    """Row 0 of metrics.json: one process's losses on the union of the two
    ranks' first batches (each rank's loader shard, as the Trainer builds
    it), from the same seeded weights. The camera head's losses sit behind
    the pose stacks' BN over the two pairs' 1x1 values, where f32 rounding
    is amplified (a reconstruction loss moved by 0.7% between the two
    summation orders): they are held to be present and finite here, and to
    JAX's on a 4-pair fixture in tests/test_torch_dist_train.py."""
    cfg = smoke_cfg(CLI_OPTS + ["SOLVER.MAX_ITER", "2"])
    mapper = PairMapper(cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES, tuple(cfg.INPUT.IMAGE_SIZE),
                        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, is_train=True, seed=cfg.SEED)
    samples = []
    for r in range(WORLD):
        loader = PairLoader(DatasetCatalog.get(cfg.DATASETS.TRAIN[0]), mapper, batch_size=1,
                            seed=cfg.SEED, num_shards=WORLD, shard_id=r, infinite=True)
        it = iter(loader)
        batch = next(it)
        it.close()
        loader.close()
        samples.append(batch)
    union = _concat(samples)
    model = build_train_model(cfg, device="cpu", seed=cfg.SEED)
    with torch.no_grad():
        losses = model.train_forward(batch_to_device(union, "cpu"))
    row = [r for r in cli["rows"] if r.get("iteration") == 0][0]
    assert all(np.isfinite(row[k]) for k in losses)
    held = [k for k in losses if not any(c in k for c in CAMERA_LOSSES)]
    assert {"loss_ce", "loss_mask", "loss_q", "loss_ce_0", "losses_emb_0"} <= set(held)
    bad = {k: (row[k], float(losses[k])) for k in held
           if not abs(row[k] - float(losses[k])) <= max(LOSS_ABS, LOSS_REL * abs(float(losses[k])))}
    assert not bad, bad


def test_trainer_resumes_as_two_machines(cli):
    (rc0, out0, err0), (rc1, out1, err1) = cli["resumed"]
    assert rc0 == 0 and rc1 == 0, (err0[-3000:], err1[-3000:])
    assert "resumed from step 2" in err0
    assert len(_json_lines(out0)) == 1 and not _json_lines(out1)
    assert _json_lines(out0)[0]["iteration"] == 4 and _json_lines(out0)[0]["world_size"] == 2
    assert [r["iteration"] for r in cli["final_rows"] if "eval" not in r] == [0, 1, 3]
    assert [r["iteration"] for r in cli["final_rows"] if "eval" in r] == [1, 3]
    assert "model_0000004.pth" in cli["final_files"]
