"""The evaluation entry point of the port against the JAX package: the RLE
codec, the eval branch of the mapper, the dataset registry, the host
postprocess with MP3DEvaluator and its two artifacts, and the whole of
`engine/test.py:EvalRunner.test` against JAX `Trainer.test` on shared weights,
whose artifacts `eval.py` reads.

Host code (RLE, postprocess, evaluator) must agree exactly: it is the same
numpy arithmetic on the same inputs. The whole entry point runs the model,
so its cameras agree within 1e-3 (tests/test_torch_slice.py); its AP and
matching values, whose inputs are plane masks and assignments, agree exactly.
"""
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.data import datasets as jax_datasets  # noqa: F401  (registers the splits)
from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.registry import DatasetCatalog as JaxDatasetCatalog
from nopesac_tpu.data.synthetic import make_dataset as jax_make_dataset
from nopesac_tpu.evaluation.evaluator import MP3DEvaluator as JaxEvaluator
from nopesac_tpu.evaluation.postprocess import postprocess_batch as jax_postprocess
from nopesac_tpu.utils import rle as jax_rle

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.mapper import PairMapper
from nopesac_torch.data.registry import DatasetCatalog
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.engine.predict import build_model_from_cfg
from nopesac_torch.engine.test import EvalRunner
from nopesac_torch.evaluation.evaluator import MP3DEvaluator
from nopesac_torch.evaluation.postprocess import postprocess_batch
from nopesac_torch.utils import rle
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
NQ = 50
CAM_TOL = 1e-3  # tests/test_torch_slice.py
CAMERA_ERRORS = ("T median err", "T mean err", "R median err", "R mean err")
PLANE_ERRORS = ("mean_normal", "median_normal", "mean_offset", "median_offset")
CAMERAS = ("camera_zero", "camera_init", "camera_initRec", "camera_avgRef0", "camera_softRef0",
           "camera")


def assert_same(a, b, path="root"):
    """Exact equality of two artifact trees: keys in order, types, dtypes,
    shapes and every value."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------- (d) RLE

def label_maps(seed, n=4, h=37, w=53, k=6):
    """Blocky seeded label maps with background -1, plus one with a single
    on-pixel of query 0 in the last column."""
    rng = np.random.default_rng(seed)
    maps = []
    for _ in range(n):
        lab = np.full((h, w), -1, np.int8)
        for _ in range(10):
            y, x = rng.integers(0, h), rng.integers(0, w)
            lab[y:y + rng.integers(1, h // 2), x:x + rng.integers(1, w // 2)] = rng.integers(0, k)
        maps.append(lab)
    single = np.full((h, w), -1, np.int8)
    single[h - 1, w - 1] = 0
    return maps + [single]


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_byte_equal_to_jax(seed):
    queries = [0, 1, 2, 3, 4, 5, 7]  # 7 never occurs: the empty-query runs
    for lab in label_maps(seed):
        ours, theirs = rle.encode_label_map(lab, queries), jax_rle.encode_label_map(lab, queries)
        for q, a, b in zip(queries, ours, theirs):
            assert a["counts"] == b["counts"] and a["size"] == b["size"]
            np.testing.assert_array_equal(a["_runs"], b["_runs"])
            mask = (lab == q).astype(np.uint8)
            enc = rle.encode(mask)
            assert enc == jax_rle.encode(mask) and enc["counts"] == a["counts"]
            np.testing.assert_array_equal(rle.decode(enc), mask)
            assert rle.area(enc) == jax_rle.area(enc) == int(mask.sum())
            np.testing.assert_array_equal(rle.to_bbox(enc), jax_rle.to_bbox(enc))
            assert rle.counts_to_string(a["_runs"]) == jax_rle.counts_to_string(b["_runs"])
        segs = [rle.encode((lab == q).astype(np.uint8)) for q in queries]
        np.testing.assert_array_equal(rle.iou(segs[:4], segs, [0] * len(segs)),
                                      jax_rle.iou(segs[:4], segs, [0] * len(segs)))


def test_postprocess_empty_query_fallback_matches_jax():
    """A valid query with an empty gated mask keeps a single on-pixel at
    (0, 0), with the same bytes and bbox as the JAX postprocess."""
    seg = np.full((1, H, W), -1, np.int8)
    seg[0, 10:20, 30:40] = 3
    view = {"valid": np.zeros((1, NQ), bool), "score": np.full((1, NQ), 0.9, np.float32),
            "params": np.ones((1, NQ, 3), np.float32), "centers": np.zeros((1, NQ, 2), np.float32),
            "seg_gated": seg}
    view["valid"][0, [3, 8]] = True
    out = {"view0": view, "view1": view}
    metas = [{"image_id0": "a", "image_id1": "b", "file_name0": "", "file_name1": ""}]
    ours, theirs = postprocess_batch(out, metas, H, W), jax_postprocess(out, metas, H, W)
    assert_same(ours, theirs)
    empty = ours[0]["0"]["instances"][1]
    assert rle.area(empty["segmentation"]) == 1 and empty["bbox"] == [0.0, 0.0, 1.0, 1.0]


# ------------------------------------------------ data: generator, registry, mapper

def test_synthetic_splits_and_eval_mapper_match_jax():
    for name in ("synthetic_test", "synthetic_train"):
        ours, theirs = DatasetCatalog.get(name), JaxDatasetCatalog.get(name)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a["rel_pose"] == b["rel_pose"] and a["gt_corrs"] == b["gt_corrs"]
            for v in ("0", "1"):
                for key in ("file_name", "image_id", "height", "width"):
                    assert a[v][key] == b[v][key]
                assert [dict(x, mask=None) for x in a[v]["annotations"]] == \
                    [dict(x, mask=None) for x in b[v]["annotations"]]
                np.testing.assert_array_equal(a[v]["image"], b[v]["image"])
    pairs, jpairs = make_dataset(2, 4, seed=3, h=H, w=W), jax_make_dataset(2, 4, seed=3, h=H, w=W)
    for gt_box in (False, True):
        ours = PairMapper(NQ, (H, W), is_train=False, eval_gt_box=gt_box)
        theirs = JaxPairMapper(is_train=False, image_size=(H, W), num_queries=NQ,
                               raw_uint8=True, eval_gt_box=gt_box)
        for a, b in zip(pairs, jpairs):
            sa, sb = ours(a), theirs(b)
            assert sorted(sa) == sorted(sb)
            for k in sa:
                if k == "meta":
                    assert {m: sa[k][m] for m in sa[k]} == {m: sb[k][m] for m in sa[k]}
                elif isinstance(sa[k], dict):
                    assert sorted(sa[k]) == sorted(sb[k])
                    for t in sa[k]:
                        np.testing.assert_array_equal(sa[k][t], sb[k][t], err_msg=t)
                else:
                    assert sa[k].dtype == sb[k].dtype, k
                    np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_eval_mapper_reads_image_files_like_jax(tmp_path):
    """A view without an in-memory image is read from its file_name (the
    MP3D prefix of the reference jsons replaced by the root directory) and
    resized to the mapper's size, as the JAX mapper does; a missing file
    gives a black image."""
    from PIL import Image

    from nopesac_torch.data.mapper import MP3D_PATH_PREFIX

    rgb = np.random.default_rng(5).integers(0, 256, (H // 2, W // 2, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "view0.png")
    pair = make_dataset(1, 2, seed=1, h=H, w=W)[0]
    for v, name in (("0", "view0.png"), ("1", "missing.png")):
        del pair[v]["image"]
        pair[v]["file_name"] = MP3D_PATH_PREFIX + name
    root = str(tmp_path) + os.sep
    ours = PairMapper(NQ, (H, W), is_train=False, root_dir=root)(pair)
    theirs = JaxPairMapper(is_train=False, image_size=(H, W), num_queries=NQ, raw_uint8=True,
                           root_dir=root)(pair)
    for key in ("image0", "image1"):
        assert ours[key].dtype == np.uint8 and ours[key].shape == (H, W, 3)
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["image0"].any() and not ours["image1"].any()


# ------------------------------------- (e) postprocess + evaluator + artifacts

def fake_inference(pairs, seed):
    """A numpy inference dict of the eval step's keys for `pairs`: each GT
    plane a valid query whose mask is its GT mask shifted (one of them
    shrunk below IoU 0.5), one more valid query with an empty mask, noisy
    plane parameters and cameras, and assignments that get most
    correspondences right."""
    rng = np.random.default_rng(seed)
    b = len(pairs)
    out, qids = {}, {}
    for v in ("0", "1"):
        valid = np.zeros((b, NQ), bool)
        score = rng.uniform(0.5, 1.0, (b, NQ)).astype(np.float32)
        params = rng.normal(0, 1, (b, NQ, 3)).astype(np.float32)
        seg = np.full((b, H, W), -1, np.int8)
        for i, pair in enumerate(pairs):
            anns = pair[v]["annotations"]
            q = rng.choice(NQ, size=len(anns) + 1, replace=False)
            qids[v, i] = q
            valid[i, q] = True
            for k, ann in enumerate(anns):
                mask = rle.decode(ann["segmentation"]).astype(bool)
                mask = np.roll(mask, (rng.integers(-3, 4), rng.integers(-3, 4)), axis=(0, 1))
                if k == 1:
                    mask &= np.arange(W)[None, :] % 3 == 0
                seg[i][mask] = q[k]
                params[i, q[k]] = np.asarray(ann["plane"]) + rng.normal(0, 0.1, 3)
        out[f"view{v}"] = {"valid": valid, "score": score, "params": params, "seg_gated": seg,
                           "centers": rng.uniform(0, 1, (b, NQ, 2)).astype(np.float32)}
    out["log_scores"] = (rng.normal(0, 1, (b, NQ + 1, NQ + 1)) - 3).astype(np.float32)
    for key, p_ok in (("assignment_beforeRef", 0.9), ("assignment", 0.7)):
        a = np.zeros((b, NQ, NQ), np.float32)
        for i, pair in enumerate(pairs):
            for k0, k1 in pair["gt_corrs"]:
                if rng.random() < p_ok:
                    a[i, qids["0", i][k0], qids["1", i][k1]] = 1.0
            a[i, qids["0", i][-1], qids["1", i][0]] = 1.0  # one wrong match
        out[key] = a
    gt_t = np.asarray([p["rel_pose"]["position"] for p in pairs], np.float32)
    gt_q = np.asarray([p["rel_pose"]["rotation"] for p in pairs], np.float32)
    out["cameras"] = {}
    for name in CAMERAS:
        q = gt_q + rng.normal(0, 0.2, gt_q.shape)
        out["cameras"][name] = {
            "tran": (gt_t + rng.normal(0, 0.5, gt_t.shape)).astype(np.float32),
            "rot": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)}
    out["camera_onePP"] = {
        "tran": rng.normal(0, 1, (b, NQ + 1, 3)).astype(np.float32),
        "rot": rng.normal(0, 1, (b, NQ + 1, 4)).astype(np.float32),
        "hyp_valid": np.arange(NQ + 1)[None, :] < np.asarray([[3], [5]])[:b],
        "score_rot": rng.uniform(0, 1, (b, NQ + 1)).astype(np.float32),
        "score_trans": rng.uniform(0, 1, (b, NQ + 1)).astype(np.float32)}
    out["num_matches"] = np.asarray([3, 5][:b], np.int32)
    return out


def _eval_cfgs(out_dir):
    cfgs = []
    for make, sub in ((jax_get_cfg, "jax"), (get_cfg, "port")):
        cfg = make()
        cfg.MODEL.EMBEDDING_ON = True
        cfg.MODEL.CAMERA_ON = True
        cfg.TEST.EVAL_FULL_SCENE = True
        cfg.OUTPUT_DIR = os.path.join(out_dir, sub)
        cfg.freeze()
        cfgs.append(cfg)
    return cfgs


def _load_artifacts(out_dir):
    preds = torch.load(os.path.join(out_dir, "NopeSAC_instances_predictions.pth"),
                       weights_only=False)
    with open(os.path.join(out_dir, "continuous.pkl"), "rb") as f:
        return preds, pickle.load(f)


def test_postprocess_and_evaluator_match_jax_exactly(tmp_path):
    pairs, jpairs = make_dataset(2, 4, seed=3, h=H, w=W), jax_make_dataset(2, 4, seed=3, h=H, w=W)
    infer = fake_inference(pairs, seed=4)
    metas = [{"image_id0": p["0"]["image_id"], "image_id1": p["1"]["image_id"],
              "file_name0": p["0"]["file_name"], "file_name1": p["1"]["file_name"]} for p in pairs]
    jcfg, tcfg = _eval_cfgs(str(tmp_path))
    theirs = JaxEvaluator("synthetic_test", jcfg, dataset_list=jpairs)
    theirs.process(jpairs, jax_postprocess(infer, metas, H, W))
    ours = MP3DEvaluator("synthetic_test", tcfg, dataset_list=pairs)
    ours.process(pairs, postprocess_batch(infer, metas, H, W))
    ref, got = theirs.evaluate(), ours.evaluate()
    # the fixture reaches every metric family with non-trivial values
    assert 0 < ref["mask_ap@0.5"] < 1 and 0 < ref["precision"] < 1 and 0 < ref["recall"] < 1
    assert_same(dict(got), dict(ref))
    for a, b in zip(_load_artifacts(tcfg.OUTPUT_DIR), _load_artifacts(jcfg.OUTPUT_DIR)):
        assert_same(a, b)


def test_evaluator_refuses_distributed(tmp_path):
    _, tcfg = _eval_cfgs(str(tmp_path))
    with pytest.raises(NotImplementedError):
        MP3DEvaluator("synthetic_test", tcfg, distributed=True,
                      dataset_list=make_dataset(1, 2, h=H, w=W))


# --------------------------------------------------- (f) the whole entry point

def _tiny_cfgs(out_dir):
    """tests/test_end_to_end.py's tiny config, for both packages."""
    cfgs = []
    for make, sub in ((jax_get_cfg, "jax"), (get_cfg, "port")):
        cfg = make()
        cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS = 10
        cfg.MODEL.EMBEDDING_ON = True
        cfg.MODEL.CAMERA_ON = True
        cfg.MODEL.CAMERA_HEAD.NAME = "PlaneCameraHead"
        cfg.MODEL.CAMERA_HEAD.REFINE_ON = True
        cfg.MODEL.CAMERA_HEAD.CAM_REC_ON = True
        cfg.MODEL.SEM_SEG_HEAD.PARAM_ON = True
        cfg.MODEL.SEM_SEG_HEAD.CENTER_ON = True
        cfg.TEST.EVAL_FULL_SCENE = True
        cfg.SOLVER.IMS_PER_BATCH = 2
        cfg.SOLVER.MAX_ITER = 1
        cfg.INPUT.IMAGE_SIZE = (H, W)
        cfg.OUTPUT_DIR = os.path.join(out_dir, sub)
        cfg.freeze()
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def entry_point(tmp_path_factory):
    """One JAX Trainer.test and the port's EvalRunner.test (fused-tail backbone)
    on its weights, over the same 2 pairs (TEST.IMS_PER_BATCH 4: one padded
    batch)."""
    from nopesac_tpu.engine.trainer import Trainer

    out = str(tmp_path_factory.mktemp("entry"))
    jcfg, tcfg = _tiny_cfgs(out)
    trainer = Trainer(jcfg, image_hw=(H, W), training=False)
    ref = trainer.test(dataset_list=jax_make_dataset(n_pairs=2, n_planes=4, h=H, w=W, seed=3))
    state = jax.tree_util.tree_map(np.asarray, (trainer.state.params, trainer.state.batch_stats))
    model = build_model_from_cfg(tcfg, device="cpu", fuse_tail=True)
    model.load_state_dict(state_dict_from_jax(*state, image_size=(H, W)), strict=True)
    tester = EvalRunner(tcfg, model)
    pairs = make_dataset(n_pairs=2, n_planes=4, h=H, w=W, seed=3)
    got = tester.test(dataset_list=pairs)
    return jcfg, tcfg, ref, got, tester, pairs


def test_entry_point_matches_jax_trainer_test(entry_point):
    jcfg, tcfg, ref, got, tester, _ = entry_point
    assert list(got) == list(ref)
    assert {"T median err", "R median err", "mask_ap@0.5", "precision", "recall"} <= set(ref)
    for k, v in ref.items():
        if k in CAMERA_ERRORS:
            assert abs(got[k] - v) <= CAM_TOL, (k, got[k], v)
        elif k in PLANE_ERRORS:  # from the plane parameters: MODULE_TOL, in degrees or metres
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        else:  # AP, matching and accuracy percentages
            assert got[k] == v, (k, got[k], v)
    stats = tester.last_eval_stats
    assert stats["pairs"] == 2 and stats["pairs_per_sec"] > 0
    (preds, cont), (jpreds, jcont) = (_load_artifacts(c.OUTPUT_DIR) for c in (tcfg, jcfg))
    assert len(preds) == len(jpreds) == 2
    assert set(cont[0]) == {"n_corr", "cost", "best_camera", "gt_camera", "best_assignment",
                            "plane_param_override", "image_ids"}
    for i in cont:
        np.testing.assert_array_equal(cont[i]["best_assignment"], jcont[i]["best_assignment"])
        assert cont[i]["image_ids"] == jcont[i]["image_ids"]
        for side in ("best_camera", "gt_camera"):
            for k in ("position", "rotation"):
                np.testing.assert_allclose(cont[i][side][k], jcont[i][side][k], atol=CAM_TOL)
    for p, q in zip(preds, jpreds):
        for v in ("0", "1"):
            # the model's masks: labels agree on >= 99.9% of pixels (test_torch_slice)
            assert len(p[v]["instances"]) == len(q[v]["instances"])
            for a, b in zip(p[v]["instances"], q[v]["instances"]):
                agree = (rle.decode(a["segmentation"]) == rle.decode(b["segmentation"])).mean()
                assert agree >= 0.999, agree
            assert isinstance(p[v]["pred_plane"], torch.Tensor)


def test_offline_eval_reads_the_ports_artifacts(entry_point, tmp_path, capsys):
    """eval.py --evaluate camera on the port's artifacts prints the online
    evaluator's camera numbers."""
    import eval as offline_eval

    _, tcfg, _, got, _, pairs = entry_point
    dsjson = str(tmp_path / "pairs.json")
    strip = ("depth", "image")
    with open(dsjson, "w") as f:
        json.dump({"data": [{k: ({vk: vv for vk, vv in v.items() if vk not in strip}
                                 | {"annotations": [{ak: av for ak, av in a.items() if ak != "mask"}
                                                    for a in v["annotations"]]}
                                 if k in ("0", "1") else v) for k, v in p.items()}
                            for p in pairs]}, f)
    args = types.SimpleNamespace(
        config_file="", rcnn_cached_file=os.path.join(tcfg.OUTPUT_DIR,
                                                      "NopeSAC_instances_predictions.pth"),
        evaluate="camera", num_process=1, camera_cached_file="", num_data=-1,
        dataset_phase="synth", optimized_dict_path=os.path.join(tcfg.OUTPUT_DIR, "continuous.pkl"),
        dataset_json=dsjson, opts=[])
    capsys.readouterr()
    assert offline_eval.main(args) == 0
    printed = capsys.readouterr().out
    assert "Median Error [tran, rot]:            {:.2f}, {:.2f}".format(
        got["T median err"], got["R median err"]) in printed
    assert "Mean Error   [tran, rot]:            {:.2f}, {:.2f}".format(
        got["T mean err"], got["R mean err"]) in printed
    assert "Accuracy     [tran(1m), rot(30')]:   {:.2f}, {:.2f}".format(
        got["T err < 1.0"], got["R err < 30"]) in printed


def test_test_cli_on_cpu(tmp_path):
    out = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "nopesac_torch.engine.test",
         "--config-file", os.path.join(REPO, "configs", "smoke_synthetic.yaml"),
         "--eval-only", "--device", "cpu", "--seed", "1", "TEST.EVAL_FULL_SCENE", "True",
         "OUTPUT_DIR", out],
        cwd=REPO, env=SUBPROCESS_ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = json.loads(proc.stdout.splitlines()[-1])
    assert row["device"] == "cpu" and row["eval_stats"]["pairs"] == 4
    assert {"T median err", "R median err", "mask_ap@0.5", "precision"} <= set(row["results"])
    assert all(np.isfinite(v) for v in row["results"].values())
    assert "seeded random weights" in proc.stderr
    for name in ("NopeSAC_instances_predictions.pth", "continuous.pkl", "log.txt"):
        assert os.path.exists(os.path.join(out, name)), name
