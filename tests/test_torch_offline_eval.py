"""The port's offline evaluator (`engine/offline_eval.py`), its camera branch
and bins against the root `eval.py` and the JAX package.

Both evaluators read the same artifacts: an imperfect set built from a seed
(perturbed planes and cameras, a dropped instance, a wrong match, scores
below and above 0.1, `plane_param_override` set and None, a pair without
`gt_camera`) and the port's own `engine/test.py` artifacts at 96x128. They
are the same float64 numpy arithmetic, so every AP row, every camera error
array and the matching precision, recall and F agree to 1e-12 (the tests
find them bit-equal).
"""
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import eval as jax_eval
from nopesac_tpu.data.cam_bins import CameraBins as JaxCameraBins
from nopesac_tpu.models.camera_branch import CameraBranch as JaxCameraBranch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.cam_bins import CameraBins
from nopesac_torch.data.registry import DatasetCatalog
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.engine import offline_eval
from nopesac_torch.engine.test import EvalRunner, build_eval_model
from nopesac_torch.models.camera_branch import CameraBranch
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
TOL = 1e-12
ERROR_KEYS = ("err_offsets", "err_normals", "mask_iou", "scores")


def write_dataset_json(pairs, path):
    """The pairs as a cached_set json: no in-memory depth or image, no dense
    annotation masks."""
    strip = ("depth", "image")
    data = [{k: ({vk: vv for vk, vv in v.items() if vk not in strip}
                 | {"annotations": [{ak: av for ak, av in a.items() if ak != "mask"}
                                    for a in v["annotations"]]}
                 if k in ("0", "1") else v) for k, v in p.items()} for p in pairs]
    with open(path, "w") as f:
        json.dump({"categories": [{"name": "plane", "id": 1}], "data": data}, f)
    return path


def _unit(q):
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def imperfect_artifacts(out_dir, seed=5, n_pairs=4):
    """(pth, continuous.pkl, dataset json) of predictions made from the GT of
    `n_pairs` synthetic pairs with seeded faults: every plane and camera
    perturbed, pair 0 without view 1's plane 2, pair 2 with matches 0 and 1
    swapped, scores in (0.2, 1) but one of 0.05 in pair 2, the
    `plane_param_override` of the even pairs set (the odd ones None), pair 3
    without `gt_camera`."""
    pairs = make_dataset(n_pairs=n_pairs, n_planes=4, h=H, w=W, seed=seed)
    rng = np.random.default_rng(seed)
    preds, cont = [], {}
    for idx, pair in enumerate(pairs):
        keep = {"0": [0, 1, 2, 3], "1": [0, 1, 3] if idx == 0 else [0, 1, 2, 3]}
        pred, planes = {}, {}
        for v in ("0", "1"):
            view = pair[v]
            insts = []
            for a in keep[v]:
                ann = view["annotations"][a]
                score = 0.05 if (idx == 2 and v == "1" and a == 3) else float(rng.uniform(0.2, 1))
                insts.append({"image_id": view["image_id"], "file_name": view["file_name"],
                              "category_id": 0, "score": score,
                              "segmentation": {"size": ann["segmentation"]["size"],
                                               "counts": ann["segmentation"]["counts"].encode()},
                              "bbox": ann["bbox"], "bbox_mode": 1})
            planes[v] = np.asarray([view["annotations"][a]["plane"] for a in keep[v]])
            planes[v] = (planes[v] + rng.normal(scale=0.05, size=planes[v].shape)).astype(np.float32)
            pred[v] = {"image_id": view["image_id"], "file_name": view["file_name"],
                       "instances": insts, "pred_plane": torch.as_tensor(planes[v])}
        ass = np.zeros((len(keep["0"]), len(keep["1"])), np.float32)
        for j, a in enumerate(keep["0"]):
            if a in keep["1"]:
                ass[j, keep["1"].index(a)] = 1
        if idx == 2:
            ass[[0, 1]] = ass[[1, 0]]
        gt = pair["rel_pose"]
        tran = np.asarray(gt["position"]) + rng.normal(scale=0.1, size=3)
        rot = _unit(np.asarray(gt["rotation"]) + rng.normal(scale=0.05, size=4))
        pred["camera"] = {"pred": {"tran": tran, "rot": rot},
                          "gts": {"tran": gt["position"], "rot": gt["rotation"]}}
        preds.append(pred)
        cont[idx] = {
            "n_corr": ass.sum(), "cost": 0.1,
            "best_camera": {"position": tran, "rotation": rot},
            "gt_camera": {"position": np.asarray(gt["position"]),
                          "rotation": np.asarray(gt["rotation"])},
            "best_assignment": ass,
            "plane_param_override": planes if idx % 2 == 0 else None,
            "image_ids": {"0": pair["0"]["image_id"], "1": pair["1"]["image_id"]},
        }
        if idx == 3:
            del cont[idx]["gt_camera"]
    pth = os.path.join(out_dir, "NopeSAC_instances_predictions.pth")
    torch.save(preds, pth)
    cont_path = os.path.join(out_dir, "continuous.pkl")
    with open(cont_path, "wb") as f:
        pickle.dump(cont, f)
    return pth, cont_path, write_dataset_json(pairs, os.path.join(out_dir, "pairs.json"))


def entry_point_artifacts(out_dir):
    """The port's `engine/test.py` artifacts at 96x128 (seeded weights,
    configs/smoke_synthetic.yaml's synthetic_test split): (pth,
    continuous.pkl, dataset json) and the online evaluator's metrics."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "smoke_synthetic.yaml"))
    cfg.merge_from_list(["TEST.EVAL_FULL_SCENE", "True", "OUTPUT_DIR", out_dir])
    cfg.freeze()
    results = EvalRunner(cfg, build_eval_model(cfg, device="cpu", seed=0)).test()
    files = (os.path.join(out_dir, "NopeSAC_instances_predictions.pth"),
             os.path.join(out_dir, "continuous.pkl"),
             write_dataset_json(DatasetCatalog.get("synthetic_test"),
                                os.path.join(out_dir, "pairs.json")))
    return files, results


@pytest.fixture(scope="module")
def artifact_sets(tmp_path_factory):
    entry, online = entry_point_artifacts(str(tmp_path_factory.mktemp("entry")))
    return {"imperfect": imperfect_artifacts(str(tmp_path_factory.mktemp("imperfect"))),
            "entry_point": entry, "online": online}


def make_args(pth, cont, dsjson, **kw):
    args = dict(config_file="", rcnn_cached_file=pth, evaluate="AP", num_process=1,
                camera_cached_file="", num_data=-1, dataset_phase="synth",
                optimized_dict_path=cont, dataset_json=dsjson, opts=[])
    args.update(kw)
    return types.SimpleNamespace(**args)


def evaluators(args):
    """(eval.py's Evaluator, the port's), each with its optimized dict."""
    ref, got = jax_eval.Evaluator(args), offline_eval.Evaluator(args)
    for ev in (ref, got):
        if args.optimized_dict_path:
            with open(args.optimized_dict_path, "rb") as f:
                ev.optimized_dict = pickle.load(f)
    return ref, got


def jax_ap_table(ev):
    """eval.py's AP rows, as its main() computes them."""
    idxs = list(range(len(ev.rcnn_data)))
    errs = jax_eval.multiprocess_by_list(ev, 1, idxs)
    bb = list(zip(*[jax_eval.evaluate_by_idx(errs[i]) for i in idxs]))
    aps = {}
    for i, name in enumerate(jax_eval.EP_AP_STR):
        tp, fp, sc, num_inst, *_ = zip(*bb[i])
        aps[name] = jax_eval.inst_bench(tp, fp, sc, num_inst)[0]
    return errs, aps


def assert_ap_equal(ref, got):
    errs, aps = jax_ap_table(ref)
    got_errs = offline_eval.multiprocess_by_list(got, 1, list(range(len(got.rcnn_data))))
    assert sorted(got_errs) == sorted(errs)
    for idx in errs:
        for key in ERROR_KEYS:
            np.testing.assert_allclose(got_errs[idx][key], errs[idx][key], rtol=0, atol=TOL,
                                       err_msg=f"{idx} {key}")
        for v in ("0", "1"):
            for key in ("individual_error_offset", "individual_error_normal", "individual_miou"):
                np.testing.assert_allclose(got_errs[idx][key][v], errs[idx][key][v], rtol=0,
                                           atol=TOL)
    got_aps = offline_eval.ap_table(got, 1)
    assert list(got_aps) == list(aps) == offline_eval.EP_AP_STR
    for name in aps:
        assert abs(got_aps[name] - aps[name]) <= TOL, (name, got_aps[name], aps[name])
    return got_aps


def assert_camera_equal(ref, got):
    a, b = ref.evaluate_camera(ref.optimized_dict), got.evaluate_camera(got.optimized_dict)
    assert list(a) == list(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=TOL, err_msg=key)
    return b


@pytest.mark.parametrize("which", ["imperfect", "entry_point"])
def test_ap_rows_equal_eval_py(artifact_sets, which):
    ref, got = evaluators(make_args(*artifact_sets[which]))
    aps = assert_ap_equal(ref, got)
    assert all(np.isfinite(v) for v in aps.values())
    if which == "imperfect":  # the faults cost AP: the table is not trivially perfect
        assert 0 < aps["all"] < 1


@pytest.mark.parametrize("which", ["imperfect", "entry_point"])
def test_camera_errors_equal_eval_py(artifact_sets, which):
    ref, got = evaluators(make_args(*artifact_sets[which]))
    out = assert_camera_equal(ref, got)
    assert out["tran_errs"].shape == (4,) and (out["tran_errs"] > 0).all()


@pytest.mark.parametrize("which", ["imperfect", "entry_point"])
def test_matching_equals_eval_py(artifact_sets, which):
    ref, got = evaluators(make_args(*artifact_sets[which]))
    a, b = ref.evaluate_matching_precision_recall(), got.evaluate_matching_precision_recall()
    assert list(a) == list(b) == ["precision", "recall", "F-score"]
    for key in a:
        assert abs(b[key] - a[key]) <= TOL, (key, b[key], a[key])
    if which == "imperfect":  # one wrong match of 14, 14 of 16 GT matches found
        assert (b["precision"], b["recall"]) == (13 / 15, 13 / 16)


def test_offline_camera_equals_the_online_evaluator(artifact_sets):
    """On the entry point's artifacts the offline camera numbers are the
    online evaluator's (which normalises the quaternions: 1e-3)."""
    pth, cont, dsjson = artifact_sets["entry_point"]
    online = artifact_sets["online"]
    got = offline_eval.Evaluator(make_args(pth, cont, dsjson))
    assert offline_eval.load_optimized_dict(got, cont)
    out = got.evaluate_camera(got.optimized_dict)
    for key, want in (("median_tran_err", "T median err"), ("median_rot_err", "R median err"),
                      ("mean_tran_err", "T mean err"), ("mean_rot_err", "R mean err")):
        assert abs(out[key] - online[want]) <= 1e-3, (key, out[key], online[want])
    assert abs(out["tran_acc"] * 100 - online["T err < 1.0"]) <= 1e-3
    assert abs(out["rot_acc"] * 100 - online["R err < 30"]) <= 1e-3


def cached_camera_file(dsjson, path, seed=9):
    """A SparsePlanes-style cached-logits pickle for the json's pairs: seeded
    random logits over the 32 bins, the pairs' GT poses."""
    with open(dsjson) as f:
        pairs = json.load(f)["data"]
    rng = np.random.default_rng(seed)
    keys = [p["0"]["file_name"] + p["1"]["file_name"] for p in pairs]
    with open(path, "wb") as f:
        pickle.dump({"keys": keys,
                     "logits_sms": {"tran": rng.normal(size=(len(keys), 32)),
                                    "rot": rng.normal(size=(len(keys), 32))},
                     "gts": {"tran": [p["rel_pose"]["position"] for p in pairs],
                             "rot": [p["rel_pose"]["rotation"] for p in pairs]}}, f)
    return path


@pytest.mark.parametrize("which", ["imperfect", "entry_point"])
def test_cached_camera_branch_equals_eval_py(artifact_sets, which, tmp_path):
    """--camera-cached-file: the pairs whose best_camera is None (the odd
    ones) take the decoded top-1 bins in AP and camera; get_camera_info
    with topk 0, 1 and -1 mixed agrees with eval.py's."""
    pth, cont, dsjson = artifact_sets[which]
    with open(cont, "rb") as f:
        od = pickle.load(f)
    for idx in od:
        if idx % 2:
            od[idx]["best_camera"] = None
    half = str(tmp_path / "continuous_half.pkl")
    with open(half, "wb") as f:
        pickle.dump(od, f)
    cam_file = cached_camera_file(dsjson, str(tmp_path / "cached_cam.pkl"))
    args = make_args(pth, half, dsjson, camera_cached_file=cam_file)
    ref, got = evaluators(args)
    assert_ap_equal(ref, got)
    out = assert_camera_equal(ref, got)
    bins = CameraBins(dataset="mp3d")
    with open(cam_file, "rb") as f:
        cached = pickle.load(f)
    for idx in (1, 3):  # the fallback decodes the argmax bins' centres
        row = cached["keys"].index(got.rcnn_data[idx]["0"]["file_name"]
                                   + got.rcnn_data[idx]["1"]["file_name"])
        info = got.get_camera_info(idx, 0, 0)
        np.testing.assert_array_equal(
            info["position"], bins.class2xyz(int(np.argmax(cached["logits_sms"]["tran"][row]))))
        np.testing.assert_array_equal(
            info["rotation"], bins.class2quat(int(np.argmax(cached["logits_sms"]["rot"][row]))))
    assert np.isfinite(out["tran_errs"]).all()
    for topk in ((0, 0), (1, 2), (-1, 0), (0, -1), (-1, -1)):
        for idx in range(4):
            a, b = ref.get_camera_info(idx, *topk), got.get_camera_info(idx, *topk)
            assert list(a) == list(b), topk
            for key in a:
                np.testing.assert_array_equal(b[key], a[key], err_msg=f"{topk} {key}")


def test_no_optimized_dict_uses_the_cached_branch(artifact_sets, tmp_path, capsys):
    """Without continuous.pkl every camera comes from the cached logits;
    without either, main returns 1; an unknown mode does nothing, as eval.py.
    (The entry point's artifacts: without an override the parameters of
    scores under 0.1 are dropped and the mask IoUs are not, which eval.py's
    AP cannot take.)"""
    pth, _, dsjson = artifact_sets["entry_point"]
    cam_file = cached_camera_file(dsjson, str(tmp_path / "cached_cam.pkl"))
    for mode in ("camera", "AP"):
        outs = []
        for module in (jax_eval, offline_eval):
            capsys.readouterr()
            assert module.main(make_args(pth, "", dsjson, camera_cached_file=cam_file,
                                         evaluate=mode)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "cached-camera branch" in outs[1]
    for module in (jax_eval, offline_eval):
        assert module.main(make_args(pth, "", dsjson)) == 1
        assert module.main(make_args(pth, artifact_sets["entry_point"][1], dsjson,
                                     evaluate="correspondence")) == 0


def test_forked_workers_equal_one_process(artifact_sets):
    """--num-process 2 forks two workers, as eval.py does: each is sent its
    chunk's indices only, and the errors are those of one process."""
    pth, cont, dsjson = artifact_sets["imperfect"]
    _, got = evaluators(make_args(pth, cont, dsjson))
    idxs = list(range(len(got.rcnn_data)))
    one = offline_eval.multiprocess_by_list(got, 1, idxs)
    two = offline_eval.multiprocess_by_list(got, 2, idxs)
    assert sorted(two) == idxs
    for idx in idxs:
        for key in ERROR_KEYS:
            np.testing.assert_array_equal(two[idx][key], one[idx][key])


def test_cli_prints_eval_py_tables(artifact_sets):
    """`python -m nopesac_torch.engine.offline_eval` prints, in each mode,
    the lines that eval.py's main prints on the same files, the echo of the
    parsed flags included."""
    pth, cont, dsjson = artifact_sets["imperfect"]
    for mode, extra in (("camera", []), ("matching", []), ("AP", ["--num-process", "2"])):
        flags = ["--rcnn-cached-file", pth, "--optimized-dict-path", cont,
                 "--dataset-json", dsjson, "--dataset-phase", "synth", "--evaluate", mode] + extra
        proc = subprocess.run([sys.executable, "-m", "nopesac_torch.engine.offline_eval"]
                              + flags, cwd=REPO, env=SUBPROCESS_ENV,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        ref = subprocess.run([sys.executable, "eval.py"] + flags, cwd=REPO, env=SUBPROCESS_ENV,
                             capture_output=True, text=True, timeout=300)
        assert ref.returncode == 0, ref.stderr[-3000:]
        assert proc.stdout.splitlines() == ref.stdout.splitlines(), mode


def test_camera_bins_equal_the_jax_package():
    rng = np.random.default_rng(0)
    for kind in ("mp3d", "scannet"):
        ours, theirs = CameraBins(dataset=kind), JaxCameraBins(dataset=kind)
        np.testing.assert_array_equal(ours.trans_centers, theirs.trans_centers)
        np.testing.assert_array_equal(ours.rots_centers, theirs.rots_centers)
        for _ in range(50):
            t, q = rng.normal(size=3) * 2, rng.normal(size=4)
            assert ours.xyz2class(*t) == theirs.xyz2class(*t)
            assert ours.quat2class(*q) == theirs.quat2class(*q)
            c = int(rng.integers(32))
            np.testing.assert_array_equal(ours.class2xyz(c), theirs.class2xyz(c))
            np.testing.assert_array_equal(ours.class2quat(c), theirs.class2quat(c))


@pytest.mark.parametrize("kind", ["mp3d", "scannet"])
def test_camera_branch_cached_rel_camera_equals_the_jax_package(kind, tmp_path):
    """The dataset kind's bin centres decode the top-k logits, each
    topk == -1 selects that field's cached GT, a pair not in the file is a
    KeyError."""
    rng = np.random.default_rng(3)
    pairs = [{"0": {"file_name": f"a{i}.png"}, "1": {"file_name": f"b{i}.png"}} for i in range(4)]
    path = str(tmp_path / "cached_cam.pkl")
    with open(path, "wb") as f:
        pickle.dump({"keys": [p["0"]["file_name"] + p["1"]["file_name"] for p in pairs],
                     "logits_sms": {"tran": rng.random((4, 32)), "rot": rng.random((4, 32))},
                     "gts": {"tran": list(rng.normal(size=(4, 3))),
                             "rot": [_unit(q) for q in rng.normal(size=(4, 4))]}}, f)
    ours = CameraBranch(kind, path)
    theirs = JaxCameraBranch(dataset=kind, cached_logits_path=path)
    for topk in ((0, 0), (2, 1), (-1, 0), (0, -1), (-1, -1)):
        a = theirs.cached_rel_camera(pairs[::-1], *topk)
        b = ours.cached_rel_camera(pairs[::-1], *topk)
        for x, y in zip(a, b):
            assert list(x) == list(y)
            for key in x:
                np.testing.assert_array_equal(y[key], x[key], err_msg=f"{topk} {key}")
        if topk[0] == -1:
            assert b[0]["position_prob"] == 1.0
        else:
            assert b[0]["position"].tolist() in ours.bins.trans_centers.tolist()
    with pytest.raises(KeyError, match="not present"):
        ours.cached_rel_camera([{"0": {"file_name": "x.png"}, "1": {"file_name": "y.png"}}])
