"""The pose-refinement ablations and the depth branch at inference, in the port
against the JAX package: TEST.POSE_REFINEMENT_WITH_GT_MATCHERS (with and
without Gaussian noise on the GT planes), the SparsePlanes top-1 camera
(MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON) and MODEL.DEPTH_ON.

The host halves (`perturb_planes`, `gt_geo_from_samples`) must be bit-equal
to JAX's on the same generator. One JAX `Trainer` of the tiny config of
tests/test_torch_eval.py with DEPTH_ON and the noisy GT-matcher runs
`Trainer.test` over 3 pairs (TEST.IMS_PER_BATCH 4: one padded batch, whose
repeated tail draws noise too); its weights go into the port with
`state_dict_from_jax` and the port's `EvalRunner.test` must give the same
metric keys, equal AP and matching values, camera errors within 1e-3 and
depth_l1_dist within 1e-4 relative. The JAX trainer's own compiled eval step
(gt_geo, no noise) and the port's on the same batch: depth0/depth1 within
1e-4 of their largest value, the cameras within 1e-3. Then
`camera_inference` on injected features and planes, as
tests/test_torch_slice.py does, with gt_geo and with init_cam: num_matches and
the assignments equal, log-scores within 1.5e-3, cameras within 1e-3.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.synthetic import make_dataset as jax_make_dataset
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.engine.trainer import gt_geo_from_samples as jax_gt_geo_from_samples
from nopesac_tpu.engine.trainer import perturb_planes as jax_perturb_planes

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.mapper import PairMapper
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
from nopesac_torch.engine.test import EvalRunner, gt_geo_from_samples, perturb_planes
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

H, W = 96, 128
NQ = 50
PAIRS = 3
BS = 4
CAM_TOL = 1e-3  # tests/test_torch_slice.py
LOG_SCORE_TOL = 1.5e-3
DEPTH_TOL = 1e-4  # of max |JAX depth|
CAMERA_ERRORS = ("T median err", "T mean err", "R median err", "R mean err")
PLANE_ERRORS = ("mean_normal", "median_normal", "mean_offset", "median_offset")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------ host halves

@pytest.mark.parametrize("seed,scales", [(0, (0.1, 10.0)), (7, (0.5, 30.0))])
def test_perturb_planes_is_bit_equal_to_jax(seed, scales):
    planes = np.random.default_rng(seed).normal(0, 2, (9, 3)).astype(np.float32)
    planes[[2, 5]] = 0.0  # zero rows stay zero
    ours = perturb_planes(planes, np.random.default_rng(seed), *scales)
    theirs = jax_perturb_planes(planes, np.random.default_rng(seed), *scales)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert not ours[[2, 5]].any() and not np.array_equal(ours, planes)


@pytest.mark.parametrize("noise", [False, True])
def test_gt_geo_from_samples_is_bit_equal_to_jax(noise):
    """Over a padded batch (the last pair repeated), pair by pair, view 0 then
    view 1, so the repeats draw noise too; the generator ends in one state."""
    pairs, jpairs = make_dataset(3, 4, seed=2, h=H, w=W), jax_make_dataset(3, 4, seed=2, h=H, w=W)
    samples = [PairMapper(NQ, (H, W), is_train=False)(p) for p in pairs]
    jsamples = [JaxPairMapper(is_train=False, image_size=(H, W), num_queries=NQ,
                              raw_uint8=True)(p) for p in jpairs]
    pad = lambda xs: list(xs) + [xs[-1]]  # noqa: E731
    rngs = [np.random.default_rng(5) if noise else None for _ in range(2)]
    ours = gt_geo_from_samples(pad(pairs), pad(samples), NQ, noise_rng=rngs[0])
    theirs = jax_gt_geo_from_samples(pad(jpairs), pad(jsamples), NQ, noise_rng=rngs[1])
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours["params0"][:, :4].any() and not ours["params0"][:, 4:].any()
    if noise:
        assert rngs[0].random() == rngs[1].random()
        # the repeated tail pair drew its own noise
        assert not np.array_equal(ours["params0"][2], ours["params0"][3])


# ------------------------------------------------- the entry point (Trainer.test)

def _tiny_cfgs(out_dir, extra=()):
    """tests/test_torch_eval.py's tiny config with DEPTH_ON and the noisy
    GT-matcher, for both packages."""
    cfgs = []
    for make, sub in ((jax_get_cfg, "jax"), (get_cfg, "port")):
        cfg = make()
        cfg.merge_from_list([
            "MODEL.MATCHING_HEAD.SINKHORN_ITERS", "10", "MODEL.EMBEDDING_ON", "True",
            "MODEL.CAMERA_ON", "True", "MODEL.CAMERA_HEAD.NAME", "PlaneCameraHead",
            "MODEL.CAMERA_HEAD.REFINE_ON", "True", "MODEL.CAMERA_HEAD.CAM_REC_ON", "True",
            "MODEL.SEM_SEG_HEAD.PARAM_ON", "True", "MODEL.SEM_SEG_HEAD.CENTER_ON", "True",
            "MODEL.DEPTH_ON", "True", "TEST.POSE_REFINEMENT_WITH_GT_MATCHERS", "True",
            "TEST.POSE_REFINEMENT_WITH_GT_NOISE_MATCHERS", "True", "TEST.EVAL_FULL_SCENE", "True",
            "TEST.IMS_PER_BATCH", str(BS), "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "1",
            "INPUT.IMAGE_SIZE", f"({H}, {W})", "OUTPUT_DIR", os.path.join(out_dir, sub),
            *extra])
        cfg.freeze()
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def entry_point(tmp_path_factory):
    from nopesac_tpu.engine.trainer import Trainer

    out = str(tmp_path_factory.mktemp("ablations"))
    jcfg, tcfg = _tiny_cfgs(out)
    trainer = Trainer(jcfg, image_hw=(H, W), training=False)
    ref = trainer.test(dataset_list=jax_make_dataset(n_pairs=PAIRS, n_planes=4, h=H, w=W, seed=3))
    variables = {"params": trainer.state.params, "batch_stats": trainer.state.batch_stats}
    state = jax.tree_util.tree_map(np.asarray, (variables["params"], variables["batch_stats"]))
    model = build_model_from_cfg(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(*state, image_size=(H, W)), strict=True)
    got = EvalRunner(tcfg, model).test(
        dataset_list=make_dataset(n_pairs=PAIRS, n_planes=4, h=H, w=W, seed=3))
    return dict(trainer=trainer, variables=variables, model=model, ref=ref, got=got,
                cfgs=(jcfg, tcfg))


def test_entry_point_with_noisy_gt_matcher_and_depth_matches_jax(entry_point):
    ref, got = entry_point["ref"], entry_point["got"]
    assert list(got) == list(ref)
    assert {"depth_l1_dist", "T median err", "R median err", "mask_ap@0.5"} <= set(ref)
    for k, v in ref.items():
        if k in CAMERA_ERRORS:
            assert abs(got[k] - v) <= CAM_TOL, (k, got[k], v)
        elif k == "depth_l1_dist":
            assert abs(got[k] - v) <= 1e-4 * abs(v), (got[k], v)
        elif k in PLANE_ERRORS:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
        else:  # AP, matching and accuracy percentages
            assert got[k] == v, (k, got[k], v)


def test_eval_step_with_gt_geo_and_depth_matches_jax(entry_point):
    """The JAX trainer's compiled eval step (gt_geo, DEPTH_ON) and the
    port's on the same padded batch and the same GT geometry."""
    trainer, (jcfg, tcfg) = entry_point["trainer"], entry_point["cfgs"]
    key = next(k for k in trainer._eval_steps if k[0] and not k[1])
    jstep = trainer._eval_steps[key]
    pairs = make_dataset(n_pairs=BS, n_planes=4, h=H, w=W, seed=9)
    samples = [PairMapper(NQ, (H, W), is_train=False)(p) for p in pairs]
    geo = gt_geo_from_samples(pairs, samples, NQ)
    imgs = [np.stack([s[f"image{v}"] for s in samples]) for v in ("0", "1")]
    ref = jstep(entry_point["variables"], *[jnp.asarray(i) for i in imgs],
                {k: jnp.asarray(v) for k, v in geo.items()})
    ref = jax.tree_util.tree_map(np.asarray, ref)
    step = make_eval_step(entry_point["model"], H, W, tcfg.MODEL.PIXEL_MEAN,
                          tcfg.MODEL.PIXEL_STD)
    got = step(*[torch.from_numpy(i) for i in imgs], gt_geo=geo)
    fr, fg = _flat(ref), _flat(got)
    assert sorted(fr) == sorted(fg)
    for k, r in fr.items():
        assert fg[k].shape == r.shape and fg[k].dtype == getattr(torch, str(r.dtype)), k
    for v in ("depth0", "depth1"):
        assert ref[v].shape == (BS, H, W, 1)
        np.testing.assert_allclose(got[v].numpy(), ref[v], rtol=0,
                                   atol=DEPTH_TOL * np.abs(ref[v]).max(), err_msg=v)
    np.testing.assert_array_equal(got["num_matches"].numpy(), ref["num_matches"])
    np.testing.assert_array_equal(got["num_matches"].numpy(), geo["corr_valid"].sum(1))
    for k, r in _flat(ref["cameras"]).items():
        np.testing.assert_allclose(_flat(got["cameras"])[k].numpy(), r, atol=CAM_TOL, rtol=0,
                                   err_msg=k)
    # the same step without gt_geo refines on the predicted matches
    plain = _flat(step(*[torch.from_numpy(i) for i in imgs])["cameras"])
    assert any(not torch.equal(plain[k], v) for k, v in _flat(got["cameras"]).items())


# ------------------------------------------ camera_inference on injected inputs

def camera_inputs(seed, pairs=2):
    """tests/test_torch_slice.py's injected features and planes (view 1 a
    noisy permutation of view 0), and GT planes with correspondences."""
    rng = np.random.default_rng(seed)

    def feat(c, s):
        return np.abs(rng.normal(0, 0.5, (2 * pairs, c, H // s, W // s))).astype(np.float32)

    feats = {"res3": feat(512, 8), "res4": feat(1024, 16), "res5": feat(2048, 32)}
    qf0 = rng.normal(0, 1, (pairs, NQ, 256)).astype(np.float32)
    perm = rng.permutation(NQ)
    qf1 = (qf0[:, perm] + rng.normal(0, 0.1, qf0.shape)).astype(np.float32)
    p0 = rng.normal(0, 1, (pairs, NQ, 3)).astype(np.float32)
    p1 = (p0[:, perm] + rng.normal(0, 0.05, p0.shape)).astype(np.float32)
    v0 = rng.random((pairs, NQ)) < 0.5
    geo = {"params0": np.zeros((pairs, NQ, 3), np.float32),
           "params1": np.zeros((pairs, NQ, 3), np.float32),
           "corr_idx1": np.zeros((pairs, NQ), np.int32), "corr_idx2": np.zeros((pairs, NQ), np.int32),
           "corr_valid": np.zeros((pairs, NQ), bool)}
    for i, (n, m) in enumerate(((6, 4), (3, 1))[:pairs]):  # planes per view, correspondences
        geo["params0"][i, :n] = rng.normal(0, 2, (n, 3))
        geo["params1"][i, :n] = rng.normal(0, 2, (n, 3))
        geo["corr_idx1"][i, :m] = rng.permutation(n)[:m]
        geo["corr_idx2"][i, :m] = rng.permutation(n)[:m]
        geo["corr_valid"][i, :m] = True
    return feats, (qf0, qf1, p0, p1, v0, v0[:, perm]), geo


def _init_cam(pairs=2):
    """A non-unit pose per pair, the first with w < 0."""
    rng = np.random.default_rng(4)
    rot = rng.normal(0, 1, (pairs, 4)).astype(np.float32) * 3.0
    rot[0, 0] = -abs(rot[0, 0])
    rot[1:, 0] = np.abs(rot[1:, 0])
    return {"tran": rng.normal(0, 1, (pairs, 3)).astype(np.float32), "rot": rot}


def run_camera_inference(entry_point, gt_geo=None, init_cam=None):
    trainer = entry_point["trainer"]
    jmodel, variables = trainer.model, entry_point["variables"]
    feats, rest, geo = camera_inputs(3)
    kw = {}
    if gt_geo is not None:
        kw["gt_geo"] = geo
    if init_cam is not None:
        kw["init_cam"] = init_cam
    jfeats = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in feats.items()}
    ref = jax.jit(lambda v, f, a, k: jmodel.apply(v, f, *a, **k, method=jmodel.camera_inference))(
        variables, jfeats, [jnp.asarray(a) for a in rest],
        jax.tree_util.tree_map(jnp.asarray, kw))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    model = entry_point["model"]
    tkw = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in kw.items()}
    with torch.no_grad():
        got = model.camera_inference({k: torch.from_numpy(v) for k, v in feats.items()},
                                     *[torch.from_numpy(np.asarray(a)) for a in rest], **tkw)
    return ref, got, geo


def _check_camera_inference(ref, got):
    np.testing.assert_array_equal(got["num_matches"].numpy(), ref["num_matches"])
    np.testing.assert_array_equal(got["assignment_beforeRef"].numpy(), ref["assignment_beforeRef"])
    np.testing.assert_array_equal(got["assignment"].numpy(), ref["assignment"])
    keep = np.abs(ref["log_scores"]) < 1e4
    np.testing.assert_allclose(got["log_scores"].numpy()[keep], ref["log_scores"][keep],
                               atol=LOG_SCORE_TOL, rtol=0)
    for key, r in _flat({"cameras": ref["cameras"], "onePP": ref["camera_onePP"]}).items():
        g = _flat({"cameras": got["cameras"], "onePP": got["camera_onePP"]})[key].numpy()
        np.testing.assert_allclose(g, r, atol=CAM_TOL, rtol=0, err_msg=key)


def test_camera_inference_with_gt_geo_matches_jax(entry_point):
    """The refinement's sequence from the GT correspondences (4 and 1 per
    pair: the m > 1 and m == 1 branches); the matching stays the
    prediction's."""
    ref, got, geo = run_camera_inference(entry_point, gt_geo=True)
    np.testing.assert_array_equal(ref["num_matches"], geo["corr_valid"].sum(1))
    assert ref["assignment_beforeRef"].sum() > 0
    _check_camera_inference(ref, got)
    # without gt_geo the sequence is the predicted assignment's
    _, plain, _ = run_camera_inference(entry_point)
    assert not torch.equal(plain["num_matches"], got["num_matches"])


def test_camera_inference_with_init_cam_matches_jax(entry_point, monkeypatch):
    """The given pose, normalised and sign-canonical, is camera_init; the
    PixelCameraHead does not run."""
    def no_pixel_camera(*args, **kwargs):
        raise AssertionError("the PixelCameraHead ran under init_cam")

    monkeypatch.setattr(entry_point["model"].camera_head, "pixel_camera", no_pixel_camera)
    cam = _init_cam()
    ref, got, _ = run_camera_inference(entry_point, init_cam=cam)
    _check_camera_inference(ref, got)
    want = cam["rot"] / np.linalg.norm(cam["rot"], axis=1, keepdims=True)
    want = np.where(want[:, :1] < 0, -want, want)
    np.testing.assert_allclose(got["cameras"]["camera_init"]["rot"].numpy(), want, atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got["cameras"]["camera_init"]["tran"].numpy(), cam["tran"])


def test_init_cam_needs_cam_rec_on(entry_point, tmp_path):
    _, tcfg = entry_point["cfgs"]
    cfg = tcfg.clone()
    cfg.defrost()
    cfg.MODEL.CAMERA_HEAD.CAM_REC_ON = False
    model = build_model_from_cfg(cfg, device="cpu", seed=0)
    feats, rest, _ = camera_inputs(3)
    cam = {k: torch.from_numpy(v) for k, v in _init_cam().items()}
    with torch.no_grad(), pytest.raises(ValueError, match="CAM_REC_ON"):
        model.camera_inference({k: torch.from_numpy(v) for k, v in feats.items()},
                               *[torch.from_numpy(np.asarray(a)) for a in rest], init_cam=cam)
    cfg.MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON = True
    cfg.MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_PATH = str(tmp_path / "missing.pkl")
    with pytest.raises(ValueError, match="CAM_REC_ON"):
        EvalRunner(cfg, model).test(dataset_list=make_dataset(1, 2, seed=1, h=H, w=W))


def test_sp_topcam_through_the_entry_point(entry_point, tmp_path):
    """EvalRunner.test with INFERENCE_SP_TOPCAM_ON reads each pair's pose from
    the pickle (keyed "<image_id0>-<image_id1>", one quaternion negated):
    the written camera_init is that pose, normalised and sign-canonical, as
    tests/test_end_to_end.py checks for the JAX package."""
    _, tcfg = entry_point["cfgs"]
    data = make_dataset(n_pairs=PAIRS, n_planes=4, h=H, w=W, seed=7)
    sp = {}
    for i, d in enumerate(data):
        q = np.asarray(d["rel_pose"]["rotation"], np.float32) * (-1.0 if i == 0 else 2.0)
        sp[d["0"]["image_id"] + "-" + d["1"]["image_id"]] = {
            "position": np.asarray(d["rel_pose"]["position"], np.float32), "rotation": q}
    path = tmp_path / "sp_top1.pkl"
    with open(path, "wb") as f:
        pickle.dump(sp, f)
    cfg = tcfg.clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_ON", "True",
                         "MODEL.CAMERA_HEAD.INFERENCE_SP_TOPCAM_PATH", str(path),
                         "OUTPUT_DIR", str(tmp_path / "out")])
    results = EvalRunner(cfg, entry_point["model"]).test(dataset_list=data)
    assert "R median err" in results and "depth_l1_dist" in results
    preds = torch.load(tmp_path / "out" / "NopeSAC_instances_predictions.pth", weights_only=False)
    for p, d in zip(preds, data):
        want = np.asarray(d["rel_pose"]["rotation"], np.float32)
        want = want / np.linalg.norm(want)
        want = -want if want[0] < 0 else want
        np.testing.assert_allclose(p["camera_init"]["pred"]["rot"], want, atol=1e-5)
        np.testing.assert_allclose(p["camera_init"]["pred"]["tran"],
                                   np.asarray(d["rel_pose"]["position"], np.float32), atol=1e-5)


def test_bf16_dtypes_match_jax(entry_point):
    """Under MODEL.COMPUTE_DTYPE bfloat16: the depth maps f32, the gt_geo
    sequence and so the cameras in the camera head's bf16, the log-scores
    f32, as jax.eval_shape of the JAX eval step gives them."""
    jcfg, tcfg = (c.clone() for c in entry_point["cfgs"])
    for c in (jcfg, tcfg):
        c.defrost()
        c.MODEL.COMPUTE_DTYPE = "bfloat16"
    jmodel = jax_build_model(jcfg)
    pairs = make_dataset(n_pairs=2, n_planes=4, h=H, w=W, seed=9)
    samples = [PairMapper(NQ, (H, W), is_train=False)(p) for p in pairs]
    geo = gt_geo_from_samples(pairs, samples, NQ)
    imgs = [np.stack([s[f"image{v}"] for s in samples]).astype(np.float32) for v in ("0", "1")]
    shapes = jax.eval_shape(
        lambda v, a, b, g: jmodel.apply(v, a, b, out_h=H, out_w=W, gt_geo=g,
                                        method=jmodel.inference),
        entry_point["variables"], *[jnp.asarray(i) for i in imgs],
        {k: jnp.asarray(v) for k, v in geo.items()})
    model = build_model_from_cfg(tcfg, device="cpu")
    model.load_state_dict(entry_point["model"].state_dict(), strict=True)
    step = make_eval_step(model, H, W, tcfg.MODEL.PIXEL_MEAN, tcfg.MODEL.PIXEL_STD)
    got = step(*[torch.from_numpy(np.stack([s[f"image{v}"] for s in samples]))
                 for v in ("0", "1")], gt_geo=geo)
    fr, fg = _flat(jax.tree_util.tree_map(lambda s: s, shapes)), _flat(got)
    assert sorted(fr) == sorted(fg)
    for k, s in fr.items():
        assert str(fg[k].dtype) == f"torch.{s.dtype}" and tuple(fg[k].shape) == s.shape, \
            (k, fg[k].dtype, s.dtype)
    assert fg["depth0"].dtype == torch.float32
    assert fg["cameras.camera.rot"].dtype == torch.bfloat16
    assert all(torch.isfinite(fg[k].float()).all() for k in fg if fg[k].is_floating_point())
