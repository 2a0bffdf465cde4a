"""The port's whole inference slice against the JAX package on shared weights.

One JAX init (inference_mp3d.yaml at 96x128, 10 Sinkhorn iterations, with
the BN statistics and norm affines perturbed so that they are exercised) is
carried into the port with `state_dict_from_jax`. The same seeded uint8 pairs
go through JAX `make_eval_step(..., pixel_mean, pixel_std)` on XLA:CPU and
the port's eval step on the CPU, where its kernels run their plain versions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.engine.train_step import make_eval_step as jax_make_eval_step
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model

from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "inference_mp3d.yaml")
H, W, ITERS, PAIRS = 96, 128, 10, 2
CAM_TOL = 1e-3
LOG_SCORE_TOL = 1.5e-3  # PARITY.md "MatchingHead full forward"


def _cfgs(cam_type="soft"):
    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(CONFIG)
        cfg.INPUT.IMAGE_SIZE = (H, W)
        cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS = ITERS
        cfg.MODEL.CAMERA_HEAD.INFERENCE_OUT_CAM_TYPE = cam_type
        out.append(cfg)
    return out


def perturb(variables, seed=0):
    """Non-trivial BN statistics and norm affines, and a plane-class bias
    that leaves a mix of valid and invalid queries."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    params, stats = tree["params"], tree.get("batch_stats", {})

    def walk(node, fn, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, fn, path + (k,))
            else:
                node[k] = fn(path + (k,), v)

    def pert(path, v):
        leaf = path[-1]
        if leaf == "mean":
            return (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
        if leaf == "var":
            return (v * rng.uniform(0.8, 1.25, v.shape)).astype(np.float32)
        if leaf == "scale" and v.ndim <= 2:
            return (v * rng.uniform(0.9, 1.1, v.shape)).astype(np.float32)
        if leaf == "bias" and "plane_prob" not in path and v.ndim <= 2 and "BatchNorm_0" in path:
            return (v + rng.normal(0, 0.02, v.shape)).astype(np.float32)
        return v

    walk(params, pert)
    walk(stats, pert)
    params["plane_head"]["plane_prob"]["bias"] = np.asarray([0.8, 0.0], np.float32)
    return {"params": params, "batch_stats": stats}


def images(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(2, PAIRS, H, W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((PAIRS, H, W, 3), jnp.float32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x, x, out_h=H, out_w=W,
                                            method=jmodel.inference))()
    variables = perturb(variables)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W))
    return jcfg, tcfg, variables, sd


def run_both(shared, cam_type, seed=1):
    jcfg, tcfg = _cfgs(cam_type)
    _, _, variables, sd = shared
    jmodel = jax_build_model(jcfg)
    jstep = jax.jit(jax_make_eval_step(jmodel, H, W, pixel_mean=jcfg.MODEL.PIXEL_MEAN,
                                       pixel_std=jcfg.MODEL.PIXEL_STD))
    u = images(seed)
    ref = jax.tree_util.tree_map(np.asarray, jstep(variables, jnp.asarray(u[0]),
                                                   jnp.asarray(u[1])))
    model = build_model_from_cfg(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    step = make_eval_step(model, H, W, tcfg.MODEL.PIXEL_MEAN, tcfg.MODEL.PIXEL_STD)
    got = step(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    return ref, got


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _check_cameras(ref, got):
    for key, r in _flat(ref["cameras"]).items():
        g = _flat(got["cameras"])[key].numpy()
        np.testing.assert_allclose(g, r, atol=CAM_TOL, rtol=0, err_msg=key)


def test_eval_step_matches_jax(shared):
    ref, got = run_both(shared, "soft")
    fr, fg = _flat(ref), _flat(got)
    assert sorted(fr) == sorted(fg)
    for key, r in fr.items():
        g = fg[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, (key, g.shape, g.dtype, r.shape, r.dtype)
    for view in ("view0", "view1"):
        np.testing.assert_array_equal(got[view]["valid"].numpy(), ref[view]["valid"])
        agree = (got[view]["seg_gated"].numpy() == ref[view]["seg_gated"]).mean()
        assert agree >= 0.999, (view, agree)
    r = ref["log_scores"]
    keep = np.abs(r) < 1e4  # leave out the -1e5 masked band
    np.testing.assert_allclose(got["log_scores"].numpy()[keep], r[keep], atol=LOG_SCORE_TOL, rtol=0)
    _check_cameras(ref, got)


def camera_inputs(seed):
    """Backbone features (res3..res5) of both views and detected planes with
    many valid, mutually matching queries: view 1 is a noisy permutation of
    view 0, so the refinement sees m > 1 matches and every
    INFERENCE_OUT_CAM_TYPE takes its own branch."""
    rng = np.random.default_rng(seed)
    nq = 50

    def feat(c, s):
        return np.abs(rng.normal(0, 0.5, (2 * PAIRS, c, H // s, W // s))).astype(np.float32)

    feats = {"res3": feat(512, 8), "res4": feat(1024, 16), "res5": feat(2048, 32)}
    qf0 = rng.normal(0, 1, (PAIRS, nq, 256)).astype(np.float32)
    perm = rng.permutation(nq)
    qf1 = (qf0[:, perm] + rng.normal(0, 0.1, qf0.shape)).astype(np.float32)
    p0 = rng.normal(0, 1, (PAIRS, nq, 3)).astype(np.float32)
    p1 = (p0[:, perm] + rng.normal(0, 0.05, p0.shape)).astype(np.float32)
    v0 = rng.random((PAIRS, nq)) < 0.5
    return feats, qf0, qf1, p0, p1, v0, v0[:, perm]


@pytest.mark.parametrize("cam_type", ["soft", "avg-all", "max-score", "min-cost"])
def test_camera_inference_matches_jax(shared, cam_type):
    jcfg, tcfg = _cfgs(cam_type)
    _, _, variables, sd = shared
    feats, *rest = camera_inputs(3)
    jmodel = jax_build_model(jcfg)
    jfeats = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in feats.items()}
    ref = jax.jit(lambda v, f, *a: jmodel.apply(v, f, *a, method=jmodel.camera_inference))(
        variables, jfeats, *[jnp.asarray(a) for a in rest])
    ref = jax.tree_util.tree_map(np.asarray, ref)
    model = build_model_from_cfg(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.camera_inference({k: torch.from_numpy(v) for k, v in feats.items()},
                                     *[torch.from_numpy(np.asarray(a)) for a in rest])
    assert (ref["num_matches"] > 1).all()
    np.testing.assert_array_equal(got["num_matches"].numpy(), ref["num_matches"])
    np.testing.assert_array_equal(got["assignment_beforeRef"].numpy(), ref["assignment_beforeRef"])
    np.testing.assert_array_equal(got["assignment"].numpy(), ref["assignment"])
    keep = np.abs(ref["log_scores"]) < 1e4
    np.testing.assert_allclose(got["log_scores"].numpy()[keep], ref["log_scores"][keep],
                               atol=LOG_SCORE_TOL, rtol=0)
    _check_cameras(ref, got)
    for key, r in _flat(ref["camera_onePP"]).items():
        np.testing.assert_allclose(got["camera_onePP"][key].numpy(), r, atol=CAM_TOL, rtol=0,
                                   err_msg=key)
