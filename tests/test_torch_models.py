"""The port's modules against the JAX package's on shared weights: ResNet-50
res2..res5, the PlaneTR head, select_planes in its three regimes, the
matching head's log-scores and the NOPE-SAC refinement. One JAX init at
96x128 (perturbed as in test_torch_slice) is carried into the port with
`state_dict_from_jax`; every module gets the same numpy inputs on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.models import camera_head as jcam

from nopesac_torch.engine.predict import build_model_from_cfg
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

from test_torch_slice import CONFIG, H, W, _cfgs, perturb  # noqa: F401  (shared setup)

MODULE_TOL = 1e-4  # rel + abs
LOG_SCORE_TOL = 1.5e-3  # PARITY.md "MatchingHead full forward"
B = 2


def t(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return t(np.asarray(a).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((B, H, W, 3), jnp.float32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(1), x, x, out_h=H, out_w=W,
                                            method=jmodel.inference))()
    variables = perturb(variables, seed=1)
    model = build_model_from_cfg(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                              image_size=(H, W)), strict=True)
    return jmodel, variables, model


def _apply(models, fn, *args):
    jmodel, variables, _ = models
    out = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn))(variables, *args)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def detected(models):
    """JAX backbone features and head outputs on seeded normalised images."""
    x = np.random.default_rng(0).normal(0, 1, (2 * B, H, W, 3)).astype(np.float32)
    feats = _apply(models, lambda m, x: m.backbone(x), jnp.asarray(x))
    head, hs = _apply(models, lambda m, f: m.plane_head(f), feats)
    return x, feats, head, hs


def close(got, ref, tol=MODULE_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol, atol=tol, err_msg=msg)


def test_resnet(models, detected):
    x, feats, _, _ = detected
    with torch.no_grad():
        got = models[2].backbone(nchw(x))
    for name in ("res2", "res3", "res4", "res5"):
        close(got[name].numpy().transpose(0, 2, 3, 1), feats[name], msg=name)


def test_plane_head(models, detected):
    _, feats, head, hs = detected
    with torch.no_grad():
        out, qf = models[2].sem_seg_head({k: nchw(v) for k, v in feats.items()})
    close(qf.numpy(), hs, msg="query features")
    for key in ("pred_logits", "pred_mask_logits", "pred_params", "pred_centers"):
        close(out[key].numpy(), head[key], msg=key)
    close(out["pixel_centers"].numpy().transpose(0, 2, 3, 1), head["pixel_centers"])


def _select_both(models, outputs, out_h, out_w):
    jmodel, _, model = models
    ref = jmodel.bind({"params": {}}).select_planes(
        {k: jnp.asarray(v) for k, v in outputs.items()}, out_h=out_h, out_w=out_w)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got = model.select_planes({k: t(v) for k, v in outputs.items()}, out_h, out_w)
    return ref, got


def _check_select(ref, got):
    for key in ("valid", "params", "seg_gated", "score"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    np.testing.assert_allclose(got["centers"].numpy(), ref["centers"], atol=1e-6, rtol=0)


def test_select_planes_on_head_outputs(models, detected):
    head = detected[2]
    outputs = {k: head[k] for k in ("pred_logits", "pred_params", "pred_mask_logits")}
    _check_select(*_select_both(models, outputs, H, W))


def _synthetic_outputs(regime, nq=50, h=24, w=32):
    """Head outputs that put select_planes in one regime for every view."""
    rng = np.random.default_rng({"normal": 0, "zero": 1, "filtered": 2}[regime])
    logits = np.tile([-3.0, 3.0], (B, nq, 1)).astype(np.float32)
    masks = np.full((B, nq, h, w), -8.0, np.float32)
    if regime == "normal":
        # ten confident planes, each owning a block of the image
        for q in range(10):
            logits[:, q] = [3.0 + 0.1 * q, -3.0]
            r, c = divmod(q, 5)
            masks[:, q, r * 12:(r + 1) * 12, c * 6:(c + 1) * 6 + 2] = rng.uniform(2, 6)
    elif regime == "zero":
        # nothing above the plane-score threshold; view 0's fallback has an
        # empty gated mask (pixel (0, 0) forced on), view 1's a real one
        logits[:, 7] = [0.32, 0.0]
        masks[1, 7, :12] = 8.0
    else:
        # two confident planes that split the image: every overlap fails
        logits[:, :2] = [3.0, -3.0]
        masks[:, 0] = 2.0
        masks[:, 1] = 2.0
        masks[:, 1, :, w // 2:] = 3.0
    params = rng.normal(0, 1, (B, nq, 3)).astype(np.float32)
    return {"pred_logits": logits, "pred_params": params, "pred_mask_logits": masks}


@pytest.mark.parametrize("regime", ["normal", "zero", "filtered"])
def test_select_planes_regimes(models, regime):
    ref, got = _select_both(models, _synthetic_outputs(regime), H, W)
    _check_select(ref, got)
    n_valid = ref["valid"].sum(axis=1)
    if regime == "normal":
        assert (n_valid >= 5).all()
    else:
        assert (n_valid == 1).all()
    if regime == "zero":
        seg = ref["seg_gated"][0]
        q = int(np.argmax(ref["valid"][0]))
        assert seg[0, 0] == q and (seg == q).sum() == 1


def _matching_inputs(seed, nq=50):
    rng = np.random.default_rng(seed)
    qf0 = rng.normal(0, 1, (B, nq, 256)).astype(np.float32)
    perm = rng.permutation(nq)
    qf1 = (qf0[:, perm] + rng.normal(0, 0.1, qf0.shape)).astype(np.float32)
    p0 = rng.normal(0, 1, (B, nq, 3)).astype(np.float32)
    p1 = (p0[:, perm] + rng.normal(0, 0.05, p0.shape)).astype(np.float32)
    quat = rng.normal(0, 1, (B, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cam = np.concatenate([rng.normal(0, 1, (B, 3)), quat], axis=1).astype(np.float32)
    v0 = rng.random((B, nq)) < 0.6
    return qf0, qf1, cam, p0, p1, v0, v0[:, perm]


def test_matching_head(models):
    qf0, qf1, cam, p0, p1, v0, v1 = _matching_inputs(4)
    ref = _apply(models, lambda m, *a: m.matching_head(*a[:5], row_masks=a[5], col_masks=a[6]),
                 *[jnp.asarray(a) for a in (qf0, qf1, cam, p0, p1, v0, v1)])
    with torch.no_grad():
        got = models[2].matching_head(t(qf0), t(qf1), t(cam), t(p0), t(p1),
                                      row_masks=t(v0), col_masks=t(v1)).numpy()
    keep = np.abs(ref) < 1e4  # leave out the -1e5 masked band
    assert keep.sum() > B * 20 * 20
    np.testing.assert_allclose(got[keep], ref[keep], atol=LOG_SCORE_TOL, rtol=0)


def test_refine(models):
    rng = np.random.default_rng(5)
    nq = 50
    assign = np.zeros((B, nq, nq), np.float32)
    for b, m in enumerate((7, 1)):  # m > 1 and the m == 1 case
        rows = rng.choice(nq, m, replace=False)
        assign[b, rows, rng.choice(nq, m, replace=False)] = 1.0
    p0 = rng.normal(0, 1, (B, nq, 3)).astype(np.float32)
    p1 = rng.normal(0, 1, (B, nq, 3)).astype(np.float32)
    geo, valid, _ = jcam.build_geo_sequence(jnp.asarray(p0), jnp.asarray(p1),
                                            jnp.asarray(assign), nq)
    quat = rng.normal(0, 1, (B, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    tran = rng.normal(0, 1, (B, 3)).astype(np.float32)
    geo_global = jcam.warp_geo_sequence(geo, jnp.asarray(tran), jnp.asarray(quat))
    sig = jcam.compute_sig_seq(geo, jnp.asarray(tran), jnp.asarray(quat))
    tf = np.abs(rng.normal(0, 1, (B, 256))).astype(np.float32)
    rf = np.abs(rng.normal(0, 1, (B, 256))).astype(np.float32)
    args = [tf, rf, tran, quat, np.asarray(geo), np.asarray(valid), np.asarray(sig),
            np.asarray(geo_global)]
    ref = _apply(models, lambda m, *a: m.camera_head.refine(*a, clamp_scores=False),
                 *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = models[2].camera_head.refine(*[t(a) for a in args])
    for key, g in got.items():
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), ref[key], err_msg=key)
        else:
            close(g.numpy(), ref[key], msg=key)
