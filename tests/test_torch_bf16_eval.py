"""The port's bf16 inference policy (MODEL.COMPUTE_DTYPE bfloat16) against the
JAX package's, module by module and for the whole eval step.

One JAX init of inference_mp3d.yaml at 96x128 (10 Sinkhorn iterations,
`test_torch_slice.perturb`'s weights) is carried into the port with
`state_dict_from_jax`; the f32 state_dict loads strictly into the bf16
model. Each case runs the same seeded inputs through four versions: JAX in
f32 and in bf16, the port in f32 and in bf16 (its kernels' plain versions).
Eager PyTorch rounds after every op while XLA keeps f32 inside fused chains,
so the port cannot be bit-equal to JAX's bf16; it is held to JAX's own bf16
noise instead. For each output, with d_jax = max |JAX bf16 - JAX f32| and
u = one bf16 ulp at max |JAX f32| (2^(e - 7) for 2^e <= max |JAX f32| <
2^(e + 1), between 2^-8 and 2^-7 of it):
  * max |port bf16 - JAX bf16| <= max(1.5 d_jax, u). The floor is the least
    difference two bf16 values at that magnitude can have: the two may round
    the same value to neighbouring bf16 numbers (XLA rounds a fused chain
    once, eager PyTorch each op). 2^-8 max |JAX f32| is below one ulp at
    every magnitude, so it would forbid that difference;
  * the port really rounds where JAX does: wherever d_jax > u / 2, more than
    the one final rounding of a bf16 value can move it, the port's own
    deviation max |port bf16 - port f32| lies within [0.25, 4] x d_jax.
    Where d_jax <= u / 2 (a few numbers that lie near bf16 values, a mean
    over many pixels) one rounding more or less changes the deviation by as
    much as d_jax itself, and the ratio says nothing; each test has at least
    one output above u / 2;
  * the dtype of every boundary of the policy equals JAX's.
Each test's docstring gives the measured ratios (CPU): err = max |port
bf16 - JAX bf16| / d_jax, dev = the port's own deviation / d_jax, "-" where
d_jax <= u / 2.
"""
import json
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.engine.train_step import make_eval_step as jax_make_eval_step
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.models.camera_head import PlaneCameraHead as JaxCameraHead
from nopesac_tpu.models.plane_head import PlaneTRHead as JaxPlaneHead
from nopesac_tpu.models.resnet import ResNet as JaxResNet

from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
from nopesac_torch.models.camera_head import PlaneCameraHead
from nopesac_torch.models.plane_head import PlaneTRHead
from nopesac_torch.models.resnet import ResNet
from nopesac_torch.utils.weights import state_dict_from_jax
from test_torch_slice import H, PAIRS, _cfgs, _flat, images, perturb
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = "bfloat16"
RULE_MUL = 1.5            # of d_jax
ROUND_RANGE = (0.25, 4.0)  # the port's own bf16 deviation over d_jax
LABEL_SLACK = 0.005        # of pixels, beyond twice JAX bf16's own disagreement


def _np(t):
    """A torch tensor (bf16 widened exactly) or a JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype == jnp.bfloat16 else a


def _dtype(t):
    """The dtype name of a torch tensor or a JAX array ("float32", "bfloat16", ...)."""
    return str(t.dtype).replace("torch.", "")


def bf16_ulp(x):
    """One bf16 ulp at magnitude x: 2^(e - 7) for 2^e <= x < 2^(e + 1); 0 at 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def hold(name, j32, j16, p32, p16, keep=None, record=None):
    """The value and rounding rules of the module docstring on one output;
    records (err / d_jax, dev / d_jax or None where d_jax <= u / 2)."""
    j32, j16, p32, p16 = (_np(a) for a in (j32, j16, p32, p16))
    if keep is not None:
        j32, j16, p32, p16 = (a[keep] for a in (j32, j16, p32, p16))
    d_jax = float(np.abs(j16 - j32).max())
    err = float(np.abs(p16 - j16).max())
    dev = float(np.abs(p16 - p32).max())
    u = bf16_ulp(float(np.abs(j32).max()))
    bound = max(RULE_MUL * d_jax, u)
    assert err <= bound, (name, err, bound, d_jax)
    ratio = dev / d_jax if d_jax > u / 2 else None
    if ratio is not None:
        assert ROUND_RANGE[0] <= ratio <= ROUND_RANGE[1], (name, dev, d_jax)
    if record is not None:
        record[name] = (round(err / d_jax, 3) if d_jax > 0 else 0.0,
                        None if ratio is None else round(ratio, 3))


def rounds(record):
    """The outputs whose rounding `hold` checked (d_jax above half an ulp);
    a test needs one."""
    checked = [k for k, r in record.items() if r[1] is not None]
    assert checked, ("no output with d_jax above half a bf16 ulp", record)
    return checked


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((PAIRS, H, 128, 3), jnp.float32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x, x, out_h=H, out_w=128,
                                            method=jmodel.inference))()
    variables = perturb(variables)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, 128))
    models = {}
    for dt in ("float32", BF16):
        cfg = tcfg.clone()
        cfg.MODEL.COMPUTE_DTYPE = dt
        models[dt] = build_model_from_cfg(cfg, device="cpu")
        models[dt].load_state_dict(sd, strict=True)
    return variables, sd, models


def _features(seed):
    """Post-ReLU-like backbone features of 2 * PAIRS views at 96x128."""
    rng = np.random.default_rng(seed)
    shapes = {"res2": (256, 4), "res3": (512, 8), "res4": (1024, 16), "res5": (2048, 32)}
    return {k: np.abs(rng.normal(0, 0.5, (2 * PAIRS, c, H // s, 128 // s))).astype(np.float32)
            for k, (c, s) in shapes.items()}


def _nhwc(feats):
    return {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in feats.items()}


def _nchw(t):
    return np.asarray(t, np.float32).transpose(0, 3, 1, 2) if t.ndim == 4 else t


def _dtype_hooks(modules):
    """Forward hooks recording the output dtype of each named module."""
    seen = {}

    def hook(name):
        def fn(_, __, out):
            t = out[0] if isinstance(out, tuple) else out
            if isinstance(t, dict):
                t = next(iter(t.values()))
            seen[name] = t.dtype
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in modules.items()]
    return seen, handles


# ------------------------------------------------------------------ modules

def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("mode", ["eval", "train", "train_f32_blocks"])
def test_resnet(shared, mode):
    """res2..res5: eval in C = bf16 (all bf16); train with BT = bf16 (bf16
    stem and block interiors, f32 trunk); train with BT = f32 (all f32, equal
    to the f32 backbone whatever C is). Measured err / dev: eval res2 0.35 /
    1.00, res3 0.97 / 1.00, res4 0.92 / 0.93, res5 0.94 / 1.00; train res2
    0.19 / 1.00, res3 0.40 / 0.99, res4 0.66 / 0.93, res5 0.87 / 0.97."""
    variables, sd, _ = shared
    u = images(11).reshape(2 * PAIRS, H, 128, 3).astype(np.float32)
    x = (u - 128.0) / 64.0
    train = mode != "eval"
    bt = torch.float32 if mode == "train_f32_blocks" else torch.bfloat16
    refs, got = {}, {}
    for name, dt, bdt in (("f32", torch.float32, torch.float32),
                          ("bf16", torch.bfloat16, bt)):
        jdt, jbdt = (jnp.bfloat16 if d == torch.bfloat16 else jnp.float32 for d in (dt, bdt))
        refs[name] = JaxResNet(dtype=jdt, train_block_dtype=jbdt, remat=False).apply(
            {"params": variables["params"]["backbone"]}, jnp.asarray(x), train=train)
        net = ResNet(dtype=dt, train_dtype=bdt, remat=train)
        net.load_state_dict(_sub(sd, "backbone."), strict=True)
        net.train(train)
        seen, handles = _dtype_hooks({"stem": net.stem, "res2.0": net.res2[0]})
        with torch.no_grad():
            got[name] = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        for h in handles:
            h.remove()
        assert seen["stem"] == (bdt if train else dt)
        assert seen["res2.0"] == (torch.float32 if train else dt)
    record = {}
    for k in ("res2", "res3", "res4", "res5"):
        assert _dtype(got["bf16"][k]) == _dtype(refs["bf16"][k]), k
        if mode == "train_f32_blocks":
            assert torch.equal(got["bf16"][k], got["f32"][k]), k
        else:
            hold(k, *(_nchw(refs[n][k]) for n in ("f32", "bf16")), got["f32"][k],
                 got["bf16"][k], record=record)
    if record:
        rounds(record)
    print(mode, record)


def test_set_compute_dtype_owns_the_trunk_dtype():
    """`set_compute_dtype` on a built ResNet sets its trunk's eval dtype with
    its layers': an f32 backbone set to bf16 returns bf16 maps in eval mode
    and f32 maps in train mode."""
    from nopesac_torch.models.layers import set_compute_dtype

    net = set_compute_dtype(ResNet(), torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        assert {v.dtype for v in net(x).values()} == {torch.bfloat16}
        assert {v.dtype for v in net.train()(x).values()} == {torch.float32}


def _jax_dt(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_plane_head_pixel_path(shared, mode):
    """The plane head on the same f32 features: the pixel path (top-down
    decoder, pixel_embedding, pixel_plane_center) in C = bf16 in eval mode
    and in FT = bf16 in train mode (batch-statistics BN, dropout 0); the
    input projection, the transformer and the query-side heads f32; the mask
    logits f32. Measured err / dev: eval pred_mask_logits 0.80 / 1.05,
    pixel_centers 1.20 / 0.79; train 0.57 / 1.07 and 0.79 / 1.06;
    pred_logits and pred_params (f32 from f32 features) d_jax 0, the port
    within 1.5e-6 of max |f32|."""
    variables, sd, _ = shared
    train = mode == "train"
    feats = _features(21)
    p, stats = variables["params"]["plane_head"], variables["batch_stats"]["plane_head"]
    refs, got, inter = {}, {}, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        jhead = JaxPlaneHead(num_queries=50, dropout=0.0, dtype=_jax_dt(dt),
                             fpn_train_dtype=_jax_dt(dt))
        (out, _), state = jhead.apply({"params": p, "batch_stats": stats}, _nhwc(feats),
                                      train=train, mutable=["batch_stats", "intermediates"],
                                      capture_intermediates=True)
        refs[name], inter[name] = out, state["intermediates"]
        head = PlaneTRHead(num_queries=50, dropout=0.0, dtype=dt, fpn_train_dtype=dt)
        head.load_state_dict(_sub(sd, "sem_seg_head."), strict=True)
        head.train(train)
        seen, handles = _dtype_hooks({n: getattr(head, n) for n in (
            "input_proj", "context_SA", "context2plane_decoder", "top_down", "pixel_embedding",
            "plane_embedding", "pixel_plane_center")})
        with torch.no_grad():
            got[name], _ = head({k: torch.from_numpy(v) for k, v in feats.items()})
        for h in handles:
            h.remove()
        if name == "bf16":
            jseen = {"input_proj": inter[name]["input_proj"]["__call__"][0],
                     "top_down": inter[name]["top_down"]["__call__"][0],
                     "pixel_embedding": inter[name]["pixel_embedding"]["__call__"][0],
                     "pixel_plane_center": inter[name]["pixel_plane_center"]["__call__"][0]}
            for n, t in jseen.items():
                assert str(seen[n]).replace("torch.", "") == _dtype(t), n
            for n in ("context_SA", "context2plane_decoder", "plane_embedding"):
                assert seen[n] == torch.float32, n
            assert seen["top_down"] == torch.bfloat16
    record = {}
    for k in ("pred_mask_logits", "pixel_centers", "pred_logits", "pred_params"):
        assert _dtype(got["bf16"][k]) == _dtype(refs["bf16"][k]), k
        hold(k, *((_nchw if k == "pixel_centers" else _np)(refs[n][k]) for n in ("f32", "bf16")),
             got["f32"][k], got["bf16"][k], record=record)
    rounds(record)
    print(mode, record)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_pixel_camera_head(shared, mode):
    """PixelCameraHead (pixel decoder, conv stacks with their trainable BN,
    the correlation softmax, the pose regressors) in C = bf16 in both modes.
    Measured err / dev: eval tran 0.86 / 0.51, rot 1.87 / 1.00 (one ulp of
    0.64), tran_feat 0.70 / 1.00, rot_feat 0.95 / 0.83; train (batch
    statistics) 1.48 / 2.12, 0.22 / 0.93, 0.74 / 0.96, 0.64 / 1.06."""
    variables, sd, _ = shared
    train = mode == "train"
    feats = _features(31)
    var = {"params": variables["params"]["camera_head"],
           "batch_stats": variables["batch_stats"]["camera_head"]}
    refs, got = {}, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        jhead = JaxCameraHead(num_queries=50, dtype=_jax_dt(dt))
        refs[name], _ = jhead.apply(var, _nhwc(feats), train, method="pixel_camera",
                                    mutable=["batch_stats"])
        head = PlaneCameraHead((H, 128), 50, dtype=dt)
        head.load_state_dict(_sub(sd, "camera_head_list.0."), strict=True)
        head.train(train)
        seen, handles = _dtype_hooks({"pixel_decoder": head.pixel_decoder,
                                      "convs_trans": head.convs_trans})
        with torch.no_grad():
            got[name] = head.pixel_camera({k: torch.from_numpy(v) for k, v in feats.items()})
        for h in handles:
            h.remove()
        assert seen["pixel_decoder"] == seen["convs_trans"] == dt
    record = {}
    for k in ("tran", "rot", "tran_feat", "rot_feat"):
        assert _dtype(got["bf16"][k]) == _dtype(refs["bf16"][k]), k
        hold(k, *(refs[n][k] for n in ("f32", "bf16")), got["f32"][k], got["bf16"][k],
             record=record)
    rounds(record)
    print(mode, record)


def test_refine(shared):
    """The NOPE-SAC refinement in C = bf16 on f32 plane sequences and bf16
    poses and features: the hypotheses, their scores and the fused poses in
    bf16, the distances f32. Measured err / dev: trans_all 0.81 / -, rots_all
    1.05 / 1.26, score_rot 0 / 1.00, score_trans 0 / -, l2_dist 1.19 / 1.22,
    tran_soft 0 / -, rot_soft 0.78 / 0.77, tran_avg_excl 0.36 / 1.00,
    rot_avg_incl 0.41 / 0.85."""
    variables, sd, _ = shared
    rng = np.random.default_rng(41)
    b, m = PAIRS, 50
    n_valid = np.array([7, 12])
    valid = np.arange(m)[None] < n_valid[:, None]
    geo = (rng.normal(0, 1, (b, m, 6)) * valid[..., None]).astype(np.float32)
    tran = rng.normal(0, 0.5, (b, 3)).astype(np.float32)
    rot = rng.normal(0, 1, (b, 4)).astype(np.float32)
    rot = rot / np.linalg.norm(rot, axis=-1, keepdims=True)
    tf, rf = (np.abs(rng.normal(0, 1, (b, 256))).astype(np.float32) for _ in range(2))
    from nopesac_torch.models.camera_head import compute_sig_seq, warp_geo_sequence
    refs, got = {}, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # the poses and features arrive in the head's dtype, as from rot_rec/trans_rec
        tt, rt, tft, rft = (torch.from_numpy(a).to(dt) for a in (tran, rot, tf, rf))
        g = torch.from_numpy(geo)
        gg, sig = warp_geo_sequence(g, tt, rt), compute_sig_seq(g, tt, rt)
        args = [tft, rft, tt, rt, g, torch.from_numpy(valid), sig, gg]
        jargs = [jnp.asarray(_np(a)).astype(a.dtype == torch.bfloat16 and jnp.bfloat16
                                            or _np(a).dtype) for a in args]
        refs[name] = JaxCameraHead(num_queries=50, dtype=_jax_dt(dt)).apply(
            {"params": variables["params"]["camera_head"]}, *jargs, False, method="refine")
        head = PlaneCameraHead((H, 128), 50, dtype=dt)
        head.load_state_dict(_sub(sd, "camera_head_list.0."), strict=True)
        head.eval()
        with torch.no_grad():
            got[name] = head.refine(*args)
    record = {}
    for k in ("trans_all", "rots_all", "score_rot", "score_trans", "l2_dist", "tran_soft",
              "rot_soft", "tran_avg_excl", "rot_avg_incl"):
        assert _dtype(got["bf16"][k]) == _dtype(refs["bf16"][k]), k
        hold(k, *(refs[n][k] for n in ("f32", "bf16")), got["f32"][k], got["bf16"][k],
             record=record)
    rounds(record)
    print(record)


# --------------------------------------------------------------- eval slice

@pytest.fixture(scope="module")
def eval_outputs(shared):
    """The eval step of inference_mp3d.yaml (f32 and COMPUTE_DTYPE bfloat16)
    on the same seeded uint8 pairs: jitted JAX `make_eval_step` and the
    port's, the port's bf16 also with the fused-tail backbone."""
    variables, sd, models = shared
    u = images(1)
    out = {}
    for dt in ("float32", BF16):
        jcfg, tcfg = _cfgs()
        jcfg.MODEL.COMPUTE_DTYPE = dt
        jmodel = jax_build_model(jcfg)
        jstep = jax.jit(jax_make_eval_step(jmodel, H, 128, pixel_mean=jcfg.MODEL.PIXEL_MEAN,
                                           pixel_std=jcfg.MODEL.PIXEL_STD))
        out[f"jax_{dt}"] = _flat(jstep(variables, jnp.asarray(u[0]), jnp.asarray(u[1])))
        step = make_eval_step(models[dt], H, 128, tcfg.MODEL.PIXEL_MEAN, tcfg.MODEL.PIXEL_STD)
        out[f"port_{dt}"] = _flat(step(torch.from_numpy(u[0]), torch.from_numpy(u[1])))
    tcfg.MODEL.COMPUTE_DTYPE = BF16
    fused = build_model_from_cfg(tcfg, device="cpu", fuse_tail=True)
    fused.load_state_dict(sd, strict=True)
    step = make_eval_step(fused, H, 128, tcfg.MODEL.PIXEL_MEAN, tcfg.MODEL.PIXEL_STD)
    out["fused_bfloat16"] = _flat(step(torch.from_numpy(u[0]), torch.from_numpy(u[1])))
    return out


@pytest.mark.parametrize("port", ["port_bfloat16", "fused_bfloat16"])
def test_eval_step_bf16_matches_jax(eval_outputs, port):
    """Every output's dtype and shape equal JAX bf16's (cameras and the
    refinement's hypotheses bf16, log_scores, params and scores f32); valid
    planes and the number of matches equal; the cameras and log_scores by
    the rule; labels agree with JAX bf16 as well as JAX bf16 agrees with JAX
    f32, within twice its disagreement plus 0.5% of pixels. Measured err /
    dev, unfused: camera.rot (and its avgRef0, softRef0 copies) 0.73 / 1.00,
    camera_init.rot 1.93 / 1.03 (one ulp of 0.64), camera_init.tran 6.14 / -
    (one ulp, 1.2e-4, of 0.020; d_jax 2.0e-5), camera_initRec.rot 0.81 /
    1.00, the other translations 0 / 1.00 or 0 / -, log_scores 0.24 / -;
    fused: the same but camera_init.rot 0 / 1.00, camera_initRec.rot 0.05 /
    1.00, log_scores 0.27 / -. Labels differ from JAX bf16's on 0.33 and
    0.28 of the pixels of the two views (fused 0.37, 0.29), JAX bf16 from
    JAX f32 on 0.35 and 0.31 (seeded weights: near-equal probabilities)."""
    o = eval_outputs
    j32, j16, p32, p16 = o["jax_float32"], o["jax_bfloat16"], o["port_float32"], o[port]
    assert sorted(p16) == sorted(j16)
    for k, r in j16.items():
        assert tuple(p16[k].shape) == tuple(r.shape) and _dtype(p16[k]) == _dtype(r), (
            k, p16[k].dtype, r.dtype)
    for k in ("cameras.camera.rot", "cameras.camera_init.tran", "camera_onePP.score_rot"):
        assert p16[k].dtype == torch.bfloat16, k
    for k in ("log_scores", "view0.params", "view0.score"):
        assert p16[k].dtype == torch.float32, k
    for k in ("view0.valid", "view1.valid", "num_matches"):
        np.testing.assert_array_equal(_np(p16[k]), _np(j16[k]), err_msg=k)
    record = {}
    for k in [k for k in j16 if k.startswith("cameras.")] + ["log_scores"]:
        keep = np.abs(_np(j32[k])) < 1e4 if k == "log_scores" else None
        hold(k, j32[k], j16[k], p32[k], p16[k], keep=keep, record=record)
    labels = {}
    for view in ("view0", "view1"):
        seg = {n: _np(o[n][f"{view}.seg_gated"]) for n in o}
        own = (seg["jax_bfloat16"] != seg["jax_float32"]).mean()
        ours = (seg[port] != seg["jax_bfloat16"]).mean()
        labels[view] = (float(ours), float(own))
        assert ours <= 2 * own + LABEL_SLACK, (view, ours, own)
    rounds(record)
    print(port, labels, record)


# ------------------------------------------------------ evaluation entry point

def _artifact_types(tree):
    """The keys and leaf types/dtypes of an artifact tree."""
    if isinstance(tree, dict):
        return {k: _artifact_types(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_artifact_types(v) for v in tree]
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return (type(tree).__name__, str(tree.dtype), tuple(tree.shape))
    return type(tree).__name__


def test_entry_point_bf16_artifacts(tmp_path, capsys):
    """engine/test.py on smoke_synthetic.yaml's test split with and without
    MODEL.COMPUTE_DTYPE bfloat16 (same seeded weights): both finish with
    finite metrics, the bf16 run's artifacts have the f32 run's keys,
    types, dtypes and shapes (bf16 outputs widened to f32), and eval.py
    reads them and gives the online camera numbers (to 0.01 m and 0.1 deg:
    the quaternions are bf16 values, and the online and offline angle
    formulas normalise them differently)."""
    import eval as offline_eval
    import types

    from nopesac_torch.engine.test import main as eval_main

    smoke = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
    runs = {}
    for dt in ("float32", BF16):
        out = str(tmp_path / dt)
        assert eval_main(["--config-file", smoke, "--eval-only", "--device", "cpu", "--seed", "2",
                          "TEST.EVAL_FULL_SCENE", "True", "MODEL.COMPUTE_DTYPE", dt,
                          "OUTPUT_DIR", out]) == 0
        row = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert all(np.isfinite(v) for v in row["results"].values())
        preds = torch.load(os.path.join(out, "NopeSAC_instances_predictions.pth"),
                           weights_only=False)
        with open(os.path.join(out, "continuous.pkl"), "rb") as f:
            cont = pickle.load(f)
        runs[dt] = (row["results"], preds, cont, out)
    (_, p32, c32, _), (res16, p16, c16, out16) = runs["float32"], runs[BF16]
    for pair32, pair16 in zip(p32, p16):
        for v in ("0", "1"):
            # the instance lists may differ in length between the dtypes
            assert _artifact_types(pair16[v]["pred_plane"]) == _artifact_types(pair32[v]["pred_plane"])
            assert sorted(pair16[v]) == sorted(pair32[v])
    assert _artifact_types(c16) == _artifact_types(c32)
    args = types.SimpleNamespace(
        config_file="", rcnn_cached_file=os.path.join(out16, "NopeSAC_instances_predictions.pth"),
        evaluate="camera", num_process=1, camera_cached_file="", num_data=-1,
        dataset_phase="synthetic_test", optimized_dict_path=os.path.join(out16, "continuous.pkl"),
        dataset_json="", opts=[])
    assert offline_eval.main(args) == 0
    printed = capsys.readouterr().out
    line = next(ln for ln in printed.splitlines() if ln.startswith("Median Error"))
    tran, rot = (float(v) for v in line.split(":")[1].split(","))
    # the stored quaternions are bf16 values, unit only to ~2^-8, and the two
    # evaluators' angle formulas take their norm differently
    assert abs(tran - res16["T median err"]) <= 0.01 and abs(rot - res16["R median err"]) <= 0.1
