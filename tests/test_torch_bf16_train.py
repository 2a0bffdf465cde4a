"""The port's bf16 training policy against the JAX package's, MODEL.REMAT, the
shipped training configs through the port's entry points, and kernel B3's
bf16 logits.

The train step runs configs/train_mp3d_step3.yaml as shipped (COMPUTE_DTYPE
and BACKBONE_TRAIN_DTYPE bfloat16, REMAT on) at tests/test_torch_train.py's
size: 96x128, one pair, 10 Sinkhorn iterations, dropout 0, the JAX step's
AIM random poses injected, the same separated queries and perturbed BN
statistics. Four versions run it from the same weights: JAX in f32 and in
bf16 (one jitted value-and-grad each, compiled to round every op to its
dtype), the port in f32 and in bf16, each port step on the Hungarian match
of its JAX twin (seeded weights leave near-ties that bf16 noise can flip).
With d_jax = |JAX bf16 - JAX f32|:
  * the backbone features and every supervision level's class logits, plane
    parameters and mask logits by tests/test_torch_bf16_eval.py's rule (per
    element, then the port's own deviation per output);
  * every loss, relative to |JAX f32|: |port bf16 - JAX bf16| <= max(1.5 x
    its own relative d_jax, f), f = 1e-3, or one bf16 ulp of the loss if
    that is more and JAX returns the loss in bf16. Where a loss's own d_jax
    lies under f, LEVEL_NOISE may name it, with its reason: it is then held
    at 1.5 x the largest d_jax of the same loss over the decoder's levels.
    Wherever d_jax exceeds half a bf16 ulp of the loss, the port's own
    deviation lies within [0.25, 4] x d_jax;
  * every module's gradient: the relative norm of port bf16 - JAX bf16 is at
    most max(2 x JAX's own bf16-vs-f32 relative gap, 1e-2);
  * the BN running statistics by tests/test_torch_bf16_eval.py's rule;
  * the dtype of every loss, and of the policy's boundaries, as JAX's.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.losses import camera_losses as JCL
from nopesac_tpu.losses import criterion as JCR
from nopesac_tpu.data.packing import unpack_targets as jax_unpack_targets
from nopesac_tpu.ops.mask_loss_pallas import focal_dice_reference, fused_focal_dice

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.packing import batch_to_device, unpack_targets
from nopesac_torch.engine.train import TrainStep, build_train_model, synthetic_batches
from nopesac_torch.engine.trainer import Trainer
from nopesac_torch.losses.criterion import compute_match_cost, match_planes_multi
from nopesac_torch.models import nopesac as nopesac_mod
from nopesac_torch.models.layers import BatchNorm2d
from nopesac_torch.ops import mask_loss
from nopesac_torch.utils.weights import state_dict_from_jax
from test_torch_bf16_eval import ROUND_RANGE, RULE_MUL, _dtype, bf16_ulp, hold, rounds
from test_torch_losses import B3_PALLAS_FWD, B3_PALLAS_GRAD, B3_REF_TOL, _jax_b3, _mask_inputs
from test_torch_train import (H, MATCH_GAP, MODULES, W, _numpy_batch, _perturb_stats,
                              _second_best_gap, _separate_queries)
from test_torch_trainer import RESUME_OPTS, TEST_SPLIT, TRAIN_SPLIT, check_resume_bit_equal
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP3 = os.path.join(REPO, "configs", "train_mp3d_step3.yaml")
LOSS_REL = 1e-3           # the loss rule's floor, relative to |JAX f32|
BF16_ULP = 2.0 ** -7      # relative bf16 ulp bound of a rounded gradient (B3)
GRAD_MUL, GRAD_FLOOR = 2.0, 1e-2
# losses whose own d_jax lies under the floor and which are held at their
# levels' noise instead, and why (CPU numbers, relative to |JAX f32|)
LEVEL_NOISE = {
    "loss_ce": "a cross-entropy averaged over 2 x 50 queries, whose bf16 noise cancels in "
               "JAX's mean (d_jax 2.4e-4, 8.9e-4 at aux level 1); its inputs, the class "
               "logits of every level, agree per element (test_detection_outputs_match_jax)",
    "loss_param_cos": "a mean cosine over the matched planes (d_jax 8.0e-4, 2.3e-2 at aux "
                      "level 1); its inputs, the plane parameters of every level, agree per "
                      "element (test_detection_outputs_match_jax)",
}
HEAD_KEYS = ("pred_logits", "pred_params", "pred_mask_logits")
F32_KEYS = ["MODEL.COMPUTE_DTYPE", "float32", "MODEL.BACKBONE_TRAIN_DTYPE", "float32"]
# XLA may keep a fused chain of bf16 ops in f32 and round once at its end;
# the reference step rounds every op to its dtype, as jnp's semantics say
# and as eager PyTorch does
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
SHIPPED = ("train_mp3d_step1.yaml", "train_mp3d_step2.yaml", "train_mp3d_step3.yaml",
           "train_scannet_step1.yaml", "train_scannet_step2.yaml", "overfit_synthetic_bf16.yaml")


def _cfgs(opts=()):
    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(STEP3)
        cfg.merge_from_list(["INPUT.IMAGE_SIZE", f"({H}, {W})", "SOLVER.IMS_PER_BATCH", "1",
                             "MODEL.SEM_SEG_HEAD.DROPOUT", "0.0",
                             "MODEL.MATCHING_HEAD.SINKHORN_ITERS", "10", *opts])
        out.append(cfg)
    return out


def _jax_step(jmodel, variables, batch, aim_key):
    cost_w = {"cost_class": 1.0, "cost_mask": jmodel.mask_weight, "cost_dice": jmodel.dice_weight,
              "cost_center": jmodel.center_ins_weight, "cost_param": jmodel.param_hm_weight_l1,
              "cost_param_offset": jmodel.param_weight_offset,
              "cost_param_normal_angle": jmodel.param_weight_angle}

    def detect_costs(m, batch):
        t0, t1 = jax_unpack_targets(batch["targets0"]), jax_unpack_targets(batch["targets1"])
        targets = jax.tree_util.tree_map(lambda a, c: jnp.concatenate([a, c]), t0, t1)
        feats, out, _ = m.detect(jnp.concatenate([batch["image0"], batch["image1"]]),
                                 train=True)
        levels = [out] + list(out["aux_outputs"])
        return ([JCR.compute_match_cost(o, targets, cost_w) for o in levels],
                JCR.match_planes_multi(levels, targets, cost_w),
                (feats, [{k: o[k] for k in HEAD_KEYS} for o in levels]))

    def step(variables, batch):
        def loss_fn(params):
            losses, state = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                         batch, aim_key, method=jmodel.train_forward,
                                         mutable=["batch_stats"])
            total = sum(v.astype(jnp.float32) for v in losses.values())
            return total, (losses, state["batch_stats"])

        (_, (losses, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        (costs, matches, detected), _ = jmodel.apply(variables, batch, method=detect_costs,
                                                     mutable=["batch_stats"])
        return losses, grads, new_bs, costs, matches, detected

    compiled = jax.jit(step).lower(variables, batch).compile(NO_EXCESS_PRECISION)
    return jax.tree_util.tree_map(np.asarray, compiled(variables, batch))


@pytest.fixture(scope="module")
def shared():
    """JAX's step in f32 and bf16 on the same weights and batch; the weights
    as a port state_dict."""
    jcfg, tcfg = _cfgs()
    jcfg32 = jcfg.clone()
    jcfg32.merge_from_list(F32_KEYS)
    jmodels = {"bfloat16": jax_build_model(jcfg), "float32": jax_build_model(jcfg32)}
    np_batch = _numpy_batch(0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, np_batch)
    aim_key = jax.random.PRNGKey(7)
    jm = jmodels["float32"]
    variables = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, aim_key,
                                          method=jm.train_forward))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    variables = {"params": _separate_queries(variables["params"], rng),
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    refs = {dt: _jax_step(m, variables, jbatch, aim_key) for dt, m in jmodels.items()}
    r1, r2 = jax.random.split(aim_key)
    n_aim = jm.rand_bs
    aim = (np.asarray(JCL.rand_aim_rot(r1, n_aim)), np.asarray(JCL.rand_aim_trans(r2, n_aim)))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W))
    return dict(tcfg=tcfg, variables=variables, np_batch=np_batch, refs=refs, aim=aim, sd=sd)


def _port_model(shared, opts=()):
    cfg = shared["tcfg"].clone()
    cfg.merge_from_list(list(opts))
    model = build_train_model(cfg, device="cpu")
    model.load_state_dict(shared["sd"], strict=True)
    return model


def _port_step(shared, opts=(), hooks=None, model=None, matches=None):
    """One port train_forward and backward; `matches` (a list of [2B, NQ]
    arrays, one per supervision level) replace the Hungarian solve."""
    model = model or _port_model(shared, opts)
    handles = [m.register_forward_hook(fn) for m, fn in (hooks(model) if hooks else [])]
    batch = batch_to_device(shared["np_batch"], "cpu")
    aim = [torch.from_numpy(a.copy()) for a in shared["aim"]]
    with pytest.MonkeyPatch.context() as mp:
        if matches is not None:
            mp.setattr(nopesac_mod, "match_planes_multi",
                       lambda *_: [torch.from_numpy(np.asarray(m, np.int64)) for m in matches])
        losses = model.train_forward(batch, None, *aim)
    torch.stack([v.to(torch.float32) for v in losses.values()]).sum().backward()
    for h in handles:
        h.remove()
    return model, losses


def _dtype_hooks(seen):
    def hooks(model):
        def rec(name):
            def fn(_, __, out):
                t = out[0] if isinstance(out, tuple) else out
                seen.setdefault(name, next(iter(t.values())) if isinstance(t, dict) else t)
            return fn
        head, cam = model.sem_seg_head, model.camera_head
        return [(model.backbone.stem, rec("stem")), (model.backbone.res2[0], rec("res2.0")),
                (head.top_down, rec("top_down")), (head.input_proj, rec("input_proj")),
                (cam.pixel_decoder, rec("camera.pixel_decoder")), (cam.rots, rec("camera.rots")),
                (model.matching_head, rec("matching_head"))]
    return hooks


def _detect_hooks(detected):
    """Hooks keeping the backbone's features and the plane head's outputs of
    every supervision level."""
    def keep(name):
        def fn(_, __, out):
            detected[name] = out[0] if isinstance(out, tuple) else out
        return fn
    return lambda model: [(model.backbone, keep("feats")), (model.sem_seg_head, keep("head"))]


@pytest.fixture(scope="module")
def port_steps(shared):
    seen, detected = {}, {"bfloat16": {}, "float32": {}}
    refs = shared["refs"]
    hooks16 = lambda m: _dtype_hooks(seen)(m) + _detect_hooks(detected["bfloat16"])(m)
    out = {"bfloat16": _port_step(shared, hooks=hooks16, matches=refs["bfloat16"][4]),
           "float32": _port_step(shared, F32_KEYS, hooks=_detect_hooks(detected["float32"]),
                                 matches=refs["float32"][4])}
    return out, {k: v.dtype for k, v in seen.items()}, detected


def test_match_is_optimal_for_jax_costs(shared):
    """The port's bf16 Hungarian match of every supervision level and image
    against JAX bf16's: equal wherever JAX's optimal assignment beats the
    second best by more than the two costs can differ on it (2 n_gt max
    |port cost - JAX cost|); elsewhere the two assignments tie within that
    difference. Seeded weights leave many near-ties (gaps of 1e-5 to 1e-3
    against an entrywise bf16 cost noise of ~0.1, mostly the x20 mask
    cost), so the loss and gradient tests run on JAX's matches, injected
    into the port's step."""
    refs = shared["refs"]["bfloat16"]
    model = _port_model(shared)
    batch = batch_to_device(shared["np_batch"], "cpu")
    t0, t1 = unpack_targets(batch["targets0"]), unpack_targets(batch["targets1"])
    targets = {k: torch.cat([t0[k], t1[k]]) for k in t0}
    weights = model.train_settings.match_cost_weights()
    with torch.no_grad():
        _, out, _ = model.detect(torch.cat([batch["image0"], batch["image1"]]).permute(0, 3, 1, 2))
        levels = [out] + out["aux_outputs"]
        costs = [compute_match_cost(o, targets, weights).numpy() for o in levels]
        got = [m.numpy() for m in match_planes_multi(levels, targets, weights)]
    b2 = costs[0].shape[0]
    n_gt = [int(shared["np_batch"][f"targets{v}"]["gt_valid"].sum()) for v in (0, 1)]
    decided = 0
    for c, jc, m, jm in zip(costs, refs[3], got, refs[4]):
        for i in range(b2):
            n = n_gt[i * 2 // b2]
            gap = _second_best_gap(jc[i], n)
            slack = 2 * n * float(np.abs(c[i, :, :n] - jc[i, :, :n]).max())
            if gap > slack:
                decided += 1
                np.testing.assert_array_equal(m[i], jm[i])
            else:
                rows = np.arange(m.shape[1])
                cost = lambda mm: float(jc[i][rows[mm[i] >= 0], mm[i][mm[i] >= 0]].sum())
                assert abs(cost(m) - cost(jm)) <= slack, (gap, slack)
    print("match blocks decided beyond the cost difference:", decided, "of", len(costs) * b2)


def test_detection_outputs_match_jax(shared, port_steps):
    """The train step's backbone features (f32 trunk) and the plane head's
    class logits, plane parameters and mask logits at each of the three
    supervision levels, by the value and rounding rules, with JAX's dtypes.
    Measured (CPU), err / dev: res2 0.08 / 1.00, res3 0.43 / 1.00, res4 0.66
    / 0.89, res5 0.88 / 0.99; class logits 1.14 / -, 1.04 / -, 0.64 / -;
    plane parameters 0.40 / 1.22, 0.43 / 1.23, 1.09 / 1.32; mask logits 0.93
    / 1.04, 0.76 / 0.80, 0.77 / 0.92 (final level, aux 0, aux 1)."""
    (jf32, jl32), (jf16, jl16) = (shared["refs"][dt][5] for dt in ("float32", "bfloat16"))
    got16, got32 = port_steps[2]["bfloat16"], port_steps[2]["float32"]
    levels = lambda o: [o] + list(o["aux_outputs"])
    record = {}
    for k in ("res2", "res3", "res4", "res5"):
        p16, p32 = (g["feats"][k].detach().permute(0, 2, 3, 1) for g in (got16, got32))
        assert _dtype(p16) == _dtype(jf16[k]) == "float32", k
        hold(k, jf32[k], jf16[k], p32, p16, record=record)
    for level, j32, j16, p32, p16 in zip(("final", "aux0", "aux1"), jl32, jl16,
                                         levels(got32["head"]), levels(got16["head"])):
        for k in HEAD_KEYS:
            assert _dtype(p16[k]) == _dtype(j16[k]), (level, k)
            hold(f"{k} {level}", j32[k], j16[k], p32[k], p16[k], record=record)
    rounds(record)
    print("detection", record)


def _level_family(key):
    """The same loss at every supervision level: loss_ce, loss_ce_0, loss_ce_1."""
    stem = key[:-2] if key[-2:] in ("_0", "_1") else key
    return (stem, f"{stem}_0", f"{stem}_1")


def test_losses_match_jax(shared, port_steps):
    """Every loss, its dtype as JAX's (the refinement's score losses bf16,
    the rest f32), by the loss rule of the module docstring. Measured (CPU),
    err / own d_jax: the detection losses 0.01-1.05, but for loss_ce 4.67,
    loss_ce_0 4.27 and loss_dice_0 2.54 (under the floor: 1.1e-3, 5.3e-4 and
    5.4e-5) and loss_param_cos 1.71; loss_ce at 0.83 and loss_param_cos at
    0.04 of their LEVEL_NOISE bound. The camera and matching losses 0-0.76.
    The port's deviation / d_jax 0.57-1.98 over the 21 losses whose d_jax
    exceeds half an ulp (loss_mask at its three levels 1.60-1.98)."""
    (m16, l16), (m32, l32) = port_steps[0]["bfloat16"], port_steps[0]["float32"]
    r16, r32 = shared["refs"]["bfloat16"][0], shared["refs"]["float32"][0]
    assert sorted(l16) == sorted(r16)
    rel = {}
    for k in r16:
        assert _dtype(l16[k]) == str(r16[k].dtype), (k, l16[k].dtype)
        scale = max(abs(float(r32[k])), 1e-30)
        rel[k] = (abs(l16[k].item() - float(r16[k])) / scale,
                  abs(float(r16[k]) - float(r32[k])) / scale,
                  abs(l16[k].item() - l32[k].item()) / scale,
                  bf16_ulp(scale) / scale)
    bad, checked = {}, {}
    for k, (err, d_jax, dev, ulp) in rel.items():
        floor = max(LOSS_REL, ulp) if r16[k].dtype == jnp.bfloat16 else LOSS_REL
        noise = d_jax
        if k in LEVEL_NOISE:
            assert d_jax < floor, (k, d_jax, "no longer under the floor: drop it from LEVEL_NOISE")
            noise = max(rel[f][1] for f in _level_family(k) if f in rel)
        if not err <= max(RULE_MUL * noise, floor):
            bad[k] = (err, noise, floor)
        if d_jax > ulp / 2:
            checked[k] = dev / d_jax
            if not ROUND_RANGE[0] <= dev / d_jax <= ROUND_RANGE[1]:
                bad[k] = (dev, d_jax)
    assert not bad, bad
    assert checked, "no loss with d_jax above half a bf16 ulp: the rounding check held nothing"
    print("losses (err, d_jax, dev, ulp)", rel, "rounding", checked)


def test_gradients_match_jax(shared, port_steps):
    """Per module: |port bf16 - JAX bf16| / |JAX bf16| <= max(2 x |JAX bf16 -
    JAX f32| / |JAX f32|, 1e-2), norms over the module's parameters; every
    gradient is f32 (the parameters are)."""
    model = port_steps[0]["bfloat16"][0]
    g16 = state_dict_from_jax(shared["refs"]["bfloat16"][1], None, image_size=(H, W))
    g32 = state_dict_from_jax(shared["refs"]["float32"][1], None, image_size=(H, W))
    record = {}
    for module in MODULES:
        diff = own = ref16 = ref32 = 0.0
        for name, p in model.named_parameters():
            if not name.startswith(module):
                continue
            assert p.dtype == p.grad.dtype == torch.float32, name
            a, b = g16[name].numpy().astype(np.float64), g32[name].numpy().astype(np.float64)
            diff += float(((p.grad.numpy() - a) ** 2).sum())
            own += float(((a - b) ** 2).sum())
            ref16 += float((a ** 2).sum())
            ref32 += float((b ** 2).sum())
        rel, gap = (diff / ref16) ** 0.5, (own / ref32) ** 0.5
        record[module] = (rel, gap)
        assert rel <= max(GRAD_MUL * gap, GRAD_FLOOR), (module, rel, gap)
    print("grads", record)


def test_bn_running_stats_match_jax(shared, port_steps):
    """The trainable BNs' running statistics after the step (the camera conv
    stacks in C = bf16, the top-down decoder in FT = f32) by the rule.
    Measured err / d_jax <= 1.23; one statistic has d_jax above half an ulp
    (the top-down up_conv1's running mean: err 0.51, dev 0.95), the others
    are means over every pixel."""
    (m16, _), (m32, _) = port_steps[0]["bfloat16"], port_steps[0]["float32"]
    want = {dt: state_dict_from_jax(shared["variables"]["params"], shared["refs"][dt][2],
                                    image_size=(H, W)) for dt in ("float32", "bfloat16")}
    got16, got32 = m16.state_dict(), m32.state_dict()
    record = {}
    for n, m in m16.named_modules():
        if isinstance(m, BatchNorm2d):
            for buf in ("running_mean", "running_var"):
                key = f"{n}.{buf}"
                assert got16[key].dtype == torch.float32, key
                hold(key, want["float32"][key], want["bfloat16"][key], got32[key], got16[key],
                     record=record)
    rounds(record)
    print("bn", record)


def test_policy_dtypes(port_steps):
    """Train mode under train_mp3d_step3.yaml: the stem bf16 (BT), the trunk
    and the plane head's pixel path f32 (FT), the head's input projection
    f32, the camera head bf16 (C), the matching head f32."""
    seen = port_steps[1]
    assert seen == {"stem": torch.bfloat16, "res2.0": torch.float32, "top_down": torch.float32,
                    "input_proj": torch.float32, "camera.pixel_decoder": torch.bfloat16,
                    "camera.rots": torch.bfloat16, "matching_head": torch.float32}, seen


def test_fpn_train_dtype_reaches_the_pixel_path(shared):
    """MODEL.FPN_TRAIN_DTYPE bfloat16 trains the top-down decoder and the
    pixel maps in bf16, as the JAX package's fpn_train_dtype does; the mask
    logits stay f32."""
    seen = {}

    def rec(name):
        def fn(_, __, out):
            seen.setdefault(name, out.dtype)
        return fn

    model, losses = _port_step(shared, ["MODEL.FPN_TRAIN_DTYPE", "bfloat16"],
                               hooks=lambda m: [(m.sem_seg_head.top_down, rec("top_down")),
                                                (m.sem_seg_head.pixel_plane_center,
                                                 rec("center"))])
    assert seen == {"top_down": torch.bfloat16, "center": torch.bfloat16}
    assert all(torch.isfinite(v) for v in losses.values())


# ------------------------------------------------------------------- REMAT

def test_remat_is_bit_equal_and_replays_the_blocks(shared):
    """An f32 step with MODEL.REMAT True and False: equal losses, gradients
    and BN statistics bit for bit; a backbone block's forward runs twice in
    the REMAT step (once more in the backward) and once without."""
    runs = {}
    for remat in (True, False):
        model = _port_model(shared, F32_KEYS + ["MODEL.REMAT", str(remat)])
        block, calls = model.backbone.res3[1], []
        forward = block.forward  # checkpoint's replay calls forward, not the hooks

        def counted(x, forward=forward, calls=calls):
            calls.append(1)
            return forward(x)

        block.forward = counted
        runs[remat] = (*_port_step(shared, model=model), len(calls))
    (ma, la, na), (mb, lb, nb) = runs[True], runs[False]
    assert (na, nb) == (2, 1)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    pb = dict(mb.named_parameters())
    for n, p in ma.named_parameters():
        assert torch.equal(p.grad, pb[n].grad), n
    sb = mb.state_dict()
    for k, v in ma.state_dict().items():
        assert torch.equal(v, sb[k]), k


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("config", SHIPPED)
def test_shipped_config_builds_and_steps(config):
    """Each shipped training config (the 8-chip one aside) builds and takes a
    train step in the port with its dtype keys as written, at 64x96 with
    one pair and no MODEL.WEIGHTS: finite, not skipped, the parameters and
    the AdamW moments f32, the config's dtypes in the modules."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", config))
    cfg.merge_from_list(["INPUT.IMAGE_SIZE", "(64, 96)", "SOLVER.IMS_PER_BATCH", "1",
                         "MODEL.WEIGHTS", "", "MODEL.MATCHING_HEAD.SINKHORN_ITERS", "5"])
    model = build_train_model(cfg, device="cpu", seed=0)
    bb = model.backbone
    assert str(bb.res2[0].train_dtype).endswith(cfg.MODEL.BACKBONE_TRAIN_DTYPE)
    assert str(bb.res2[0].eval_dtype).endswith(cfg.MODEL.COMPUTE_DTYPE)
    assert bb.remat == cfg.MODEL.REMAT
    step = TrainStep(model, cfg, seed=0)
    metrics = step(next(iter(synthetic_batches(cfg, 1, seed=1, n_planes=4, device="cpu"))))
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for s in step.optimizer.state.values()
               for k, v in s.items() if k != "step")


def test_trainer_on_train_mp3d_step1(tmp_path):
    """`Trainer` on configs/train_mp3d_step1.yaml as shipped (bf16 keys, REMAT
    on), shrunk only by tests/test_torch_trainer.py's smoke settings (64x96,
    its synthetic splits, one pair per step, no loader pool): 2 steps,
    finite, and a checkpoint of f32 tensors only."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "train_mp3d_step1.yaml"))
    cfg.merge_from_list(["INPUT.IMAGE_SIZE", "(64, 96)", "OUTPUT_DIR", str(tmp_path),
                         "DATASETS.TRAIN", f'("{TRAIN_SPLIT}",)', "DATASETS.TEST",
                         f'("{TEST_SPLIT}",)', "DATALOADER.NUM_WORKERS", "0", *RESUME_OPTS,
                         "SOLVER.MAX_ITER", "2"])
    cfg.freeze()
    trainer = Trainer(cfg, device="cpu")
    assert trainer.model.backbone.res2[0].train_dtype == torch.bfloat16
    trainer.train()
    trainer.close()
    ckpt = torch.load(tmp_path / "model_final.pth", weights_only=False)
    tensors = list(ckpt["model"].values()) + [
        v for s in ckpt["optimizer"]["state"].values() for k, v in s.items() if k != "step"]
    assert tensors and all(t.dtype == torch.float32 for t in tensors)
    with open(tmp_path / "metrics.json") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["iteration"] for r in rows] == [0, 1]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k != "iteration")
    assert all(r["skipped_nonfinite"] == 0 for r in rows)
    shutil.rmtree(tmp_path)


def test_resume_is_bit_equal_in_bf16(tmp_path, monkeypatch, caplog):
    """tests/test_torch_trainer.py's resume check under the bf16 policy."""
    check_resume_bit_equal(tmp_path, monkeypatch, caplog,
                           ["MODEL.COMPUTE_DTYPE", "bfloat16",
                            "MODEL.BACKBONE_TRAIN_DTYPE", "bfloat16"])


# ------------------------------------------------------------ B3 bf16 input

@pytest.mark.parametrize("with_matched", [False, True])
def test_b3_bf16_logits(with_matched):
    """The plain version on bf16 logits against the Pallas kernel in
    interpret mode (tests/test_torch_losses.py's tolerances) and against
    focal_dice_reference on the same bf16 values widened (its f32
    tolerance); f32 sums, a bf16 d src, exact zeros for unmatched queries."""
    src, masks, tgt, matched = _mask_inputs(2)
    src16 = torch.from_numpy(src).to(torch.bfloat16)
    src_w = src16.to(torch.float32).numpy()
    m = matched if with_matched else None
    s = src16.clone().requires_grad_(True)
    sums = mask_loss.fused_focal_dice(s, torch.from_numpy(masks), torch.from_numpy(tgt).long(),
                                      None if m is None else torch.from_numpy(m))
    assert all(v.dtype == torch.float32 for v in sums)
    sum(wk * v.sum() for wk, v in zip((0.7, -0.3, 0.11), sums)).backward()
    assert s.grad.dtype == torch.bfloat16
    got, g_got = [v.detach().numpy() for v in sums], s.grad.to(torch.float32).numpy()
    jm = None if m is None else jnp.asarray(m)
    pallas, g_pallas = _jax_b3(lambda x: fused_focal_dice(
        x.astype(jnp.bfloat16), jnp.asarray(masks), jnp.asarray(tgt), True, jm),
        src_w, masks, tgt, m)
    for g, r in zip(got, pallas):
        np.testing.assert_allclose(g, r, rtol=B3_PALLAS_FWD, atol=B3_PALLAS_FWD)
    scale = np.abs(g_pallas).max() + 1e-6
    np.testing.assert_allclose(g_got / scale, g_pallas / scale, rtol=B3_PALLAS_GRAD,
                               atol=B3_PALLAS_GRAD)
    ref, g_ref = _jax_b3(lambda x: focal_dice_reference(x, jnp.asarray(masks), jnp.asarray(tgt)),
                         src_w, masks, tgt, m)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=B3_REF_TOL, atol=B3_REF_TOL * np.abs(r).max())
    # d src is the f32 gradient rounded once to bf16
    g_round = torch.tensor(g_ref).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.abs(g_got - g_round).max() <= BF16_ULP * np.abs(g_ref).max()
    if with_matched:
        assert all((g[~matched] == 0).all() for g in got) and (g_got[~matched] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_plain_gradient_where_the_logit_is_zero(dtype):
    """The plain version's autograd gives the true derivative where the
    upsampled logit z is exactly 0 (sigmoid'(0) = 1/4, BCE'(0) = 1/2 - t),
    as the kernel's closed-form backward does: the analytic d src, through
    `upsample4_adjoint`, on logits that are 0 in the first query and
    bf16-representable ties elsewhere."""
    src, masks, tgt, _ = _mask_inputs(4)
    src[:, 0] = 0.0
    x = torch.from_numpy(src).to(dtype).requires_grad_(True)
    m, idx = torch.from_numpy(masks), torch.from_numpy(tgt).long()
    sums = mask_loss.fused_focal_dice(x, m, idx)
    g = torch.tensor([0.7, -0.3, 0.11])
    sum(gk * v.sum() for gk, v in zip(g, sums)).backward()
    b, nq, h, w = src.shape
    z = mask_loss.upsample4(x.detach().to(torch.float32))
    t = torch.gather(m, 1, idx[:, :, None, None].expand(-1, -1, 4 * h, 4 * w)).to(torch.float32)
    prob, ce, p_t, alpha_t = mask_loss.elem_terms(z, t)
    s, pq = 1.0 - p_t, prob * (1.0 - prob)
    dz = g[0] * alpha_t * (s * s * (prob - t) - 2.0 * s * (2.0 * t - 1.0) * pq * ce) \
        + (g[1] * t + g[2]) * pq
    want = mask_loss.upsample4_adjoint(dz).to(dtype).to(torch.float32)
    assert bool((z[:, 0] == 0).all())
    tol = (BF16_ULP if dtype == torch.bfloat16 else 1e-5) * float(want.abs().max())
    assert float((x.grad.to(torch.float32) - want).abs().max()) <= tol


def test_b3_refuses_other_dtypes():
    src, masks, tgt, matched = _mask_inputs(3)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            mask_loss.fused_focal_dice(torch.from_numpy(src).to(dt), torch.from_numpy(masks),
                                       torch.from_numpy(tgt).long(), torch.from_numpy(matched))
