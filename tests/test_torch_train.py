"""The port's training step against the JAX package on shared weights.

One JAX init of `train_forward` (smoke_synthetic.yaml at 96x128, one pair,
10 Sinkhorn iterations, dropout 0) is carried into the port with
`state_dict_from_jax`. The same mapped synthetic batch and the JAX step's AIM
random poses go through one jitted JAX call (losses, gradients, new BN
statistics and the Hungarian match of every supervision level) and through
the port's `train_forward` on the CPU, where kernel B3 runs its plain
version. Then the non-finite skip guard of the port's train step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.mapper import collate as jax_collate
from nopesac_tpu.data.packing import unpack_targets as jax_unpack_targets
from nopesac_tpu.data.synthetic import make_pair as jax_make_pair
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.losses import camera_losses as JCL
from nopesac_tpu.losses import criterion as JCR

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.packing import batch_to_device, unpack_targets
from nopesac_torch.engine.train import TrainStep, build_train_model
from nopesac_torch.losses.criterion import match_planes_multi
from nopesac_torch.models.layers import BatchNorm2d
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
H, W = 96, 128
LOSS_ABS, LOSS_REL = 1e-4, 1e-3   # each loss within max(abs, rel * |ref|)
GRAD_REL = 1e-3                   # relative norm of the gradient difference per module
# BN running statistics after the step: 1e-5 holds for every BN but the
# FPN's up-convs, which sit after the 12-layer transformer and the bilinear
# upsamples, where the two frameworks' activations already differ by ~1e-5
# (module tolerance 1e-4); measured 1.8e-5 there
BN_TOL = 5e-5
MATCH_GAP = 1e-3                  # optimal vs second-best assignment cost
MODULES = ("backbone", "sem_seg_head", "matching_head", "camera_head_list")


def _cfgs():
    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(CONFIG)
        cfg.INPUT.IMAGE_SIZE = (H, W)
        cfg.SOLVER.IMS_PER_BATCH = 1
        cfg.MODEL.SEM_SEG_HEAD.DROPOUT = 0.0
        cfg.MODEL.MATCHING_HEAD.SINKHORN_ITERS = 10
        out.append(cfg)
    return out


def _numpy_batch(seed):
    pair = jax_make_pair(np.random.default_rng(seed), n_planes=6, h=H, w=W)
    batch = jax_collate([JaxPairMapper(is_train=True, image_size=(H, W))(pair)])
    batch.pop("meta")
    return batch


def _separate_queries(params, rng):
    """With random weights the 50 queries are nearly one representation, so
    the costs are close to a_q + b_g and the optimal assignment nearly ties.
    Larger query embeddings and a wider plane-param layer separate them
    (the fixture asserts the gap that results)."""
    ph = params["plane_head"]
    ph["query_embed"] = (np.asarray(ph["query_embed"]) * 10.0).astype(np.float32)
    for name, scale in (("plane_param", 10.0), ("plane_center", 1.0)):
        last = ph[name]["Dense_2"]
        last["kernel"] = (np.asarray(last["kernel"]) * scale).astype(np.float32)
        last["bias"] = rng.normal(0, 0.5, last["bias"].shape).astype(np.float32)
    return params


def _perturb_stats(stats, rng):
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                node[k] = (np.asarray(v) + rng.normal(0, 0.05, v.shape)).astype(np.float32)
            elif k == "var":
                node[k] = (np.asarray(v) * rng.uniform(0.8, 1.25, v.shape)).astype(np.float32)
    walk(stats)
    return stats


def _second_best_gap(cost, n_gt):
    """Cost of the second-best assignment minus the optimal one, on the
    [NQ, n_gt] submatrix (forbid each optimal pair in turn)."""
    c = np.asarray(cost, np.float64)[:, :n_gt]
    rows, cols = linear_sum_assignment(c)
    best = c[rows, cols].sum()
    second = np.inf
    for r, k in zip(rows, cols):
        alt = c.copy()
        alt[r, k] = 1e9
        rr, cc = linear_sum_assignment(alt)
        second = min(second, alt[rr, cc].sum())
    return second - best


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    np_batch = _numpy_batch(0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, np_batch)
    aim_key = jax.random.PRNGKey(7)
    cost_w = {"cost_class": 1.0, "cost_mask": jmodel.mask_weight, "cost_dice": jmodel.dice_weight,
              "cost_center": jmodel.center_ins_weight, "cost_param": jmodel.param_hm_weight_l1,
              "cost_param_offset": jmodel.param_weight_offset,
              "cost_param_normal_angle": jmodel.param_weight_angle}

    def detect_costs(m, batch):
        t0, t1 = jax_unpack_targets(batch["targets0"]), jax_unpack_targets(batch["targets1"])
        targets = jax.tree_util.tree_map(lambda a, c: jnp.concatenate([a, c]), t0, t1)
        _, out, _ = m.detect(jnp.concatenate([batch["image0"], batch["image1"]]), train=True)
        levels = [out] + list(out["aux_outputs"])
        return ([JCR.compute_match_cost(o, targets, cost_w) for o in levels],
                JCR.match_planes_multi(levels, targets, cost_w))

    def step(variables, batch):
        def loss_fn(params):
            losses, state = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                         batch, aim_key, method=jmodel.train_forward,
                                         mutable=["batch_stats"])
            return sum(losses.values()), (losses, state["batch_stats"])

        (_, (losses, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        (costs, matches), _ = jmodel.apply(variables, batch, method=detect_costs,
                                           mutable=["batch_stats"])
        return losses, grads, new_bs, costs, matches

    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, aim_key,
                                              method=jmodel.train_forward))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    variables = {"params": _separate_queries(variables["params"], rng),
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(step)(variables, jbatch))
    n_aim = jmodel.rand_bs  # batch of one pair
    r1, r2 = jax.random.split(aim_key)
    aim = (np.asarray(JCL.rand_aim_rot(r1, n_aim)), np.asarray(JCL.rand_aim_trans(r2, n_aim)))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, np_batch=np_batch, ref=ref, aim=aim,
                sd=sd)


def _port_model(shared):
    model = build_train_model(shared["tcfg"], device="cpu")
    model.load_state_dict(shared["sd"], strict=True)
    return model


@pytest.fixture(scope="module")
def port_step(shared):
    model = _port_model(shared)
    batch = batch_to_device(shared["np_batch"], "cpu")
    aim = [torch.from_numpy(a.copy()) for a in shared["aim"]]
    losses = model.train_forward(batch, None, *aim)
    total = torch.stack(list(losses.values())).sum()
    total.backward()
    return model, losses


def test_fixture_match_is_unique(shared):
    _, _, _, costs, _ = shared["ref"]
    b2 = costs[0].shape[0]
    n_gt = [int(shared["np_batch"][f"targets{v}"]["gt_valid"].sum()) for v in (0, 1)]
    gaps = [_second_best_gap(c[i], n_gt[i * 2 // b2]) for c in costs for i in range(b2)]
    assert min(gaps) >= MATCH_GAP, gaps


def test_match_equals_jax(shared, port_step):
    model, _ = port_step
    _, _, _, _, ref_matches = shared["ref"]
    batch = batch_to_device(shared["np_batch"], "cpu")
    t0, t1 = unpack_targets(batch["targets0"]), unpack_targets(batch["targets1"])
    targets = {k: torch.cat([t0[k], t1[k]]) for k in t0}
    cost_w = model.train_settings.match_cost_weights()
    fresh = _port_model(shared)  # BN batch statistics as in the step, running stats untouched
    with torch.no_grad():
        images = torch.cat([batch["image0"], batch["image1"]]).permute(0, 3, 1, 2)
        _, out, _ = fresh.detect(images)
        got = match_planes_multi([out] + out["aux_outputs"], targets, cost_w)
    assert len(got) == len(ref_matches) == 3
    for g, r in zip(got, ref_matches):
        np.testing.assert_array_equal(g.numpy(), r)
    assert (ref_matches[0] >= 0).sum() == sum(
        int(shared["np_batch"][f"targets{v}"]["gt_valid"].sum()) for v in (0, 1))


def test_losses_match_jax(shared, port_step):
    ref_losses = shared["ref"][0]
    _, losses = port_step
    assert sorted(losses) == sorted(ref_losses)
    bad = {}
    for key, r in ref_losses.items():
        g = float(losses[key].detach())
        if not abs(g - float(r)) <= max(LOSS_ABS, LOSS_REL * abs(float(r))):
            bad[key] = (g, float(r))
    assert not bad, bad


def test_gradients_match_jax(shared, port_step):
    model, _ = port_step
    ref_grads = state_dict_from_jax(shared["ref"][1], None, image_size=(H, W))
    for module in MODULES:
        diff = ref = 0.0
        n = 0
        for name, p in model.named_parameters():
            if not name.startswith(module):
                continue
            assert p.grad is not None, name
            r = ref_grads[name].numpy().astype(np.float64)
            diff += float(((p.grad.numpy() - r) ** 2).sum())
            ref += float((r ** 2).sum())
            n += 1
        assert n and ref > 0, module
        assert (diff / ref) ** 0.5 <= GRAD_REL, (module, (diff / ref) ** 0.5)


def test_bn_running_stats_match_jax(shared, port_step):
    model, _ = port_step
    want = state_dict_from_jax(shared["variables"]["params"], shared["ref"][2], image_size=(H, W))
    got = model.state_dict()
    before = shared["sd"]
    names = [n for n, m in model.named_modules() if isinstance(m, BatchNorm2d)]
    assert len(names) == 8 + 18  # top_down's laterals, the camera conv stacks
    for n in names:
        for buf in ("running_mean", "running_var"):
            key = f"{n}.{buf}"
            assert not torch.equal(got[key], before[key]), key
            torch.testing.assert_close(got[key], want[key], rtol=BN_TOL, atol=BN_TOL)


def test_skip_guard_keeps_state_bit_equal(shared):
    model = _port_model(shared)
    step = TrainStep(model, shared["tcfg"], seed=0)
    batch = batch_to_device(shared["np_batch"], "cpu")
    aim = [torch.from_numpy(a.copy()) for a in shared["aim"]]
    first = step(batch, *aim)
    assert float(first["skipped_nonfinite"]) == 0.0 and step.updates == 1
    state = {k: v.clone() for k, v in model.state_dict().items()}
    opt = {id(p): {k: v.clone() for k, v in s.items()} for p, s in step.optimizer.state.items()}
    bad = dict(batch)
    bad["image0"] = batch["image0"].clone()
    bad["image0"][0, 0, 0, 0] = float("nan")
    metrics = step(bad, *aim)
    assert float(metrics["skipped_nonfinite"]) == 1.0
    assert step.updates == 1 and step.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    for p, s in step.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt[id(p)][k]), k
