"""The port's AdamW and SGD against the JAX package's optax chains.

The JAX parameter tree of the smoke model at 96x128 (shapes from
`jax.eval_shape`, so nothing is compiled but the optax update) is filled with
seeded values and carried into the port with `state_dict_from_jax`. The same
seeded gradients then go through four steps of `build_optimizer` +
`apply_freeze` and of the port's `TrainStep.apply_gradients`: the warmup lr
at steps 0-3, lr multipliers by module, norm and embedding decay groups, a
frozen prefix, with and without full-model clipping. SGD (SOLVER.OPTIMIZER
SGD, momentum 0.9) runs the same four steps; torch.optim.SGD with the same
weight decay folds the decay into the momentum buffer and misses the chain
from the second step on.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.engine.optimizer import apply_freeze as jax_apply_freeze
from nopesac_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model

from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.optimizer import lr_group
from nopesac_torch.engine.train import TrainStep, build_train_model
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
H, W = 96, 128
N_STEPS = 4  # the warmup over steps 0-3
SOLVER = dict(WARMUP_FACTOR=0.1, WARMUP_ITERS=3, WEIGHT_DECAY=0.05, WEIGHT_DECAY_EMBED=0.02,
              BACKBONE_MULTIPLIER=0.1, SEM_SEG_HEAD_MULTIPLIER=0.5,
              PLANE_MATCHER_HEAD_MULTIPLIER=2.0, BASE_LR=1e-3)
FROZEN = "res2"
# The parameters after each step within 1e-6 relative (model-wide norm),
# and each tensor's update within 3e-5 of its group's lr (an Adam step is at
# most ~lr; a wrong lr multiplier or decay group is off by a whole fraction
# of it) plus four f32 ulps of its largest parameter (torch rounds
# p * (1 - lr * wd) and then the Adam step, optax rounds p + u once, and the
# two differences are rounded). optax takes the bias corrections
# 1 - beta2^t in f32, where 1 - 0.999^t keeps ~5 digits; torch takes them in f64.
PARAM_REL = 1e-6
UPDATE_REL = 3e-5
ULPS = 4.8e-7


def _cfgs(clip, optimizer="ADAMW"):
    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(CONFIG)
        cfg.INPUT.IMAGE_SIZE = (H, W)
        for k, v in SOLVER.items():
            setattr(cfg.SOLVER, k, v)
        cfg.SOLVER.OPTIMIZER = optimizer
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = clip
        cfg.MODEL.FREEZE = [FROZEN]
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs(True)
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, x, out_h=H, out_w=W,
                                                method=jmodel.inference))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.05, s.shape).astype(np.float32), shapes["params"])


def test_lr_groups_follow_the_reference_substring_rule():
    assert lr_group("backbone.res2.0.conv1.weight") == "backbone"
    # the camera head's convs_backbone takes the backbone multiplier too
    assert lr_group("camera_head_list.0.convs_backbone.0.0.weight") == "backbone"
    assert lr_group("sem_seg_head.query_embed.weight") == "sem_seg_head"
    assert lr_group("matching_head.gnn.layers.0.q_proj.weight") == "matcher"
    assert lr_group("camera_head_list.0.fc_trans.weight") == "default"


@pytest.mark.parametrize("clip", [False, True])
def test_adamw_steps_match_optax(params, clip):
    jcfg, tcfg = _cfgs(clip)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_apply_freeze(jax_build_optimizer(jcfg, jparams), jparams, frozen_prefixes=(FROZEN,))
    opt_state = tx.init(jparams)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))

    model = build_train_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, None, image_size=(H, W)))
    step = TrainStep(model, tcfg)
    assert step.frozen and all(f".{FROZEN}." in n for n in step.frozen)
    assert step.clip_value == (0.01 if clip else None)
    rng = np.random.default_rng(11)
    names = dict(model.named_parameters())
    for k in range(N_STEPS):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1e-2, np.shape(a)).astype(np.float32), params)
        before = {n: p.detach().clone() for n, p in names.items()}
        g_sd = state_dict_from_jax(grads, None, image_size=(H, W))
        for n, p in names.items():
            p.grad = g_sd[n].clone()
        _, applied = step.apply_gradients()
        assert applied
        lr_of = {id(p): g["lr"] for g in step.optimizer.param_groups for p in g["params"]}
        upd, opt_state = update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), None,
                                   image_size=(H, W))
        diff = sum(float(((p.detach() - want[n]) ** 2).sum()) for n, p in names.items())
        ref = sum(float((want[n] ** 2).sum()) for n in names)
        assert (diff / ref) ** 0.5 <= PARAM_REL, (k, (diff / ref) ** 0.5)
        for n, p in names.items():
            d_got = (p.detach() - before[n]).numpy()
            d_want = want[n].numpy() - before[n].numpy()
            if f".{FROZEN}." in n:
                assert not d_got.any() and not d_want.any(), n
                continue
            assert np.abs(d_want).max() > 0, (k, n)
            tol = UPDATE_REL * lr_of[id(p)] + ULPS * np.abs(before[n].numpy()).max()
            assert np.abs(d_got - d_want).max() <= tol, (k, n)
    assert isinstance(step.optimizer, torch.optim.AdamW)


def sgd_steps(params, clip, swap=None):
    """N_STEPS of the port's SGD (or of the optimizer `swap(step)` puts in
    its place) and of the optax SGD chain on the same seeded gradients:
    per step, the parameters' model-wide relative distance and the largest
    per-tensor update error in units of its tolerance (1e-3 of the tensor's
    update plus four f32 ulps of its largest parameter)."""
    jcfg, tcfg = _cfgs(clip, "SGD")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_apply_freeze(jax_build_optimizer(jcfg, jparams), jparams, frozen_prefixes=(FROZEN,))
    opt_state = tx.init(jparams)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    model = build_train_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, None, image_size=(H, W)))
    step = TrainStep(model, tcfg)
    if swap is not None:
        step.optimizer = swap(step)
    rng = np.random.default_rng(12)
    names = dict(model.named_parameters())
    rows = []
    for _ in range(N_STEPS):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1e-2, np.shape(a)).astype(np.float32), params)
        before = {n: p.detach().clone() for n, p in names.items()}
        g_sd = state_dict_from_jax(grads, None, image_size=(H, W))
        for n, p in names.items():
            p.grad = g_sd[n].clone()
        assert step.apply_gradients()[1]
        upd, opt_state = update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), None,
                                   image_size=(H, W))
        diff = sum(float(((p.detach() - want[n]) ** 2).sum()) for n, p in names.items())
        ref = sum(float((want[n] ** 2).sum()) for n in names)
        worst = 0.0
        for n, p in names.items():
            d_got = (p.detach() - before[n]).numpy()
            d_want = want[n].numpy() - before[n].numpy()
            if f".{FROZEN}." in n:
                assert not d_got.any() and not d_want.any(), n
                continue
            # clipped to a norm of 0.01 some updates fall under an ulp
            assert clip or np.abs(d_want).max() > 0, n
            tol = 1e-3 * np.abs(d_want).max() + ULPS * np.abs(before[n].numpy()).max()
            worst = max(worst, float(np.abs(d_got - d_want).max() / tol))
        rows.append(((diff / ref) ** 0.5, worst))
    return step, rows


@pytest.mark.parametrize("clip", [False, True])
def test_sgd_steps_match_optax(params, clip):
    """The optax chain clip -> trace(momentum) -> add_decayed_weights ->
    scale(-lr) -> per-module multiplier, with non-zero weight decay in two
    groups and multipliers 0.1 to 2: the parameters after each step within
    1e-6 relative, each tensor's update within its tolerance."""
    step, rows = sgd_steps(params, clip)
    assert type(step.optimizer).__name__ == "SGD"
    assert not isinstance(step.optimizer, torch.optim.SGD)
    assert {g["weight_decay"] for g in step.optimizer.param_groups} >= {0.05, 0.02}
    for k, (rel, worst) in enumerate(rows):
        assert rel <= PARAM_REL and worst <= 1.0, (k, rel, worst)
    # the momentum buffers are the optimizer state a checkpoint saves
    state = step.optimizer.state_dict()["state"]
    assert state and all(set(s) == {"momentum_buffer"} for s in state.values())


def test_torch_sgd_weight_decay_is_not_the_optax_chain(params):
    """torch.optim.SGD(momentum, weight_decay=wd) on the same groups adds
    wd * p to the gradient before the momentum buffer: its first step is the
    chain's, every later one is not."""
    def torch_sgd(step):
        groups = [{"params": g["params"], "lr": g["lr"], "lr_mult": g["lr_mult"],
                   "weight_decay": g["weight_decay"]} for g in step.optimizer.param_groups]
        return torch.optim.SGD(groups, lr=SOLVER["BASE_LR"], momentum=0.9)

    _, rows = sgd_steps(params, False, swap=torch_sgd)
    assert rows[0][0] <= PARAM_REL, rows[0]
    assert all(rel > 10 * PARAM_REL and worst > 1.0 for rel, worst in rows[1:]), rows
