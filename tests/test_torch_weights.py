"""`state_dict_from_jax` is the inverse of the JAX package's torch importer.

The JAX parameter and batch-stats trees of the full inference model at the
reference's 480x640 (where the camera fc layers flatten a 128x2x3 grid) are
filled with seeded random values (shapes from `jax.eval_shape`, so nothing
is compiled). The port's state_dict is saved to a .pth, read back through
`import_torch_weights(..., return_report=True)`, and must give back every
leaf bit for bit with no checkpoint tensor left unconsumed; the same
state_dict must load strictly into the port's model. A state_dict after a
train step of the port (trained parameters, updated BN running statistics)
makes the round trip torch -> JAX -> torch bit for bit. The same round trip
and strict load with MODEL.DEPTH_ON, whose `top_down_depth` and `depth`
layers are the reference's `sem_seg_head.top_down_depth.*` and
`sem_seg_head.depth.*`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.utils.torch_import import import_torch_weights

from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.checkpoint import load_weights
from nopesac_torch.engine.predict import build_model_from_cfg
from nopesac_torch.engine.train import TrainStep, build_train_model, synthetic_batches
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "inference_mp3d.yaml")
SMOKE = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
H, W = 480, 640


def _trees(depth_on):
    cfg = jax_get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.MODEL.DEPTH_ON = depth_on
    model = jax_build_model(cfg)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, out_h=H, out_w=W,
                                               method=model.inference))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 1, leaf.shape).astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled["batch_stats"]


@pytest.fixture(scope="module")
def trees():
    return _trees(False)


@pytest.fixture(scope="module")
def state_dict(trees):
    return state_dict_from_jax(*trees, image_size=(H, W))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_importer_inverts_state_dict_from_jax(trees, state_dict, tmp_path):
    params, stats = trees
    path = tmp_path / "port.pth"
    torch.save({"model": state_dict}, path)
    zeros = jax.tree_util.tree_map(np.zeros_like, (params, stats))
    got_params, got_stats, report = import_torch_weights(
        zeros[0], str(path), batch_stats=zeros[1], return_report=True)
    assert report["unconsumed"] == []
    assert report["n_checkpoint"] == len(state_dict)
    for want, got in ((params, got_params), (stats, got_stats)):
        lw, lg = _leaves(want), _leaves(got)
        assert sorted(lw) == sorted(lg)
        for key, v in lw.items():
            np.testing.assert_array_equal(lg[key], v, err_msg=key)


def test_port_model_loads_strictly(state_dict, tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    model = build_model_from_cfg(cfg, device="cpu")
    assert sorted(model.state_dict()) == sorted(state_dict)
    model.load_state_dict(state_dict, strict=True)
    # a reference checkpoint also carries BatchNorm2d's num_batches_tracked
    # and the criterion's empty_weight; the port's loader drops both
    extra = {k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(7)
             for k in state_dict if k.endswith(".1.running_var")}
    assert extra
    extra["criterion.empty_weight"] = torch.tensor([1.0, 0.1])
    path = tmp_path / "released.pth"
    torch.save({"model": {**state_dict, **extra}}, path)
    model = build_model_from_cfg(cfg, device="cpu", seed=3)
    assert load_weights(model, str(path), strict=True) == {"missing": [], "unexpected": [],
                                                            "dropped": []}
    for k, v in model.state_dict().items():
        assert torch.equal(v, state_dict[k]), k
    os.remove(path)
    w = state_dict["camera_head_list.0.fc_trans.weight"]
    assert tuple(w.shape) == (256, 128 * 2 * 3)
    assert torch.equal(model.camera_head.fc_trans.weight, w)


def test_round_trip_after_a_train_step(trees, tmp_path):
    """One train step of the port at 96x128 (one pair) changes the parameters
    and the trainable BN running statistics; every tensor of the step's
    state_dict goes into a 480x640 model (the first conv of the two pose
    stacks and the two fc layers, whose widths depend on the image size, keep
    their seeded values) and through
    import_torch_weights and state_dict_from_jax back, bit for bit."""
    cfg = get_cfg()
    cfg.merge_from_file(SMOKE)
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "1"])
    small = build_train_model(cfg, device="cpu", seed=1)
    before = {k: v.clone() for k, v in small.state_dict().items()}
    metrics = TrainStep(small, cfg, seed=0)(next(iter(synthetic_batches(cfg, 1, seed=2,
                                                                        device="cpu"))))
    assert float(metrics["skipped_nonfinite"]) == 0.0
    trained = small.state_dict()
    changed = [k for k, v in trained.items() if not torch.equal(v, before[k])]
    assert any(k.endswith(".1.running_var") for k in changed)
    assert any(k.startswith("backbone.") for k in changed)

    full_cfg = get_cfg()
    full_cfg.merge_from_file(CONFIG)
    full = build_model_from_cfg(full_cfg, device="cpu", seed=1).state_dict()
    for k, v in trained.items():
        if v.shape == full[k].shape:
            full[k] = v.clone()
    kept = sorted(k for k in full if not torch.equal(full[k], trained[k]))
    assert kept == [f"camera_head_list.0.{m}.weight" for m in (
        "convs_rots.0.0", "convs_trans.0.0", "fc_rots", "fc_trans")], kept
    path = tmp_path / "trained.pth"
    torch.save({"model": full}, path)
    zeros = jax.tree_util.tree_map(np.zeros_like, trees)
    params, stats, report = import_torch_weights(zeros[0], str(path), batch_stats=zeros[1],
                                                 return_report=True)
    assert report["unconsumed"] == []
    back = state_dict_from_jax(params, stats, image_size=(H, W))
    assert sorted(back) == sorted(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def depth_trees():
    return _trees(True)


def test_depth_layers_round_trip_and_load_strictly(depth_trees, tmp_path):
    """state_dict_from_jax carries top_down_depth (its 8 conv + BN
    laterals, BN statistics included) and the depth conv; the JAX importer
    consumes every tensor and gives back every leaf; the port's DEPTH_ON
    model loads the state_dict strictly, and the model without the branch
    does not."""
    params, stats = depth_trees
    sd = state_dict_from_jax(params, stats, image_size=(H, W))
    depth_keys = sorted(k for k in sd if k.startswith(("sem_seg_head.top_down_depth.",
                                                       "sem_seg_head.depth.")))
    assert len(depth_keys) == 8 * 5 + 2
    assert "sem_seg_head.top_down_depth.m_conv_dict.m4.1.running_var" in depth_keys
    assert tuple(sd["sem_seg_head.depth.weight"].shape) == (1, 256, 1, 1)
    path = tmp_path / "depth.pth"
    torch.save({"model": sd}, path)
    zeros = jax.tree_util.tree_map(np.zeros_like, (params, stats))
    got_params, got_stats, report = import_torch_weights(
        zeros[0], str(path), batch_stats=zeros[1], return_report=True)
    assert report["unconsumed"] == [] and report["n_checkpoint"] == len(sd)
    for want, got in ((params, got_params), (stats, got_stats)):
        lw, lg = _leaves(want), _leaves(got)
        assert sorted(lw) == sorted(lg)
        for key, v in lw.items():
            np.testing.assert_array_equal(lg[key], v, err_msg=key)
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.MODEL.DEPTH_ON = True
    model = build_model_from_cfg(cfg, device="cpu", seed=2)
    assert sorted(model.state_dict()) == sorted(sd)
    assert load_weights(model, str(path), strict=True) == {"missing": [], "unexpected": [],
                                                            "dropped": []}
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    cfg.MODEL.DEPTH_ON = False
    with pytest.raises(RuntimeError, match="top_down_depth"):
        load_weights(build_model_from_cfg(cfg, device="cpu"), str(path), strict=True)
    os.remove(path)
