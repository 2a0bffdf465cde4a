"""The train side of MODEL.DEPTH_ON and SOLVER.OPTIMIZER SGD in the port,
against the JAX package.

The depth branch: one JAX init of `detect` with the depth branch
(smoke_synthetic.yaml at 96x128, dropout 0, MODEL.DEPTH_ON) is carried into
the port with `state_dict_from_jax`. Two mapped synthetic pairs (their
depth GT lies on the planes only, so the two views' counts differ) go
through one jitted JAX value-and-grad of `detect` plus
`depth_loss_siamese` in train mode and through the port's `detect` plus
its `depth_loss_siamese` on the CPU: the train-mode depth map within 1e-3
of its largest value (BN over the batch in the two top-down decoders
amplifies the frameworks' 1e-5 differences of the FPN inputs; measured
1.2e-4; the eval-mode depth0/depth1 are held to 1e-4 in
tests/test_torch_ablations.py), the loss within max(1e-4, 1e-3 relative),
the gradient of `depth` within 1e-3 relative, the new BN statistics of
`top_down_depth` within 5e-5 (tests/test_torch_train.py's tolerances), and
the gradient of `top_down_depth` within 1e-3 relative too, on a conditioned
init (`_condition`). The
bilinear resize of the depth map is held per element against
`jax.image.resize`. SGD's update rule is held against optax in
tests/test_torch_optimizer.py; here a DEPTH_ON train step with SGD.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.mapper import collate as jax_collate
from nopesac_tpu.data.synthetic import make_pair as jax_make_pair
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.losses import criterion as JCR

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.packing import batch_to_device
from nopesac_torch.engine.train import TrainStep, build_train_model
from nopesac_torch.losses.criterion import depth_loss_siamese
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
H, W = 96, 128
PAIRS = 2
LOSS_ABS, LOSS_REL = 1e-4, 1e-3  # tests/test_torch_train.py
GRAD_REL = 1e-3
BN_TOL = 5e-5
TRAIN_DEPTH_TOL = 1e-3  # of max |JAX depth|, train-mode map (see above)
# The port's own deviation, relative, when the batch's two pairs swap places
# (the same sums in another order): the conditioned init's 2.7e-6 with
# headroom, far under GRAD_REL, so that GRAD_REL measures the frameworks
SWAP_REL = 1e-4
OPTS = ["INPUT.IMAGE_SIZE", f"({H}, {W})", "MODEL.SEM_SEG_HEAD.DROPOUT", "0.0",
        "MODEL.MATCHING_HEAD.SINKHORN_ITERS", "10", "MODEL.DEPTH_ON", "True",
        "SOLVER.IMS_PER_BATCH", str(PAIRS)]


def _cfgs(extra=()):
    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(OPTS + list(extra))
        out.append(cfg)
    return out


def _numpy_batch(seed):
    mapper = JaxPairMapper(is_train=True, image_size=(H, W))
    pairs = [jax_make_pair(np.random.default_rng(seed + i), n_planes=n, h=H, w=W)
             for i, n in enumerate((2, 6))]
    batch = jax_collate([mapper(p) for p in pairs])
    batch.pop("meta")
    return batch


@pytest.mark.parametrize("src,dst", [((24, 32), (96, 128)), ((5, 7), (20, 28)),
                                     ((24, 32), (96, 128 * 2))])
def test_depth_resize_matches_jax_image_resize(src, dst):
    """`F.interpolate(bilinear, align_corners=False)`, which the port's depth
    loss and inference use, equals `jax.image.resize(..., "bilinear")` per
    element when it upsamples, edges included (half-pixel centres, the
    out-of-range tap dropped and the weights renormalised = clamped)."""
    x = np.random.default_rng(0).normal(0, 3, (3, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst), "bilinear"))
    got = F.interpolate(torch.from_numpy(x)[:, None], size=dst, mode="bilinear",
                        align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # the borders are where a different convention would show
    corners = F.interpolate(torch.from_numpy(x)[:, None], size=dst, mode="bilinear",
                            align_corners=True)[:, 0].numpy()
    assert np.abs(corners - want).max() > 1e-2


def _condition(params, sd, images):
    """Project the rows of `top_down_depth`'s m4 lateral kernel off the
    batch mean of its input, the encoder memory. The random model's memory
    carries a large common component at the 3x4 res5 map (the lateral's
    conv output reached |mean| / std = 100 per channel over the batch),
    where the BN's variance E[x^2] - E[x]^2 (Flax's, and the port's) loses
    about 13 bits. That rounding, 1.7e-4 of the lateral's output, then grew
    through the decoder's batch-statistics backward to 2.5e-3 of the
    module's gradient between two orders of the same batch in the port
    alone (2.9e-3 against JAX). Projected, the same swap moves it by
    2.7e-6 and JAX is 5e-4 away. The memory does not depend on the
    kernel; it is read from the port at the unconditioned weights, and
    the same conditioned kernel goes to both frameworks."""
    _, tcfg = _cfgs()
    tcfg.MODEL.CAMERA_ON = tcfg.MODEL.EMBEDDING_ON = False
    model = build_train_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    seen = {}
    model.sem_seg_head.top_down_depth.m_conv_dict["m4"][0].register_forward_hook(
        lambda _m, inputs, _out: seen.update(memory=inputs[0]))
    with torch.no_grad():
        model.detect(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    mean = seen["memory"].double().mean(dim=(0, 2, 3)).numpy()
    conv = params["plane_head"]["top_down_depth"]["m4_conv"]["Conv_0"]
    kernel = np.asarray(conv["kernel"], np.float64)  # [1, 1, in, out]
    along = np.einsum("i,abio->abo", mean, kernel) / (mean @ mean)
    conv["kernel"] = (kernel - mean[None, None, :, None] * along[:, :, None, :]).astype(np.float32)
    return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_loss_counts_in_the_prediction_dtype(dtype):
    """depth_loss_siamese at 480x640 on one pair (no model): the per-view
    counts of depth pixels are rounded to the prediction's dtype, as the
    JAX package sums its mask in that dtype, so a bf16 prediction's loss
    is JAX's within 1e-5; with bf16 the exact counts would miss it by more
    than 1e-4. The prediction is constant per view, so both resizes are
    exact and only the counts can differ."""
    rng = np.random.default_rng(7)
    level = np.asarray([1.5, 2.25], np.float32)  # exact in bf16
    pred = np.broadcast_to(level[:, None, None], (2, 120, 160)).copy()
    gt = np.where(rng.random((2, 480, 640)) < 0.7, rng.uniform(0.5, 5.0, (2, 480, 640)),
                  0.0).astype(np.float32)
    want = float(JCR.depth_loss_siamese(
        {"pixel_depth": jnp.asarray(pred)[..., None].astype(getattr(jnp, dtype))},
        {"depth": jnp.asarray(gt)}))
    got = float(depth_loss_siamese(
        {"pixel_depth": torch.from_numpy(pred)[:, None].to(getattr(torch, dtype))},
        {"depth": torch.from_numpy(gt)}))
    assert abs(got - want) <= 1e-5 * want, (got, want)
    mask = gt > 1e-4
    exact = np.mean([np.abs(level[v] - gt[v].astype(np.float64))[mask[v]].mean() for v in (0, 1)])
    if dtype == "bfloat16":
        assert abs(exact - want) > 1e-4 * want, (exact, want)
    else:
        assert abs(exact - want) <= 1e-5 * want, (exact, want)


@pytest.fixture(scope="module")
def depth_detect():
    jcfg, tcfg = _cfgs()
    jcfg.MODEL.CAMERA_ON = tcfg.MODEL.CAMERA_ON = False
    jcfg.MODEL.EMBEDDING_ON = tcfg.MODEL.EMBEDDING_ON = False
    jmodel = jax_build_model(jcfg)
    np_batch = _numpy_batch(3)
    images = np.concatenate([np_batch["image0"], np_batch["image1"]])
    depth = np.concatenate([np_batch["targets0"]["depth"], np_batch["targets1"]["depth"]])
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, True,
                                              method=jmodel.detect))(jnp.asarray(images))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["params"] = _condition(
        variables["params"],
        state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W)),
        images)

    def loss_fn(params, stats, x, gt):
        (_, out, _), state = jmodel.apply({"params": params, "batch_stats": stats}, x, True,
                                          method=jmodel.detect, mutable=["batch_stats"])
        return JCR.depth_loss_siamese(out, {"depth": gt}), (out["pixel_depth"],
                                                             state["batch_stats"])

    (loss, (pixel_depth, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(depth))
    ref = {"loss": float(loss), "pixel_depth": np.asarray(pixel_depth),
           "grads": state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), None,
                                        image_size=(H, W)),
           "bn": state_dict_from_jax(variables["params"],
                                     jax.tree_util.tree_map(np.asarray, new_bs),
                                     image_size=(H, W))}
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W))

    model = build_train_model(tcfg, device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    _, out, _ = model.detect(x)
    got_loss = depth_loss_siamese(out, {"depth": torch.from_numpy(depth)})
    got_loss.backward()
    got = {"loss": float(got_loss.detach()), "pixel_depth": out["pixel_depth"].detach(),
           "grads": {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
           "bn": {k: v for k, v in model.state_dict().items() if "running_" in k}}
    # the same batch with its pairs swapped in both views: the port's own noise
    swap = [1, 0, 3, 2]
    model = build_train_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    _, out, _ = model.detect(x[swap])
    depth_loss_siamese(out, {"depth": torch.from_numpy(depth[swap])}).backward()
    got["swapped_grads"] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return ref, got, sd, np_batch


def test_pixel_depth_and_loss_match_jax(depth_detect):
    ref, got, _, np_batch = depth_detect
    # the views' depth GT covers different numbers of pixels
    counts = [int((np_batch[f"targets{v}"]["depth"] > 1e-4).sum()) for v in (0, 1)]
    assert min(counts) > 0 and counts[0] != counts[1], counts
    want = ref["pixel_depth"].transpose(0, 3, 1, 2)  # NHWC -> NCHW
    assert tuple(got["pixel_depth"].shape) == want.shape == (2 * PAIRS, 1, H // 4, W // 4)
    np.testing.assert_allclose(got["pixel_depth"].numpy(), want, rtol=0,
                               atol=TRAIN_DEPTH_TOL * np.abs(want).max())
    assert abs(got["loss"] - ref["loss"]) <= max(LOSS_ABS, LOSS_REL * abs(ref["loss"])), \
        (got["loss"], ref["loss"])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("module,swap_check", [("sem_seg_head.top_down_depth", True),
                                               ("sem_seg_head.depth", False)])
def test_depth_branch_gradients_match_jax(depth_detect, module, swap_check):
    """The depth branch's gradients within GRAD_REL of JAX's; for the
    decoder, which the conditioning is for, the port's own deviation when
    the pairs swap stays under SWAP_REL, so that the fixture cannot drift
    back to where rounding decides the comparison."""
    ref, got, _, _ = depth_detect
    names = sorted(n for n in got["grads"] if n.startswith(module + "."))
    assert names, module

    def flat(tree):
        return np.concatenate([tree[n].numpy().ravel() for n in names])

    g, r = flat(got["grads"]), flat(ref["grads"])
    assert np.abs(r).max() > 0
    own = _rel(flat(got["swapped_grads"]), g)
    if swap_check:
        assert own <= SWAP_REL, (module, own)
    assert _rel(g, r) <= GRAD_REL, (module, _rel(g, r), own)


def test_depth_branch_bn_statistics_match_jax(depth_detect):
    ref, got, sd, _ = depth_detect
    keys = [k for k in got["bn"] if k.startswith("sem_seg_head.top_down_depth.")]
    assert len(keys) == 2 * 8
    for k in keys:
        assert not torch.equal(got["bn"][k], sd[k]), k
        torch.testing.assert_close(got["bn"][k], ref["bn"][k], rtol=BN_TOL, atol=BN_TOL)


def test_train_forward_adds_loss_depth_pixel(depth_detect):
    """train_forward of the whole model (the detect weights of the fixture,
    the rest seeded) returns loss_depth_pixel at weight 1.0: the depth loss
    of its own detect outputs."""
    _, got, sd, np_batch = depth_detect
    _, tcfg = _cfgs()
    model = build_train_model(tcfg, device="cpu", seed=1)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and missing
    assert all(k.startswith(("matching_head.", "camera_head_list.")) for k in missing)
    with torch.no_grad():
        losses = model.train_forward(batch_to_device(np_batch, "cpu"), torch.Generator())
    assert "loss_depth_pixel" in losses
    assert abs(float(losses["loss_depth_pixel"]) - got["loss"]) <= 1e-6 * got["loss"]
    tcfg.MODEL.DEPTH_ON = False
    plain = build_train_model(tcfg, device="cpu", seed=1)
    with torch.no_grad():
        losses = plain.train_forward(batch_to_device(np_batch, "cpu"), torch.Generator())
    assert "loss_depth_pixel" not in losses


def test_sgd_train_step_with_depth(depth_detect):
    """One TrainStep with SOLVER.OPTIMIZER SGD and DEPTH_ON: finite losses,
    the update applied, every trained parameter with a momentum buffer, the
    depth branch moved by -lr * mult * (buf + wd * p) (buf = its gradient
    on the first step)."""
    _, _, _, np_batch = depth_detect
    _, tcfg = _cfgs(["SOLVER.OPTIMIZER", "SGD", "SOLVER.BASE_LR", "1e-3",
                     "SOLVER.WARMUP_ITERS", "0", "SOLVER.WEIGHT_DECAY", "0.05",
                     "SOLVER.CLIP_GRADIENTS.ENABLED", "False"])
    model = build_train_model(tcfg, device="cpu", seed=2)
    step = TrainStep(model, tcfg, seed=0)
    head = model.sem_seg_head.depth
    before = head.weight.detach().clone()
    metrics = step(batch_to_device(np_batch, "cpu"))
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert "loss_depth_pixel" in metrics
    state = step.optimizer.state
    assert all("momentum_buffer" in state[p] for p in step.params)
    grad = state[head.weight]["momentum_buffer"]
    lr = next(g["lr"] for g in step.optimizer.param_groups
              if any(p is head.weight for p in g["params"]))
    assert lr == pytest.approx(1e-3 * tcfg.SOLVER.SEM_SEG_HEAD_MULTIPLIER)
    torch.testing.assert_close(head.weight.detach(), before - lr * (grad + 0.05 * before),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("fpn", ["float32", "bfloat16"])
def test_depth_branch_follows_the_pixel_path_dtype(fpn):
    """Under MODEL.COMPUTE_DTYPE bfloat16 the depth branch computes in the
    pixel path's dtype, as the JAX head's px_dtype: FPN_TRAIN_DTYPE in
    training, COMPUTE_DTYPE at inference; the depth loss is f32 and finite."""
    _, tcfg = _cfgs(["MODEL.COMPUTE_DTYPE", "bfloat16", "MODEL.BACKBONE_TRAIN_DTYPE", "bfloat16",
                     "MODEL.FPN_TRAIN_DTYPE", fpn, "MODEL.CAMERA_ON", "False",
                     "MODEL.EMBEDDING_ON", "False"])
    model = build_train_model(tcfg, device="cpu", seed=3)
    np_batch = _numpy_batch(5)
    x = torch.from_numpy(np.concatenate([np_batch["image0"], np_batch["image1"]]))
    x = x.permute(0, 3, 1, 2).contiguous()
    gt = torch.from_numpy(np.concatenate([np_batch[f"targets{v}"]["depth"] for v in (0, 1)]))
    _, out, _ = model.detect(x)
    assert out["pixel_depth"].dtype == out["pixel_centers"].dtype == getattr(torch, fpn)
    loss = depth_loss_siamese(out, {"depth": gt})
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    model.eval()
    with torch.no_grad():
        _, out, _ = model.detect(x)
    assert out["pixel_depth"].dtype == torch.bfloat16
