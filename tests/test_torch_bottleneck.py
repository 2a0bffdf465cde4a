"""Kernel B4 (fused 1x1 conv + FrozenBN + residual + ReLU) and the fused-tail
backbone against the JAX package.

B4's plain version, which the CPU runs, is held against the Pallas kernel
in interpret mode at the shapes of its JAX test; the port's
`ResNet(fuse_tail=True)` in eval mode against the JAX `ResNet(fuse_tail=True)`
on shared weights (on the CPU the JAX side takes its unfused path, the same
function). The kernel itself runs on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.models.resnet import ResNet as JaxResNet
from nopesac_tpu.ops.bottleneck_pallas import conv1x1_bn_add_relu

from nopesac_torch.engine.predict import build_model_from_cfg
from nopesac_torch.models import resnet
from nopesac_torch.ops import bottleneck
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

from test_torch_slice import _cfgs

BF16_TOL = 2e-2   # tests/test_pallas_ops.py: bf16 inputs and output
F32_TOL = 1e-5    # relative to max |ref|: f32 sums over Cin in another order
MODULE_TOL = 1e-4  # rel + abs, the backbone test of tests/test_torch_models.py
H, W = 64, 96
IDENTITY_BLOCKS = 12  # res2..res5: 3 + 4 + 6 + 3 blocks, less one shortcut block each


def _b4_inputs(seed, with_residual):
    """The inputs of tests/test_pallas_ops.py: B=2, P=300 (not a tile
    multiple), 64 -> 256."""
    rng = np.random.default_rng(seed)
    b, p, cin, cout = 2, 300, 64, 256
    x = rng.normal(size=(b, p, cin)).astype(np.float32)
    w = rng.normal(size=(cin, cout)).astype(np.float32) * 0.1
    scale = rng.normal(size=(cout,)).astype(np.float32)
    shift = rng.normal(size=(cout,)).astype(np.float32)
    res = rng.normal(size=(b, p, cout)).astype(np.float32) if with_residual else None
    return x, w, scale, shift, res


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_residual,relu", [(True, True), (False, False), (True, False),
                                                (False, True)])
def test_plain_matches_pallas_kernel(dtype, with_residual, relu):
    x, w, scale, shift, res = _b4_inputs(0, with_residual)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = conv1x1_bn_add_relu(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
        residual=None if res is None else jnp.asarray(res).astype(jdt), relu=relu,
        tile_px=256, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    # the port is NCHW: x [B, Cin, P], the conv weight [Cout, Cin, 1, 1]
    tx = torch.from_numpy(x.transpose(0, 2, 1).copy()).to(tdt)
    tw = torch.from_numpy(w.T.copy())[:, :, None, None]
    tres = None if res is None else torch.from_numpy(res.transpose(0, 2, 1).copy()).to(tdt)
    got = bottleneck.conv1x1_bn_act(tx, tw, torch.from_numpy(scale), torch.from_numpy(shift),
                                    residual=tres, relu=relu)
    assert got.dtype == tdt and got.shape == (2, 256, 300)
    got = got.float().numpy().transpose(0, 2, 1)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL)
    else:
        assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


def test_cuda_wrapper_takes_only_cuda_tensors():
    x, w, scale, shift, _ = _b4_inputs(1, False)
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck.conv1x1_bn_act_cuda(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                                       torch.from_numpy(w.T.copy()), torch.from_numpy(scale),
                                       torch.from_numpy(shift))


def _perturb_bn(tree, rng):
    """Non-trivial FrozenBN statistics and affines in a JAX backbone tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng)
        elif k == "mean":
            out[k] = (np.asarray(v) + rng.normal(0, 0.05, v.shape)).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = (np.asarray(v) * rng.uniform(0.8, 1.25, v.shape)).astype(np.float32)
        elif k == "bias":
            out[k] = (np.asarray(v) + rng.normal(0, 0.05, v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def backbones():
    """JAX ResNet(fuse_tail=True) and its features on seeded images, and the
    port's ResNet(fuse_tail=True) on the same weights."""
    x = np.random.default_rng(0).normal(0, 1, (2, H, W, 3)).astype(np.float32)
    jmodel = JaxResNet(fuse_tail=True)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _perturb_bn(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(1))
    ref = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params, jnp.asarray(x))
    sd = {k[len("backbone."):]: v for k, v in state_dict_from_jax({"backbone": params}).items()}
    model = resnet.ResNet(fuse_tail=True).eval()
    model.load_state_dict(sd, strict=True)
    return x, jax.tree_util.tree_map(np.asarray, ref), model


def test_fused_backbone_matches_jax(backbones):
    x, ref, model = backbones
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for name in ("res2", "res3", "res4", "res5"):
        np.testing.assert_allclose(got[name].numpy().transpose(0, 2, 3, 1), ref[name],
                                   rtol=MODULE_TOL, atol=MODULE_TOL, err_msg=name)


def test_fused_tail_runs_in_eval_only_on_identity_blocks(backbones, monkeypatch):
    """Two B4 calls per identity block in eval mode, none in train mode, and
    the fused and unfused blocks agree."""
    x, _, model = backbones
    calls = []

    def counting(*args, **kwargs):
        calls.append(kwargs.get("residual") is not None)
        return bottleneck.conv1x1_bn_act(*args, **kwargs)

    monkeypatch.setattr(resnet, "conv1x1_bn_act", counting)
    images = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    unfused = resnet.ResNet().eval()
    unfused.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        fused_out, plain_out = model(images), unfused(images)
        assert calls == [False, True] * IDENTITY_BLOCKS
        model.train()
        try:
            model(images)
        finally:
            model.eval()
    assert len(calls) == 2 * IDENTITY_BLOCKS
    for name, v in plain_out.items():
        scale = float(v.abs().max())
        assert float((fused_out[name] - v).abs().max()) <= F32_TOL * scale, name


def test_fuse_tail_adds_no_parameters():
    plain, fused = resnet.ResNet(), resnet.ResNet(fuse_tail=True)
    assert list(plain.state_dict()) == list(fused.state_dict())
    _, tcfg = _cfgs()
    models = [build_model_from_cfg(tcfg, device="cpu", fuse_tail=f) for f in (False, True)]
    assert list(models[0].state_dict()) == list(models[1].state_dict())
    assert all(m.backbone.res2[1].fuse_tail == f for m, f in zip(models, (False, True)))
