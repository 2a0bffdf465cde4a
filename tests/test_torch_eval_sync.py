"""The eval step makes no constant from a host value per call.

On a card, `x.new_tensor(c)` and `torch.tensor(c, device=...)` copy a
pageable host value to the device, and such a copy makes the host wait until
the stream has drained: the one-deep pipeline of `EvalRunner.test` then
overlaps nothing. Here, on the CPU, the eval step runs at
`configs/smoke_synthetic.yaml`'s size with both calls refused, after one warm
step (constants kept per device are made once, there), and must give what it
gives with them allowed. `tests/test_torch_gpu.py` runs the step on the card
under `torch.cuda.set_sync_debug_mode("error")`.
"""
import numpy as np
import pytest
import torch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.core import geometry
from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step, synthetic_pairs
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

B = 2


def _same(a, b, path="out"):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _ablation_inputs(kind, nq, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "gt_geo":
        return {"gt_geo": {
            "params0": rng.normal(size=(B, nq, 3)).astype(np.float32),
            "params1": rng.normal(size=(B, nq, 3)).astype(np.float32),
            "corr_idx1": rng.integers(0, nq, size=(B, nq)),
            "corr_idx2": rng.integers(0, nq, size=(B, nq)),
            "corr_valid": rng.random((B, nq)) < 0.3}}
    if kind == "init_cam":
        return {"init_cam": {"tran": rng.normal(size=(B, 3)).astype(np.float32),
                             "rot": rng.normal(size=(B, 4)).astype(np.float32)}}
    return {}


@pytest.mark.parametrize("cam_type,ablation", [("soft", None), ("max-score", "gt_geo"),
                                                ("min-cost", "init_cam")])
def test_eval_step_makes_no_constant_from_a_host_value(monkeypatch, cam_type, ablation):
    cfg = get_cfg()
    cfg.merge_from_file("configs/smoke_synthetic.yaml")
    cfg.merge_from_list(["MODEL.CAMERA_HEAD.INFERENCE_OUT_CAM_TYPE", cam_type])
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device="cpu", seed=0)
    step = make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    images = synthetic_pairs(B, h, w, seed=1, device="cpu")
    extra = _ablation_inputs(ablation, cfg.MODEL.SEM_SEG_HEAD.NUM_OBJECT_QUERIES)
    step(*images, **extra)
    allowed = step(*images, **extra)

    def new_tensor(self, *args, **kwargs):
        raise AssertionError("Tensor.new_tensor in the eval step")

    tensor = torch.tensor

    def tensor_on_host(*args, **kwargs):
        if kwargs.get("device") is not None:
            raise AssertionError("torch.tensor(..., device=...) in the eval step")
        return tensor(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "new_tensor", new_tensor)
        m.setattr(torch, "tensor", tensor_on_host)
        refused = step(*images, **extra)
    assert "cameras" in refused and "camera_onePP" in refused
    _same(refused, allowed)


def test_flip_kept_from_inference_mode_serves_a_backward():
    """The axis flip is made once per (device, dtype), possibly first inside
    the eval step's inference mode; training must still be able to save it
    for the backward."""
    geometry._flip_vector.cache_clear()
    planes = torch.randn(5, 3, dtype=torch.float64)
    with torch.inference_mode():
        flipped = geometry.warp_planes_identity(planes)
    planes.requires_grad_(True)
    again = geometry.warp_planes_identity(planes)
    again.sum().backward()
    assert torch.equal(again.detach(), flipped)
    assert torch.equal(planes.grad, torch.tensor([[1.0, -1.0, -1.0]] * 5, dtype=torch.float64))
