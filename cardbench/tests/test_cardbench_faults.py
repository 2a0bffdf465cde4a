"""Each fault a cell can have, planted in the program underneath a run on
the CPU at the small sizes, turns `correct` false: a step that leaves its
state unchanged, half of the batch left out (the mean over the rest), and
an answer altered where it is produced. (The cells run on one card: no
exchange between cards to leave out.)"""
from __future__ import annotations

import pytest
import torch

from cardbench.harness import runner

from conftest import small_run


def _fails(name, monkeypatch, plant):
    plant(monkeypatch)
    result = runner.execute(small_run(name, seconds=0.1))
    assert not result["correct"], result["compared"]
    return result


def _eval_half_batch(monkeypatch):
    from nopesac_torch.models.nopesac import PlaneTRNopeSAC

    inference = PlaneTRNopeSAC.inference

    def half(self, images0, images1, *args, **kwargs):
        b = images0.shape[0]
        keep = max(b // 2, 1)
        idx = torch.arange(b, device=images0.device) % keep
        return inference(self, images0[idx], images1[idx], *args, **kwargs)

    monkeypatch.setattr(PlaneTRNopeSAC, "inference", half)


def _eval_altered_camera(monkeypatch):
    from nopesac_torch.models.nopesac import PlaneTRNopeSAC

    inference = PlaneTRNopeSAC.inference

    def altered(self, *args, **kwargs):
        out = inference(self, *args, **kwargs)
        out["cameras"]["camera"]["tran"][0, 0] += 1e-3
        return out

    monkeypatch.setattr(PlaneTRNopeSAC, "inference", altered)


def _eval_altered_plane(monkeypatch):
    from nopesac_torch.models.nopesac import PlaneTRNopeSAC

    select = PlaneTRNopeSAC.select_planes

    def altered(self, *args, **kwargs):
        out = select(self, *args, **kwargs)
        out["params"] = out["params"] * 1.001
        return out

    monkeypatch.setattr(PlaneTRNopeSAC, "select_planes", altered)


@pytest.mark.parametrize("plant", (_eval_half_batch, _eval_altered_camera, _eval_altered_plane))
def test_eval_faults(plant, monkeypatch):
    _fails("eval_entry_bs4", monkeypatch, plant)


def _train_unchanged(monkeypatch):
    from nopesac_torch.engine.train import TrainStep

    def no_update(self, finite_total=True):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        return torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])), True

    monkeypatch.setattr(TrainStep, "apply_gradients", no_update)


def _train_half_batch(monkeypatch):
    from nopesac_torch.engine.train import TrainStep

    forward_backward = TrainStep.forward_backward

    def half(self, batch, *args, **kwargs):
        b = batch["image0"].shape[0]
        keep = max(b // 2, 1)

        def cut(v):
            if isinstance(v, dict):
                return {k: cut(x) for k, x in v.items()}
            return v[:keep] if isinstance(v, torch.Tensor) and v.shape[:1] == (b,) else v

        return forward_backward(self, cut(batch), *args, **kwargs)

    monkeypatch.setattr(TrainStep, "forward_backward", half)


def _train_altered_loss(monkeypatch):
    from nopesac_torch.losses import criterion
    from nopesac_torch.models import nopesac

    losses = criterion.detection_losses_siamese

    def altered(*args, **kwargs):
        out = losses(*args, **kwargs)
        out["loss_ce"] = out["loss_ce"] * 2.0
        return out

    monkeypatch.setattr(nopesac, "detection_losses_siamese", altered)


@pytest.mark.parametrize("plant", (_train_unchanged, _train_half_batch, _train_altered_loss))
def test_train_faults(plant, monkeypatch):
    _fails("train_step3_bs16", monkeypatch, plant)
