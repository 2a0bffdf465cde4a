"""The controls that the limits of `correct` are set against: the
reference put in the program's place, computed one precision below what
the configuration states, on the inputs a run of the cell draws from its
seed.

* eval cells (f32 with TF32 off): the reference with TF32 on, against the
  reference as stated, on the run's pool pairs in its batches;
* train cells (bf16): the reference with every bf16 matrix product's
  operands rounded to fp8 (e4m3, one scale per tensor, as an fp8 recipe
  does), against the reference as stated, over the three checked steps,
  and the window's first step from the fp8 reference's own state.
Each returns the numbers of the cell's check (`evalcheck.gaps`,
`traincheck.all_gaps`)."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from . import evalcheck, scenes, traincheck

FP8_MAX = 448.0  # float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through fp8 e4m3 with one scale per tensor; the gradient passes
    straight through."""
    if x.dtype != torch.bfloat16:
        return x
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


@contextlib.contextmanager
def fp8_products():
    """Every bf16 convolution and linear of the reference on fp8-rounded
    operands."""
    import torch.nn.functional as F

    from ..reference.models import layers, resnet

    conv = layers.conv2d
    linear_forward = layers.Linear.forward

    def conv2d(x, weight, bias=None, *args, **kwargs):
        return conv(fp8_round(x), fp8_round(weight), bias, *args, **kwargs)

    def forward(self, x):
        dt = self.compute_dtype()
        if dt != torch.bfloat16:
            return linear_forward(self, x)
        return F.linear(fp8_round(x.to(dt)), fp8_round(self.weight.to(dt)),
                        None if self.bias is None else self.bias.to(dt))

    layers.conv2d = resnet.conv2d = conv2d
    layers.Linear.forward = forward
    try:
        yield
    finally:
        layers.conv2d = resnet.conv2d = conv
        layers.Linear.forward = linear_forward


def eval_readings(ctx, n_batches: int, batch: int) -> Dict[str, float]:
    """TF32 reference against the stated reference on `n_batches` batches of
    `batch` pairs of the run's pool. The control's outputs also go through
    the entry point's host path (the program's postprocess and evaluator, as
    in the program's place) and its records are held to the stated
    reference as a run's are ("evaluator." numbers)."""
    from ..reference.build import set_precision

    tr = ctx.traffic
    h, w = ctx.tree["INPUT"]["IMAGE_SIZE"]
    pool = scenes.pool(ctx.rng(1), tr["pool_pairs"], tr["planes"], h, w)
    pairs = scenes.split(ctx.rng(2), pool, n_batches * batch, 0)
    batches = [pairs[k * batch:(k + 1) * batch] for k in range(n_batches)]
    ref = ctx.reference_model(train=False)
    want = evalcheck.reference_outputs(ctx, ref, batches)
    set_precision(tf32=True)
    try:
        got = evalcheck.reference_outputs(ctx, ref, batches)
    finally:
        set_precision()
    out = evalcheck.worst([evalcheck.gaps(g, r) for g, r in zip(got, want)])
    from nopesac_torch.evaluation.evaluator import MP3DEvaluator
    from nopesac_torch.evaluation.postprocess import postprocess_batch

    cfg = ctx.program_cfg()
    rows = []
    for pairs_k, g, r in zip(batches, got, want):
        evaluator = MP3DEvaluator(cfg.DATASETS.TEST[0], cfg, dataset_list=pairs_k)
        metas = [{f"{key}{v}": p[v][key] for v in "01" for key in ("image_id", "file_name")}
                 for p in pairs_k]
        evaluator.process(pairs_k, postprocess_batch(g, metas, height=h, width=w))
        rows.append(evalcheck.record_gaps(evaluator._predictions, r))
    out.update({"evaluator." + k: v for k, v in evalcheck.worst(rows).items()})
    return out


def train_readings(ctx) -> Dict[str, float]:
    """The fp8 reference in the program's place: its three steps against the
    stated reference's, and its window step from its own state against the
    stated reference's step from that state."""
    pairs = traincheck.make_pairs(ctx)
    seed = traincheck.step_seed(ctx)
    with fp8_products():
        got = traincheck.reference_steps(ctx, pairs, seed)
    want = traincheck.reference_steps(ctx, pairs, seed, state=got["own"])
    return traincheck.all_gaps(got, want)
