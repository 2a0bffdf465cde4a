"""Precise BatchNorm statistics (counterpart of the JAX package's
`engine/precise_bn.py`, detectron2 / fvcore PreciseBN; TEST.PRECISE_BN).

Running averages trail the parameters by about 1 / (1 - momentum) steps,
~100 steps in the camera stacks (momentum 0.99), and eval-mode outputs then
drift from train-mode ones. The cure: with the parameters frozen, stream up
to NUM_ITER training batches through the train-mode forward and put each BN
layer's arithmetic mean of the per-batch means and variances in its running
statistics.

The port's `models/layers.py:BatchNorm2d` already has Flax's semantics
(biased variance; ra = m * ra + (1 - m) * batch stat), so no algebra is
needed to recover a batch's statistics: with every momentum set to 0 for
the pass, each forward leaves exactly the batch's statistics in the running
buffers.

Across ranks the statistics of each forward are the global batch's
(`models/layers.py:BatchNorm2d`), so every rank must run the same number
of forwards: a rank goes on only while every rank has a batch, and keeps
the new statistics only where they are finite on every rank (all-reduces
of MIN).
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, Optional

import torch

from ..data.packing import batch_to_device
from ..models.layers import BatchNorm2d
from ..models.nopesac import PlaneTRNopeSAC
from ..parallel.dist import all_true

logger = logging.getLogger(__name__)


def recompute_batch_stats(model: PlaneTRNopeSAC, batches: Iterable[Dict], num_iter: int = 200,
                          gen: Optional[torch.Generator] = None) -> int:
    """Replace the running statistics of every BatchNorm2d of `model` by
    their mean over at most `num_iter` of `batches` (collated numpy batches
    or batches on the model's device, "image0"/"image1" NHWC). `gen` draws
    the transformer's dropout during the pass (None: no dropout). The
    parameters, the training mode and the momenta are left as they were; no
    batch, or a non-finite result, keeps the old statistics. Returns the
    number of batches used."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    if not layers:
        return 0
    dev = next(model.parameters()).device
    momenta = [m.momentum for m in layers]
    sums = [(torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var)) for m in layers]
    old = [(m.running_mean.clone(), m.running_var.clone()) for m in layers]
    was_training = model.training
    n = 0
    model.train()
    try:
        for m in layers:
            m.momentum = 0.0
        with torch.no_grad():
            it = iter(batches)
            while n < num_iter:
                batch = next(it, None)
                if not all_true(batch is not None, dev):
                    break
                images = [batch[k] if isinstance(batch[k], torch.Tensor)
                          else batch_to_device({k: batch[k]}, dev)[k] for k in ("image0", "image1")]
                model.bn_stats_forward(*images, gen=gen)
                for m, (s_mean, s_var) in zip(layers, sums):
                    s_mean += m.running_mean
                    s_var += m.running_var
                n += 1
            finite = all_true(all(bool(torch.isfinite(s_mean).all() & torch.isfinite(s_var).all())
                                  for s_mean, s_var in sums), dev)
            if n and not finite:
                logger.warning("precise-BN: non-finite statistics; keeping the old running "
                               "statistics")
            for m, (s_mean, s_var), (o_mean, o_var) in zip(layers, sums, old):
                m.running_mean.copy_(s_mean / n if n and finite else o_mean)
                m.running_var.copy_(s_var / n if n and finite else o_var)
    finally:
        for m, mom in zip(layers, momenta):
            m.momentum = mom
        model.train(was_training)
    return n if finite else 0
