"""The one global step that `world` ranks take together, in one process.

The port's ranks each run `train_forward` on their slice of the global
batch (`per_rank` pairs) and sum through collectives what the global batch
shares: the moments of the trainable BatchNorms, the criterion's
normalisers, the skip guard's total, the losses and the gradients. The
reference does none of that: its `parallel/dist.py` stays the identity, and
one forward over the whole batch takes each of those sums over all of it at
once. What differs from rank to rank is the random stream: rank r draws its
dropout masks and AIM random poses from a generator seeded `seed + r`.
`global_step()` makes the reference's train step draw that way: each draw of
the global batch is made slice by slice, slice r from rank r's generator at
rank r's shape and in rank r's call order, and put back in batch order.

Batch order: every draw's leading dimension is a whole number of groups of
the global batch (the two views of the transformer's 2B images; the AIM
poses' count per pair), each group laid out pair by pair. Rank r's local row
j is the global row (j // per_rank) * world * per_rank + r * per_rank +
j % per_rank. Within the reference nothing calls a collective or starts a
process."""
from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence

import torch

from . import build
from .losses import camera_losses
from .models import layers, transformer


class RankStreams:
    """The random streams of `world` ranks of `per_rank` pairs each: rank r's
    generator is seeded `seed + r` on `device`, as the port's
    `engine/train.py:TrainStep` seeds it."""

    def __init__(self, seed: int, world: int, per_rank: int, device):
        self.world = int(world)
        self.per_rank = int(per_rank)
        self.gens = [torch.Generator(device=device).manual_seed(int(seed) + r)
                     for r in range(self.world)]

    def rows(self, n: int) -> List[torch.Tensor]:
        """For each rank, the global rows of its local rows of a draw with n
        global rows."""
        block = self.world * self.per_rank
        if n % block:
            raise ValueError(f"a draw of {n} rows is no whole number of {self.world} ranks' "
                             f"{self.per_rank} pairs")
        local = torch.arange(n // self.world)
        return [(local // self.per_rank) * block + r * self.per_rank + local % self.per_rank
                for r in range(self.world)]

    def draw(self, shape: Sequence[int], like: Callable) -> torch.Tensor:
        """A draw of `shape`, slice r made by like(local shape, rank r's
        generator)."""
        shape = tuple(shape)
        local = (shape[0] // self.world,) + shape[1:]
        out = None
        for gen, idx in zip(self.gens, self.rows(shape[0])):
            part = like(local, gen)
            if out is None:
                out = part.new_empty(shape)
            out[idx.to(part.device)] = part
        return out


def _dropout(x: torch.Tensor, p: float, gen) -> torch.Tensor:
    """`layers.dropout`, its mask drawn per rank from `RankStreams`."""
    if not isinstance(gen, RankStreams):
        return layers.dropout(x, p, gen)
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = gen.draw(x.shape, lambda shape, g: torch.bernoulli(
        torch.full_like(x[:shape[0]], keep), generator=g))
    return torch.where(mask > 0, x / keep, torch.zeros_like(x))


def _uniform(gen: RankStreams, n: int, device) -> torch.Tensor:
    return gen.draw((n, 3), lambda shape, g: torch.rand(shape, generator=g, device=device))


def _rand_aim_rot(gen, batch_size: int, device=None) -> torch.Tensor:
    if not isinstance(gen, RankStreams):
        return _RAND_AIM_ROT(gen, batch_size, device)
    return camera_losses.rot_from_uniform(_uniform(gen, batch_size, device))


def _rand_aim_trans(gen, batch_size: int, device=None) -> torch.Tensor:
    if not isinstance(gen, RankStreams):
        return _RAND_AIM_TRANS(gen, batch_size, device)
    return camera_losses.trans_from_uniform(_uniform(gen, batch_size, device))


_RAND_AIM_ROT = camera_losses.rand_aim_rot
_RAND_AIM_TRANS = camera_losses.rand_aim_trans


@contextlib.contextmanager
def global_step(world: int, per_rank: int):
    """Inside the block, `build.TrainStep(model, cfg, seed)` is the global
    step of `world` ranks of `per_rank` pairs: its generator is the ranks'
    `RankStreams`, which the transformer's dropout and the AIM poses draw
    from slice by slice."""
    base = build.TrainStep

    class GlobalStep(base):
        def __init__(self, model, cfg, seed: int = 0):
            super().__init__(model, cfg, seed=seed)
            self.gen = RankStreams(seed, world, per_rank, next(model.parameters()).device)

    saved = (build.TrainStep, transformer.dropout, camera_losses.rand_aim_rot,
             camera_losses.rand_aim_trans)
    build.TrainStep = GlobalStep
    transformer.dropout = _dropout
    camera_losses.rand_aim_rot, camera_losses.rand_aim_trans = _rand_aim_rot, _rand_aim_trans
    try:
        yield
    finally:
        (build.TrainStep, transformer.dropout, camera_losses.rand_aim_rot,
         camera_losses.rand_aim_trans) = saved
