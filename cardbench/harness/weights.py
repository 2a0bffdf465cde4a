"""The benchmark's own weights: every parameter of the model drawn from the
run's seed on the device, in one call of a `torch.Generator` there, by the
init rules of the port's `utils/weights.py:seeded_init` (xavier-uniform
convolutions and linears, each third of a packed `in_proj` on its own; zero
biases; unit norm scales; N(0, 1) query embeddings; `bin_score` 1; the
shared pose regressors `trans`/`rots` U(+-1/16)). The parameters' names and
shapes come from the reference's model built on the meta device, so the
program and the reference take the same tensors and neither makes them.
Buffers (frozen BN statistics, position tables) are each model's own
construction and are not drawn."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...]]


def param_specs(model: torch.nn.Module) -> List[Spec]:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def _rule(name: str, shape: Tuple[int, ...]):
    """("uniform", bound) / ("xavier3", bound) / ("normal",) / ("const", v)."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if owner in ("trans", "rots") and ".camera_head_list." in f".{name}":
        return ("uniform", 1.0 / math.sqrt(256))
    if leaf == "in_proj_weight":
        return ("uniform", math.sqrt(6.0 / (2 * shape[1])))  # each [E, E] third
    if name.endswith("query_embed.weight"):
        return ("normal",)
    if leaf == "bin_score":
        return ("const", 1.0)
    if len(shape) >= 2:
        recept = math.prod(shape[2:]) if len(shape) > 2 else 1
        return ("uniform", math.sqrt(6.0 / ((shape[0] + shape[1]) * recept)))
    if leaf in ("bias", "in_proj_bias"):
        return ("const", 0.0)
    return ("const", 1.0)


def seeded_params(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`, from one uniform and one normal draw."""
    rules = [(n, s, _rule(n, s)) for n, s in specs]
    n_uni = sum(math.prod(s) for _, s, r in rules if r[0] == "uniform")
    n_norm = sum(math.prod(s) for _, s, r in rules if r[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2.0).sub_(1.0)
    nrm = torch.randn(max(n_norm, 1), generator=gen, device=device)
    out, ku, kn = {}, 0, 0
    with torch.no_grad():
        for name, shape, rule in rules:
            n = math.prod(shape)
            if rule[0] == "uniform":
                out[name] = uni[ku:ku + n].view(shape).mul_(rule[1])
                ku += n
            elif rule[0] == "normal":
                out[name] = nrm[kn:kn + n].view(shape)
                kn += n
            else:
                out[name] = torch.full(shape, rule[1], device=device)
    return out


def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy `params` into the model's parameters; every parameter must be
    given and every given tensor must be a parameter of the model."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
        raise KeyError(f"weights do not fit the model: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)} vs {tuple(params[name].shape)}")
            p.copy_(params[name])
