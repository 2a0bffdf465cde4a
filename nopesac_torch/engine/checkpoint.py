"""Checkpoints of the port: the one weight loader of both entry points, and
the training checkpoints that `--resume` reads (counterpart of the JAX
package's `engine/checkpoint.py` and of `Trainer._load_weights`).

Weights (`load_weights`) come from a torch `.pth` file: a state_dict, or
detectron2's `{"model": state_dict, ...}`. The tensors that are not model
weights (`NON_PARAMETER_SUFFIXES`: the reference criterion's
`empty_weight`, BatchNorm's `num_batches_tracked`) are dropped first, as
the JAX package's importer leaves them unconsumed. Evaluation loads the rest
strictly: any other missing or unexpected key raises. Training (MODEL.WEIGHTS
of curriculum step N+1 naming step N's `model_final.pth`) overlays the file
on the model by key and shape, as `merge_pytree` does: keys only in the model
keep their init and are reported missing, keys only in the file are reported
unexpected, and a shape mismatch counts as both and is never fatal.

Training checkpoints use detectron2's layout, the one the curriculum yamls
name (`train_mp3d_step2.yaml:21` sets MODEL.WEIGHTS to
`ckpts_mp3d/step1/model_final.pth`): `OUTPUT_DIR/model_{iter:07d}.pth`,
`OUTPUT_DIR/model_final.pth` and `OUTPUT_DIR/last_checkpoint`, a text file
holding the newest file's name. (The JAX package writes orbax directories
under `OUTPUT_DIR/checkpoints/` instead.) Each file is one `torch.save` dict
`{"model": state_dict, "optimizer": AdamW state_dict, "iteration": N,
"trainer": {"step", "updates", "generator"}}`, the last three from
`engine/train.py:TrainStep.state_dict`. Across ranks, rank 0 writes and
every rank waits for it; every rank restores the same file.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..parallel.dist import barrier, is_main_process

logger = logging.getLogger(__name__)

NON_PARAMETER_SUFFIXES = ("criterion.empty_weight", "num_batches_tracked")
MARKER = "last_checkpoint"


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model tensors of a `.pth` checkpoint on the CPU, without the
    non-parameter keys."""
    if not path.endswith(".pth"):
        raise NotImplementedError(f"MODEL.WEIGHTS must name a torch .pth checkpoint, got {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.WEIGHTS not found: {path}")
    state = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in state:
        state = state["model"]
    return {k: torch.as_tensor(v) for k, v in state.items()
            if not k.endswith(NON_PARAMETER_SUFFIXES)}


def overlay_state_dict(template: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """`loaded` over `template` by key and shape: (merged, missing,
    unexpected), with `merge_pytree`'s report strings."""
    merged, missing, unexpected = {}, [], []
    for key, tpl in template.items():
        if key not in loaded:
            missing.append(key)
            merged[key] = tpl
        elif tuple(loaded[key].shape) != tuple(tpl.shape):
            what = f"{key} (shape {tuple(loaded[key].shape)} != {tuple(tpl.shape)})"
            missing.append(what)
            unexpected.append(what)
            merged[key] = tpl
        else:
            merged[key] = loaded[key].to(tpl.dtype)
    unexpected += [key for key in loaded if key not in template]
    return merged, missing, unexpected


def _listed(keys: List[str]) -> str:
    return ", ".join(keys[:8]) + (" ..." if len(keys) > 8 else "")


def load_weights(model: torch.nn.Module, path: str, strict: bool = True) -> Dict[str, List[str]]:
    """Load the `.pth` file at `path` into `model`: strictly (evaluation), or
    as an overlay (training). Returns {"missing": [...], "unexpected": [...]},
    empty after a strict load."""
    state = read_state_dict(path)
    if strict:
        model.load_state_dict(state, strict=True)
        return {"missing": [], "unexpected": []}
    merged, missing, unexpected = overlay_state_dict(model.state_dict(), state)
    model.load_state_dict(merged, strict=True)
    if missing:
        logger.info("MODEL.WEIGHTS: %d keys keep their init (new submodules): %s", len(missing),
                    _listed(missing))
    if unexpected:
        logger.warning("MODEL.WEIGHTS: %d checkpoint-only keys ignored: %s", len(unexpected),
                       _listed(unexpected))
    return {"missing": missing, "unexpected": unexpected}


class Checkpointer:
    """Training checkpoints in OUTPUT_DIR (detectron2's layout)."""

    def __init__(self, output_dir: str):
        self.dir = os.path.abspath(output_dir)
        os.makedirs(self.dir, exist_ok=True)

    def save(self, model: torch.nn.Module, train_step, iteration: int,
             name: Optional[str] = None) -> str:
        """Write `name`.pth (default model_{iteration:07d}) and point the
        marker at it. `train_step` (an `engine/train.py:TrainStep`, or None
        for weights only) adds the optimizer and the trainer state. Every
        rank calls it (the trainer state gathers each rank's generator);
        only rank 0 writes, and every rank returns once the file is there."""
        name = (name or f"model_{iteration:07d}") + ".pth"
        path = os.path.join(self.dir, name)
        trainer = train_step.state_dict() if train_step is not None else None
        if is_main_process():
            blob = {"model": model.state_dict(), "iteration": int(iteration)}
            if trainer is not None:
                blob["optimizer"] = trainer.pop("optimizer")
                blob["trainer"] = trainer
            torch.save(blob, path + ".tmp")
            os.replace(path + ".tmp", path)
            with open(os.path.join(self.dir, MARKER), "w") as f:
                f.write(name)
        barrier()
        return path

    def latest(self) -> Optional[str]:
        """The file the marker names, if both exist."""
        marker = os.path.join(self.dir, MARKER)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            path = os.path.join(self.dir, f.read().strip())
        return path if os.path.exists(path) else None

    def restore(self, model: torch.nn.Module, train_step) -> Optional[int]:
        """Load the latest checkpoint strictly into `model` and `train_step`.
        Returns its iteration, or None without one."""
        path = self.latest()
        if path is None:
            return None
        blob = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(blob["model"], strict=True)
        train_step.load_state_dict({"optimizer": blob["optimizer"], **blob["trainer"]})
        return int(blob["iteration"])
