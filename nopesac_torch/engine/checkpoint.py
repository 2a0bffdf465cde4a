"""Checkpoints of the port: the one weight loader of both entry points, and
the training checkpoints that `--resume` reads (counterpart of the JAX
package's `engine/checkpoint.py` and of `Trainer._load_weights`).

Weights (`load_weights`) come from a file that `torch.load` reads, named
`.pth` or `.pkl` as the JAX trainer accepts them: a state_dict, or
detectron2's `{"model": state_dict, ...}`. The reference's v1 key layout is
migrated first (`migrate_legacy_keys`). The tensors that are not model
weights are dropped: `NON_PARAMETER_SUFFIXES` (the reference criterion's
`empty_weight`, BatchNorm's `num_batches_tracked`) silently, and the v1
pixel-decoder keys the migration moves under `sem_seg_head.pixel_decoder.`
(neither model has that module) listed in the report's "dropped", as the
JAX package's importer leaves both unconsumed. Evaluation loads the rest
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
`{"model": state_dict, "optimizer": the optimizer's state_dict (AdamW's
moments, or SGD's momentum buffers), "iteration": N,
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
WEIGHT_SUFFIXES = (".pth", ".pkl")
LEGACY_PIXEL_DECODER = "sem_seg_head.pixel_decoder."
# the sem_seg_head children of the current layout (planeTR_head.py:26-48)
_HEAD_CHILDREN = ("input_proj", "context_SA", "query_embed", "context2plane_decoder", "top_down",
                  "plane_embedding", "pixel_embedding", "plane_prob", "plane_param",
                  "plane_center", "pixel_plane_center", "depth", "position_embedding",
                  "pixel_decoder")
MARKER = "last_checkpoint"


def migrate_legacy_keys(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's key migration of v1 checkpoints (planeTR_head.py:26-48):
    a v1 file stored the pixel decoder's weights directly under
    `sem_seg_head.`; they move under `sem_seg_head.pixel_decoder.`."""
    out = {}
    for k, v in state.items():
        if (k.startswith("sem_seg_head.") and ".predictor" not in k
                and ".pixel_decoder." not in k
                and not k.startswith(tuple(f"sem_seg_head.{c}" for c in _HEAD_CHILDREN))):
            k = k.replace("sem_seg_head.", LEGACY_PIXEL_DECODER)
        out[k] = v
    return out


def read_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The model tensors of a `.pth` or `.pkl` checkpoint on the CPU, with
    the v1 keys migrated and the non-parameter keys left out, and the v1
    pixel-decoder keys that were left out."""
    if not path.endswith(WEIGHT_SUFFIXES):
        raise NotImplementedError(
            f"MODEL.WEIGHTS must name a torch .pth or .pkl checkpoint, got {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.WEIGHTS not found: {path}")
    state = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in state:
        state = state["model"]
    state = migrate_legacy_keys(state)
    dropped = sorted(k for k in state if k.startswith(LEGACY_PIXEL_DECODER))
    kept = {k: torch.as_tensor(v) for k, v in state.items()
            if not k.endswith(NON_PARAMETER_SUFFIXES) and not k.startswith(LEGACY_PIXEL_DECODER)}
    return kept, dropped


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
    """Load the checkpoint at `path` into `model`: strictly (evaluation), or
    as an overlay (training). Returns {"missing": [...], "unexpected": [...],
    "dropped": [...]}, the first two empty after a strict load."""
    state, dropped = read_state_dict(path)
    if dropped:
        logger.warning("MODEL.WEIGHTS: %d v1 pixel-decoder keys dropped (no such module): %s",
                       len(dropped), _listed(dropped))
    if strict:
        model.load_state_dict(state, strict=True)
        return {"missing": [], "unexpected": [], "dropped": dropped}
    merged, missing, unexpected = overlay_state_dict(model.state_dict(), state)
    model.load_state_dict(merged, strict=True)
    if missing:
        logger.info("MODEL.WEIGHTS: %d keys keep their init (new submodules): %s", len(missing),
                    _listed(missing))
    if unexpected:
        logger.warning("MODEL.WEIGHTS: %d checkpoint-only keys ignored: %s", len(unexpected),
                       _listed(unexpected))
    return {"missing": missing, "unexpected": unexpected, "dropped": dropped}


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
