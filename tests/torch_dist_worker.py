"""Rank bodies of the two-rank CPU tests (`tests/test_torch_dist_train.py`,
`tests/test_torch_dist_eval.py`), launched by `nopesac_torch.parallel.dist.launch`
over gloo. A spawned rank imports this module by name, so it imports
neither JAX nor the JAX package. Each body reads its inputs from one
`torch.save` file that the test wrote and returns what the test checks.
"""
import hashlib
import os

import torch

from torch_cpu import THREADS

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.packing import batch_to_device, unpack_targets
from nopesac_torch.engine.precise_bn import recompute_batch_stats
from nopesac_torch.engine.train import TrainStep, build_train_model
from nopesac_torch.losses.criterion import match_planes_multi
from nopesac_torch.models.layers import BatchNorm2d
from nopesac_torch.parallel.dist import rank, world_size
from nopesac_torch.parallel.host_gather import all_gather_objects

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke_synthetic.yaml")


def smoke_cfg(opts):
    cfg = get_cfg()
    cfg.merge_from_file(SMOKE)
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def rank_part(tree, r, world):
    """The r-th of `world` equal parts of every array of a batch along axis 0."""
    if isinstance(tree, dict):
        return {k: rank_part(v, r, world) for k, v in tree.items()}
    n = len(tree) // world
    return tree[r * n:(r + 1) * n]


def bn_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))
            and isinstance(model.get_submodule(k.rsplit(".", 1)[0]), BatchNorm2d)}


def digest(tensors):
    """sha256 of the tensors' bytes, in order: bit-equality across ranks."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_state(model, step):
    """Parameters, AdamW moments and BN running statistics, flattened."""
    params = [p for g in step.optimizer.param_groups for p in g["params"]]
    state = step.optimizer.state
    return {"params": torch.cat([p.detach().reshape(-1) for p in params]),
            "exp_avg": torch.cat([state[p]["exp_avg"].reshape(-1) for p in params]),
            "exp_avg_sq": torch.cat([state[p]["exp_avg_sq"].reshape(-1) for p in params]),
            "bn": bn_state(model)}


def detect_matches(model, batch):
    """The Hungarian match of every supervision level from a train-mode
    detect (synced BN across ranks); the BN running statistics are put back."""
    saved = bn_state(model)
    t0, t1 = unpack_targets(batch["targets0"]), unpack_targets(batch["targets1"])
    targets = {k: torch.cat([t0[k], t1[k]]) for k in t0}
    with torch.no_grad():
        images = torch.cat([batch["image0"], batch["image1"]]).permute(0, 3, 1, 2).contiguous()
        _, out, _ = model.detect(images)
        matches = match_planes_multi([out] + out["aux_outputs"], targets,
                                     model.train_settings.match_cost_weights())
    model.load_state_dict(saved, strict=False)
    return [m.numpy() for m in matches]


def train_rank(spec_path):
    """Tests (a)-(d) of test_torch_dist_train.py on this rank's part of the
    global batch: (a) the match, global losses, summed gradients and new BN
    statistics of one train_forward; (b) two TrainStep steps with REMAT on;
    (c) the skip guard with a NaN on the last rank only; (d) precise-BN with
    one batch more on the last rank than on the others."""
    torch.set_num_threads(THREADS)
    spec = torch.load(spec_path, weights_only=False)
    r, world = rank(), world_size()
    part = batch_to_device(rank_part(spec["batch"], r, world), "cpu")
    aim = [a[r * (len(a) // world):(r + 1) * (len(a) // world)] for a in spec["aim"]]
    out = {"rank": r, "world": world}

    # (a) one forward and backward against JAX
    cfg = smoke_cfg(spec["opts"])
    model = build_train_model(cfg, device="cpu")
    model.load_state_dict(spec["sd"], strict=True)
    out["matches"] = detect_matches(model, part)
    losses, _ = TrainStep(model, cfg).forward_backward(part, *aim)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["grads_digest"] = digest([grads[k] for k in sorted(grads)])
    if r == 0:
        out["grads"] = grads
    out["bn"] = bn_state(model)
    del model, grads

    # (b) two steps of TrainStep with REMAT on
    cfg_b = smoke_cfg(list(spec["opts"]) + ["MODEL.REMAT", "True", "SOLVER.BASE_LR", "1e-6"])
    model = build_train_model(cfg_b, device="cpu")
    model.load_state_dict(spec["sd"], strict=True)
    step = TrainStep(model, cfg_b, seed=0)
    out["step_metrics"] = [{k: float(v) for k, v in step(part, *aim).items()} for _ in range(2)]
    state = train_state(model, step)
    out["state_digest"] = digest([state["params"], state["exp_avg"], state["exp_avg_sq"]]
                                 + [state["bn"][k] for k in sorted(state["bn"])])
    if r == 0:
        out["state"] = state

    # (c) a non-finite loss on the last rank only skips the step on every
    # rank: a NaN GT pose reaches that rank's losses, not the forward's
    # synced BN statistics
    before = train_state(model, step)
    bad = dict(part)
    if r == world - 1:
        bad["gt_pose"] = part["gt_pose"].clone()
        bad["gt_pose"][0, 0] = float("nan")
    skipped = step(bad, *aim)
    after = train_state(model, step)
    out["skip"] = {"skipped": float(skipped["skipped_nonfinite"]), "updates": step.updates,
                   "steps": step.step,
                   "unchanged": all(torch.equal(before[k], after[k])
                                    for k in ("params", "exp_avg", "exp_avg_sq"))
                   and all(torch.equal(before["bn"][k], after["bn"][k]) for k in before["bn"]),
                   "digest": digest([after["params"], after["exp_avg"], after["exp_avg_sq"]])}
    del model, step

    # (d) precise-BN over this rank's batches; the last rank has one more
    model = build_train_model(cfg, device="cpu")
    model.load_state_dict(spec["sd"], strict=True)
    mine = [rank_part(b, r, world) for b in spec["bn_batches"]]
    if r == world - 1:
        mine.append(mine[-1])
    out["precise_bn_n"] = recompute_batch_stats(model, iter(mine), num_iter=len(mine) + 2)
    out["precise_bn"] = bn_state(model)
    return out


def eval_rank(spec_path):
    """Test (a) and (b) of test_torch_dist_eval.py on this rank: one
    `all_gather_objects`, the evaluator fed this rank's slice of fake
    predictions, `EvalRunner.test` over the pairs, and the first pair ids of
    a `Trainer`'s loader shard."""
    from nopesac_torch.engine.predict import build_model_from_cfg
    from nopesac_torch.engine.test import EvalRunner
    from nopesac_torch.engine.trainer import Trainer
    from nopesac_torch.evaluation import evaluator as evaluator_mod

    torch.set_num_threads(THREADS)
    spec = torch.load(spec_path, weights_only=False)
    r, world = rank(), world_size()
    out = {"rank": r, "gathered": all_gather_objects({"rank": r, "items": list(range(r + 1))})}

    calls = []
    main_fn = evaluator_mod.MP3DEvaluator._evaluate_main

    def counted(self, predictions):
        calls.append(len(predictions))
        return main_fn(self, predictions)

    evaluator_mod.MP3DEvaluator._evaluate_main = counted
    try:
        pairs, outputs = spec["pairs"], spec["outputs"]
        cfg = smoke_cfg(spec["opts"] + ["OUTPUT_DIR", spec["fake_dir"]])
        ev = evaluator_mod.MP3DEvaluator("synthetic_test", cfg, distributed=True,
                                         dataset_list=pairs)
        mine = list(range(r, len(pairs), world))
        ev.process([pairs[i] for i in mine], [outputs[i] for i in mine])
        out["fake_results"] = ev.evaluate()

        cfg = smoke_cfg(spec["opts"] + ["OUTPUT_DIR", spec["runner_dir"]])
        model = build_model_from_cfg(cfg, device="cpu", seed=spec["seed"])
        runner = EvalRunner(cfg, model)
        out["runner_results"] = runner.test(pairs)
        out["runner_stats"] = runner.last_eval_stats
    finally:
        evaluator_mod.MP3DEvaluator._evaluate_main = main_fn
    out["evaluate_main_calls"] = calls

    cfg = smoke_cfg(spec["opts"] + ["OUTPUT_DIR", spec["trainer_dir"],
                                    "SOLVER.IMS_PER_BATCH", str(2 * world)])
    trainer = Trainer(cfg, dataset_list=spec["train_pairs"], device="cpu")
    try:
        it = iter(trainer.loader)
        out["shard_ids"] = [m["image_id0"] for _ in range(2) for m in next(it)["meta"]]
        it.close()
    finally:
        trainer.close()
    return out
