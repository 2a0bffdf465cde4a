"""Data-parallel training of the port on two gloo ranks on the CPU, against
the JAX package's one global step and against the port's one process.

One JAX init of `train_forward` (smoke_synthetic.yaml at 96x128, 10
Sinkhorn iterations, dropout 0, the queries pulled apart and the BN
statistics perturbed as in tests/test_torch_train.py) is carried into the
port with `state_dict_from_jax`. The global batch is 4 synthetic pairs:
rank 0's two have one plane per view and dark images, rank 1's six planes
and bright ones, so that per-rank loss normalisers and per-rank BN
statistics would both give other numbers than the global batch's. One
module-scoped launch of `tests/torch_dist_worker.py:train_rank` runs every
two-rank part, with a `file://` rendezvous under tmp_path:
  (a) one jitted JAX value-and-grad on the 4 pairs against the two ranks'
      train_forward on 2 + 2 (the JAX step's AIM poses split per rank): the
      match of every level, every global loss, the summed gradients per
      module and the new BN statistics, at tests/test_torch_train.py's
      tolerances; the per-rank result that a plain DDP wrap would give
      (each rank's own losses averaged, each rank's own BN statistics)
      misses JAX by more than 10x those tolerances;
  (b) two TrainStep steps with REMAT on against the port's one process on
      the 4 pairs;
  (c) a non-finite loss on rank 1 only skips the step on both ranks;
  (d) precise-BN on two ranks against one process over the union of the
      batches, rank 1 holding one batch more.
A second launch (`depth_rank`) holds a MODEL.DEPTH_ON step to a second
jitted JAX value-and-grad, as (a): every loss, loss_depth_pixel among them,
whose per-view counts of depth pixels are the global batch's (rank 0's
pairs have one plane per view, so their views hold far fewer depth pixels
than rank 1's), the gradients and the new BN statistics, the depth
branch's included; each rank's own depth loss, averaged, misses JAX. The
step's all-reduces are counted: 94 without the depth branch (the gradient
buffer, 26 + 26 synced-BN moments forward and backward, the normalisers
and batch means, the logged losses), 17 more with it (its 8 BN layers
forward and backward, and the depth loss's per-view counts).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.mapper import collate as jax_collate
from nopesac_tpu.data.packing import unpack_targets as jax_unpack_targets
from nopesac_tpu.data.synthetic import make_pair as jax_make_pair
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.losses import camera_losses as JCL
from nopesac_tpu.losses import criterion as JCR

from nopesac_torch.data.packing import batch_to_device
from nopesac_torch.engine.precise_bn import recompute_batch_stats
from nopesac_torch.engine.train import TrainStep, build_train_model
from nopesac_torch.parallel.dist import launch
from nopesac_torch.utils.weights import state_dict_from_jax
from test_torch_train import (BN_TOL, GRAD_REL, LOSS_ABS, LOSS_REL, MATCH_GAP, MODULES,
                              _cfgs, _perturb_stats, _second_best_gap, _separate_queries)
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)
from torch_dist_worker import bn_state, depth_rank, rank_part, smoke_cfg, train_state, train_rank

H, W = 96, 128
WORLD = 2
PLANES = (1, 1, 6, 6)        # per view, pairs in rank order: rank 0's, then rank 1's
BRIGHTNESS = (0.0, 0.0, 1.5, 1.5)  # added to the normalised images
# The pairs' seed. With random weights at 96x128 a pair's refinement can
# sit at a kink: at seed 0 one pair's predicted-plane branch sent the camera
# head a gradient that moved by 17% between the port's 1- and 2-rank runs,
# whose BN moments sum in another order (2.2e-3 of the module's gradient).
# At this seed the assignment is unique (MATCH_GAP) and the port's 1- and
# 2-rank gradients agree within 5e-5 per module, so the comparison with JAX
# sees the ranks and not the fixture's conditioning
SEED = 200
# (b), port against port: the runs differ only in the order of f32 sums (BN
# moments, normalisers, the gradient all-reduce), which moved the first
# step's gradients by up to 5e-5 relative per module on this fixture and the
# second step's by 3e-4. The steps use BASE_LR 1e-6, as
# tests/test_torch_trainer.py does (AdamW's first updates are ~lr *
# sign(g)), so the parameters agree to PARAM_REL; the AdamW moments carry
# the gradients' difference, exp_avg linearly and exp_avg_sq twice over, and
# are held to the gradients' tolerance
PARAM_REL = 1e-6
MOMENT_REL = {"exp_avg": GRAD_REL, "exp_avg_sq": 2 * GRAD_REL}
OPTS = ["INPUT.IMAGE_SIZE", f"({H}, {W})", "MODEL.SEM_SEG_HEAD.DROPOUT", "0.0",
        "MODEL.MATCHING_HEAD.SINKHORN_ITERS", "10", "SOLVER.IMS_PER_BATCH", str(len(PLANES))]


def _numpy_batch(seed):
    mapper = JaxPairMapper(is_train=True, image_size=(H, W))
    pairs = [jax_make_pair(np.random.default_rng(seed + i), n_planes=n, h=H, w=W)
             for i, n in enumerate(PLANES)]
    batch = jax_collate([mapper(p) for p in pairs])
    batch.pop("meta")
    for key in ("image0", "image1"):
        batch[key] = batch[key] + np.asarray(BRIGHTNESS, np.float32)[:, None, None, None]
    return batch


def _condition(params):
    """Two more separations of the random model, as `_separate_queries`
    pulls its queries apart, so that f32 rounding stays well below the
    tolerances: (1) the separated queries' mask logits reach |z| ~ 50,
    where the focal terms saturate and their gradient amplifies the
    rounding of the batch's sums (a permutation of the pairs moved the
    port's own backbone gradient by 1e-3 relative, GRAD_REL); the mask
    embedding's last layer x0.5 halves them; (2) the correlation softmax of
    random features is nearly uniform, so the pose stacks see nearly the
    same input for every pair and their BN over the batch's 4 values at
    1x1 amplifies rounding by |mean| / spread (3e-4 in the camera head);
    convs_backbone's last BN scale x10 sharpens it (5e-5)."""
    last = params["plane_head"]["plane_embedding"]["Dense_2"]
    for k in ("kernel", "bias"):
        last[k] = (np.asarray(last[k]) * 0.5).astype(np.float32)
    bn = params["camera_head"]["convs_backbone"]["conv5"]["BatchNorm_0"]
    bn["scale"] = (np.asarray(bn["scale"]) * 10.0).astype(np.float32)
    return params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_global_step(depth_on=False):
    """One jitted JAX value-and-grad of train_forward on the global batch
    of SEED, from the conditioned init: (losses, grads, new BN statistics,
    match costs, matches), the numpy batch, the AIM poses as torch tensors
    and the init's variables."""
    jcfg, _ = _cfgs()
    jcfg.SOLVER.IMS_PER_BATCH = len(PLANES)
    jcfg.MODEL.DEPTH_ON = depth_on
    jmodel = jax_build_model(jcfg)
    np_batch = _numpy_batch(SEED)
    jbatch = jax.tree_util.tree_map(jnp.asarray, np_batch)
    aim_key = jax.random.PRNGKey(7)
    cost_w = {"cost_class": 1.0, "cost_mask": jmodel.mask_weight, "cost_dice": jmodel.dice_weight,
              "cost_center": jmodel.center_ins_weight, "cost_param": jmodel.param_hm_weight_l1,
              "cost_param_offset": jmodel.param_weight_offset,
              "cost_param_normal_angle": jmodel.param_weight_angle}

    def detect_costs(m, batch):
        t0, t1 = jax_unpack_targets(batch["targets0"]), jax_unpack_targets(batch["targets1"])
        targets = jax.tree_util.tree_map(lambda a, c: jnp.concatenate([a, c]), t0, t1)
        _, out, _ = m.detect(jnp.concatenate([batch["image0"], batch["image1"]]), train=True)
        levels = [out] + list(out["aux_outputs"])
        return ([JCR.compute_match_cost(o, targets, cost_w) for o in levels],
                JCR.match_planes_multi(levels, targets, cost_w))

    def step(variables, batch):
        def loss_fn(params):
            losses, state = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                         batch, aim_key, method=jmodel.train_forward,
                                         mutable=["batch_stats"])
            return sum(losses.values()), (losses, state["batch_stats"])

        (_, (losses, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        (costs, matches), _ = jmodel.apply(variables, batch, method=detect_costs,
                                           mutable=["batch_stats"])
        return losses, grads, new_bs, costs, matches

    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, aim_key,
                                              method=jmodel.train_forward))(jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)
    variables = {"params": _condition(_separate_queries(variables["params"], rng)),
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(step)(variables, jbatch))
    n_aim = len(PLANES) * max(jmodel.rand_bs // len(PLANES), 1)
    r1, r2 = jax.random.split(aim_key)
    aim = [torch.from_numpy(np.asarray(JCL.rand_aim_rot(r1, n_aim)).copy()),
           torch.from_numpy(np.asarray(JCL.rand_aim_trans(r2, n_aim)).copy())]
    return ref, np_batch, aim, variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_train")
    ref, np_batch, aim, variables = jax_global_step()
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W))
    ref_grads = state_dict_from_jax(ref[1], None, image_size=(H, W))
    ref_bn = state_dict_from_jax(variables["params"], ref[2], image_size=(H, W))
    del variables

    bn_batches = [_numpy_batch(10), _numpy_batch(20)]
    spec = {"sd": sd, "batch": np_batch, "aim": aim, "opts": OPTS, "bn_batches": bn_batches}
    spec_path = str(root / "spec.pt")
    torch.save(spec, spec_path)
    ranks = launch(train_rank, WORLD, device="cpu", dist_url=f"file://{root}/rendezvous",
                   args=(spec_path,), timeout_s=600)
    shutil.rmtree(root)  # the spec holds the weights, ~0.3 GB

    # the port's one process on the same inputs
    cfg = smoke_cfg(OPTS)
    batch = batch_to_device(np_batch, "cpu")
    naive_losses, naive_bn = [], []
    for r in range(WORLD):  # what each rank computes alone (a plain DDP wrap)
        model = build_train_model(cfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            losses = model.train_forward(rank_part(batch, r, WORLD), None,
                                         *[rank_part(a, r, WORLD) for a in aim])
        naive_losses.append({k: float(v) for k, v in losses.items()})
        naive_bn.append(bn_state(model))
    cfg_b = smoke_cfg(OPTS + ["MODEL.REMAT", "True", "SOLVER.BASE_LR", "1e-6"])
    model = build_train_model(cfg_b, device="cpu")
    model.load_state_dict(sd, strict=True)
    one_step = TrainStep(model, cfg_b, seed=0)
    one_metrics = [{k: float(v) for k, v in one_step(batch, *aim).items()} for _ in range(2)]
    one_state = train_state(model, one_step)
    model = build_train_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    one_bn_n = recompute_batch_stats(model, iter(bn_batches), num_iter=len(bn_batches) + 2)
    one_bn = bn_state(model)
    yield dict(ref=ref, ref_grads=ref_grads, ref_bn=ref_bn, ranks=ranks, np_batch=np_batch,
               naive_losses=naive_losses, naive_bn=naive_bn, one_metrics=one_metrics,
               one_state=one_state, one_bn_n=one_bn_n, one_bn=one_bn, sd=sd)


def _loss_tol(r):
    return max(LOSS_ABS, LOSS_REL * abs(r))


def test_fixture_match_is_unique_and_ranks_differ(runs):
    costs = runs["ref"][3]
    b2 = costs[0].shape[0]
    n_gt = np.concatenate([runs["np_batch"][f"targets{v}"]["gt_valid"].sum(1) for v in (0, 1)])
    gaps = [_second_best_gap(c[i], int(n_gt[i])) for c in costs for i in range(b2)]
    assert min(gaps) >= MATCH_GAP, gaps
    # the batch shows the defect: unequal plane counts, unequal brightness
    assert n_gt[0] == 1 and n_gt[2] == 6
    assert [r["rank"] for r in runs["ranks"]] == [0, 1] and runs["ranks"][0]["world"] == WORLD
    # the step's collectives (PERF.md §3)
    assert [r["all_reduces"] for r in runs["ranks"]] == [94] * WORLD


def test_two_rank_match_equals_jax(runs):
    ref = runs["ref"][4]
    b = len(PLANES) // WORLD
    for level, r in enumerate(ref):
        views = []
        for v in range(2):  # [view 0 of every pair; view 1 of every pair]
            for rk in runs["ranks"]:
                views.append(rk["matches"][level][v * b:(v + 1) * b])
        np.testing.assert_array_equal(np.concatenate(views), r, err_msg=f"level {level}")


def test_two_rank_losses_equal_jax_and_per_rank_losses_do_not(runs):
    ref = {k: float(v) for k, v in runs["ref"][0].items()}
    ranks = runs["ranks"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    got = ranks[0]["losses"]
    assert sorted(got) == sorted(ref)
    bad = {k: (got[k], r) for k, r in ref.items() if not abs(got[k] - r) <= _loss_tol(r)}
    assert not bad, bad
    naive = {k: np.mean([n[k] for n in runs["naive_losses"]]) for k in ref}
    worst = max(abs(naive[k] - r) / _loss_tol(r) for k, r in ref.items())
    assert worst > 10, worst


def test_two_rank_gradients_equal_jax(runs):
    ranks = runs["ranks"]
    assert ranks[0]["grads_digest"] == ranks[1]["grads_digest"]
    grads, ref_grads = ranks[0]["grads"], runs["ref_grads"]
    for module in MODULES:
        names = [n for n in grads if n.startswith(module)]
        assert names, module
        rel = _rel(np.concatenate([grads[n].numpy().ravel() for n in names]),
                   np.concatenate([ref_grads[n].numpy().ravel() for n in names]))
        assert rel <= GRAD_REL, (module, rel)


def test_two_rank_bn_statistics_equal_jax_and_per_rank_ones_do_not(runs):
    ranks, want = runs["ranks"], runs["ref_bn"]
    assert len(ranks[0]["bn"]) == 2 * (8 + 18)
    worst_naive = 0.0
    for key, got in ranks[0]["bn"].items():
        assert torch.equal(got, ranks[1]["bn"][key]), key
        assert not torch.equal(got, runs["sd"][key]), key
        torch.testing.assert_close(got, want[key], rtol=BN_TOL, atol=BN_TOL)
        naive = (runs["naive_bn"][0][key] + runs["naive_bn"][1][key]) / 2
        worst_naive = max(worst_naive, float(((naive - want[key]).abs()
                                              / (BN_TOL + BN_TOL * want[key].abs())).max()))
    assert worst_naive > 10, worst_naive


def test_two_rank_train_steps_equal_one_process(runs):
    ranks = runs["ranks"]
    assert ranks[0]["state_digest"] == ranks[1]["state_digest"]
    for got, ref in zip(ranks[0]["step_metrics"], runs["one_metrics"]):
        assert got["skipped_nonfinite"] == ref["skipped_nonfinite"] == 0.0
        bad = {k: (got[k], r) for k, r in ref.items() if not abs(got[k] - r) <= _loss_tol(r)}
        assert not bad, bad
    state, ref = ranks[0]["state"], runs["one_state"]
    assert _rel(state["params"].numpy(), ref["params"].numpy()) <= PARAM_REL
    for key, tol in MOMENT_REL.items():
        assert _rel(state[key].numpy(), ref[key].numpy()) <= tol, key
    for key, v in ref["bn"].items():
        torch.testing.assert_close(state["bn"][key], v, rtol=BN_TOL, atol=BN_TOL)


def test_non_finite_loss_on_one_rank_skips_on_both(runs):
    skips = [r["skip"] for r in runs["ranks"]]
    for s in skips:
        assert s["skipped"] == 1.0 and s["updates"] == 2 and s["steps"] == 3
        assert s["unchanged"]
    assert skips[0]["digest"] == skips[1]["digest"]


def test_two_rank_precise_bn_equals_one_process_over_the_union(runs):
    ranks = runs["ranks"]
    assert runs["one_bn_n"] == ranks[0]["precise_bn_n"] == ranks[1]["precise_bn_n"] == 2
    for key, want in runs["one_bn"].items():
        assert torch.equal(ranks[0]["precise_bn"][key], ranks[1]["precise_bn"][key]), key
        assert not torch.equal(want, runs["sd"][key]), key
        torch.testing.assert_close(ranks[0]["precise_bn"][key], want, rtol=BN_TOL, atol=BN_TOL)


DEPTH_OPTS = OPTS + ["MODEL.DEPTH_ON", "True"]


@pytest.fixture(scope="module")
def depth_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_depth")
    ref, np_batch, aim, variables = jax_global_step(depth_on=True)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], image_size=(H, W))
    ref_grads = state_dict_from_jax(ref[1], None, image_size=(H, W))
    ref_bn = state_dict_from_jax(variables["params"], ref[2], image_size=(H, W))
    spec_path = str(root / "spec.pt")
    torch.save({"sd": sd, "batch": np_batch, "aim": aim, "opts": DEPTH_OPTS}, spec_path)
    ranks = launch(depth_rank, WORLD, device="cpu", dist_url=f"file://{root}/rendezvous",
                   args=(spec_path,), timeout_s=600)
    shutil.rmtree(root)
    cfg = smoke_cfg(DEPTH_OPTS)
    batch = batch_to_device(np_batch, "cpu")
    naive = []
    for r in range(WORLD):  # each rank's own depth loss (a plain DDP wrap)
        model = build_train_model(cfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            losses = model.train_forward(rank_part(batch, r, WORLD), None,
                                         *[rank_part(a, r, WORLD) for a in aim])
        naive.append(float(losses["loss_depth_pixel"]))
    yield dict(ref=ref, ref_grads=ref_grads, ref_bn=ref_bn, ranks=ranks, naive=naive, sd=sd)


def test_two_rank_depth_step_equals_jax(depth_runs):
    ref = {k: float(v) for k, v in depth_runs["ref"][0].items()}
    ranks = depth_runs["ranks"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["grads_digest"] == ranks[1]["grads_digest"]
    assert [r["all_reduces"] for r in ranks] == [94 + 17] * WORLD
    got = ranks[0]["losses"]
    assert "loss_depth_pixel" in ref and sorted(got) == sorted(ref)
    bad = {k: (got[k], r) for k, r in ref.items() if not abs(got[k] - r) <= _loss_tol(r)}
    assert not bad, bad
    r = ref["loss_depth_pixel"]
    assert abs(np.mean(depth_runs["naive"]) - r) > 10 * _loss_tol(r), (depth_runs["naive"], r)
    grads, ref_grads = ranks[0]["grads"], depth_runs["ref_grads"]
    assert any(n.startswith("sem_seg_head.top_down_depth.") for n in grads)
    for module in MODULES:
        names = [n for n in grads if n.startswith(module)]
        rel = _rel(np.concatenate([grads[n].numpy().ravel() for n in names]),
                   np.concatenate([ref_grads[n].numpy().ravel() for n in names]))
        assert rel <= GRAD_REL, (module, rel)
    want = depth_runs["ref_bn"]
    assert any(k.startswith("sem_seg_head.top_down_depth.") for k in ranks[0]["bn"])
    for key, got_bn in ranks[0]["bn"].items():
        assert torch.equal(got_bn, ranks[1]["bn"][key]), key
        torch.testing.assert_close(got_bn, want[key], rtol=BN_TOL, atol=BN_TOL)
