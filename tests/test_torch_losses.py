"""The port's training losses, matcher and data against the JAX package, on
the same seeded numpy inputs: kernel B3's plain version (against the f32
reference and the Pallas kernel in interpret mode), the matching cost, the
Q-loss, the detection losses, the Hungarian matcher, the matching and camera
losses, the synthetic generator with the mapper, collate and the device
unpack. Each comparison states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.mapper import collate as jax_collate
from nopesac_tpu.data.packing import unpack_targets as jax_unpack_targets
from nopesac_tpu.data.synthetic import make_pair as jax_make_pair
from nopesac_tpu.losses import camera_losses as JCL
from nopesac_tpu.losses import criterion as JCR
from nopesac_tpu.losses import matching as JM
from nopesac_tpu.losses.hungarian import hungarian_device, hungarian_host
from nopesac_tpu.ops.mask_loss_pallas import focal_dice_reference, fused_focal_dice

from nopesac_torch.data.mapper import PairMapper, collate
from nopesac_torch.data.packing import batch_to_device, unpack_targets
from nopesac_torch.data.synthetic import make_pair
from nopesac_torch.losses import camera_losses as CL
from nopesac_torch.losses import criterion as CR
from nopesac_torch.losses import matching as M
from nopesac_torch.losses.hungarian import hungarian
from nopesac_torch.models.matching_head import MatchingHead
from nopesac_torch.ops import mask_loss
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

B3_REF_TOL = 1e-5     # plain version vs focal_dice_reference (both f32)
B3_PALLAS_FWD = 2e-2  # vs the Pallas kernel, which rounds to bf16 (tests/test_pallas_ops.py)
B3_PALLAS_GRAD = 3e-2
LOSS_TOL = 1e-5
NQ = 50


def t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# kernel B3, plain version
# --------------------------------------------------------------------------

def _mask_inputs(seed, b=2, nq=5, ng=4, h=12, w=16):
    """The shapes and masks of tests/test_pallas_ops.py::TestFusedMaskLoss."""
    rng = np.random.default_rng(seed)
    gh, gw = 4 * h, 4 * w
    src = rng.normal(size=(b, nq, h, w)).astype(np.float32)
    masks = np.zeros((b, ng, gh, gw), np.uint8)
    for g in range(ng):
        masks[:, g, g * 10:(g + 1) * 10, : gw // 2] = 1
    tgt = rng.integers(-1, ng, size=(b, nq)).astype(np.int32)
    matched = tgt >= 0
    return src, masks, np.maximum(tgt, 0), matched


WEIGHTS = (0.7, -0.3, 0.11)


def _port_b3(src, masks, tgt, matched):
    s = t(src).requires_grad_(True)
    sums = mask_loss.fused_focal_dice(s, t(masks), t(tgt).long(),
                                      None if matched is None else t(matched))
    sum(wk * v.sum() for wk, v in zip(WEIGHTS, sums)).backward()
    return [v.detach().numpy() for v in sums], s.grad.numpy()


def _jax_b3(fn, src, masks, tgt, matched):
    keep = np.ones(tgt.shape, np.float32) if matched is None else matched.astype(np.float32)

    def loss(s):
        sums = fn(s)
        return sum(wk * jnp.sum(v * keep) for wk, v in zip(WEIGHTS, sums)), sums

    (_, sums), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(src))
    return [np.asarray(v) * keep for v in sums], np.asarray(grad)


@pytest.mark.parametrize("with_matched", [False, True])
def test_b3_plain_matches_f32_reference(with_matched):
    src, masks, tgt, matched = _mask_inputs(0)
    matched = matched if with_matched else None
    got, g_got = _port_b3(src, masks, tgt, matched)
    ref, g_ref = _jax_b3(lambda s: focal_dice_reference(s, jnp.asarray(masks), jnp.asarray(tgt)),
                         src, masks, tgt, matched)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=B3_REF_TOL, atol=B3_REF_TOL * np.abs(r).max())
    assert np.abs(g_got - g_ref).max() <= B3_REF_TOL * np.abs(g_ref).max()
    if with_matched:
        assert all((g[~matched] == 0).all() for g in got) and (g_got[~matched] == 0).all()


@pytest.mark.parametrize("with_matched", [False, True])
def test_b3_plain_matches_pallas_interpret(with_matched):
    src, masks, tgt, matched = _mask_inputs(1)
    jm = jnp.asarray(matched) if with_matched else None
    got, g_got = _port_b3(src, masks, tgt, matched if with_matched else None)
    ref, g_ref = _jax_b3(
        lambda s: fused_focal_dice(s, jnp.asarray(masks), jnp.asarray(tgt), True, jm),
        src, masks, tgt, matched if with_matched else None)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=B3_PALLAS_FWD, atol=B3_PALLAS_FWD)
    scale = np.abs(g_ref).max() + 1e-6
    np.testing.assert_allclose(g_got / scale, g_ref / scale, rtol=B3_PALLAS_GRAD,
                               atol=B3_PALLAS_GRAD)


def test_b3_plain_rejects_other_ratios():
    src, masks, tgt, matched = _mask_inputs(2)
    with pytest.raises(ValueError, match="4x"):
        mask_loss.fused_focal_dice(t(src)[..., :8], t(masks), t(tgt).long(), t(matched))


@pytest.mark.parametrize("h", [1, 2, 3, 30])
@pytest.mark.parametrize("w", [1, 2, 3, 30])
def test_b3_upsample4_adjoint_matches_autograd(h, w):
    """The constant 8-tap adjoint table with its edge fix-ups (the backward
    kernel's) is the transpose of upsample4; f64, so only rounding differs."""
    rng = np.random.default_rng(h * 100 + w)
    x = torch.from_numpy(rng.normal(size=(2, h, w))).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(2, 4 * h, 4 * w)))
    (mask_loss.upsample4(x) * g).sum().backward()
    got = mask_loss.upsample4_adjoint(g)
    assert got.shape == x.shape
    assert float((got - x.grad).abs().max()) <= 1e-12


# --------------------------------------------------------------------------
# criterion
# --------------------------------------------------------------------------

def _detection_inputs(seed, b2=4, h=12, w=16, n_gt=(5, 3, 6, 1)):
    """Head outputs of one level (NCHW pixel centers for the port, NHWC for
    JAX), disjoint targets and a random match."""
    rng = np.random.default_rng(seed)
    gh, gw = 4 * h, 4 * w
    out = {"pred_logits": rng.normal(size=(b2, NQ, 2)).astype(np.float32),
           "pred_mask_logits": rng.normal(0, 2, (b2, NQ, h, w)).astype(np.float32),
           "pred_params": rng.normal(size=(b2, NQ, 3)).astype(np.float32),
           "pred_centers": rng.uniform(size=(b2, NQ, 2)).astype(np.float32),
           "pixel_centers": rng.uniform(size=(b2, 2, h, w)).astype(np.float32)}
    masks = np.zeros((b2, NQ, gh, gw), np.uint8)
    valid = np.zeros((b2, NQ), bool)
    match = np.full((b2, NQ), -1, np.int32)
    for i, n in enumerate(n_gt):
        lab = rng.integers(0, n + 1, size=(gh // 4, gw // 4)).repeat(4, 0).repeat(4, 1)
        for g in range(n):
            masks[i, g] = lab == g + 1
        valid[i, :n] = True
        match[i, rng.permutation(NQ)[:n]] = rng.permutation(n)
    depth = rng.uniform(1, 5, (b2, gh, gw)).astype(np.float32)
    kxy = rng.normal(size=(b2, 3, gh, gw)).astype(np.float32)
    params = rng.normal(size=(b2, NQ, 3)).astype(np.float32) * valid[..., None]
    # GT planes that the depth map lies on over part of each mask, so the
    # Q-loss valid region is not empty
    for i in range(b2):
        for g in range(int(valid[i].sum())):
            m = masks[i, g] > 0
            n = params[i, g] / max(np.linalg.norm(params[i, g]), 1e-6)
            d = np.linalg.norm(params[i, g])
            ray_dot = np.einsum("c,chw->hw", n, kxy[i])
            on_plane = np.abs(ray_dot) > 0.2
            depth[i][m & on_plane] = (d / ray_dot)[m & on_plane]
    targets = {"gt_valid": valid, "gt_masks": masks, "gt_params": params,
               "gt_centers": rng.uniform(size=(b2, NQ, 2)).astype(np.float32) * valid[..., None],
               "gt_pixel_centers": rng.uniform(size=(b2, gh, gw, 2)).astype(np.float32),
               "depth": depth, "k_inv_dot_xy1": kxy}
    return out, targets, match


def _jax_out(out):
    j = {k: jnp.asarray(v) for k, v in out.items()}
    j["pixel_centers"] = jnp.asarray(out["pixel_centers"].transpose(0, 2, 3, 1))
    return j


COST_W = {"cost_class": 1.0, "cost_mask": 20.0, "cost_dice": 1.0, "cost_center": 0.5,
          "cost_param": 0.25, "cost_param_offset": 0.01, "cost_param_normal_angle": 0.0028}


def test_compute_match_cost():
    out, targets, _ = _detection_inputs(0)
    ref = np.asarray(JCR.compute_match_cost(_jax_out(out), jax.tree_util.tree_map(
        jnp.asarray, targets), COST_W))
    got = CR.compute_match_cost({k: t(v) for k, v in out.items()},
                                {k: t(v) for k, v in targets.items()}, COST_W).numpy()
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_q_loss_segmap():
    out, targets, match = _detection_inputs(1)
    ref = float(JCR._q_loss_segmap(jnp.asarray(out["pred_params"]), jnp.asarray(match),
                                   jax.tree_util.tree_map(jnp.asarray, targets)))
    got = float(CR.q_loss_segmap(t(out["pred_params"]), t(match).long(),
                                 {k: t(v) for k, v in targets.items()}))
    assert ref > 0
    assert abs(got - ref) <= LOSS_TOL * abs(ref)


@pytest.mark.parametrize("aux", [False, True])
def test_detection_losses_siamese(aux):
    out, targets, match = _detection_inputs(2)
    jout = _jax_out(out)
    if aux:
        jout.pop("pixel_centers")
    ref = JCR.detection_losses_siamese(jout, jax.tree_util.tree_map(jnp.asarray, targets),
                                       jnp.asarray(match), eos_coef=0.1, aux=aux)
    got = CR.detection_losses_siamese({k: t(v) for k, v in out.items()},
                                      {k: t(v) for k, v in targets.items()}, t(match).long(),
                                      eos_coef=0.1, aux=aux)
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        r = float(r)
        assert abs(float(got[key]) - r) <= LOSS_TOL * abs(r), (key, float(got[key]), r)


# --------------------------------------------------------------------------
# Hungarian matcher
# --------------------------------------------------------------------------

def _costs(seed, b=6, n=NQ):
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(b, n, n)).astype(np.float32) * 5
    ngt = np.array([0, 1, 3, 7, 20, n][:b], np.int32)
    return cost, ngt


def test_hungarian_equals_jax_solvers():
    cost, ngt = _costs(0)
    got = hungarian(t(cost), t(ngt)).numpy()
    # the device solver never assigns the columns past num_gt, whatever they hold
    np.testing.assert_array_equal(
        got, np.asarray(hungarian_device(jnp.asarray(cost), jnp.asarray(ngt))))
    # the host oracle solves the whole square, which is the same problem when
    # the padding columns are constant (zero, as match_planes_multi pads)
    padded = cost * (np.arange(NQ)[None, None, :] < ngt[:, None, None])
    np.testing.assert_array_equal(
        hungarian(t(padded), t(ngt)).numpy(),
        np.asarray(hungarian_host(jnp.asarray(padded), jnp.asarray(ngt))))
    for i, n in enumerate(ngt):
        assigned = got[i][got[i] >= 0]
        assert sorted(assigned.tolist()) == list(range(n))


def test_hungarian_terminates_on_nonfinite_costs():
    cost, ngt = _costs(1)
    cost[1, 3, 0] = np.nan
    cost[3, :, 2] = np.inf
    cost[4, 7, :] = -np.inf
    cost[5] = np.nan
    got = hungarian(t(cost), t(ngt)).numpy()
    ref = np.asarray(hungarian_device(jnp.asarray(cost), jnp.asarray(ngt)))
    np.testing.assert_array_equal(got, ref)
    for i, n in enumerate(ngt):
        assert sorted(got[i][got[i] >= 0].tolist()) == list(range(n))


# --------------------------------------------------------------------------
# matching and camera losses
# --------------------------------------------------------------------------

def test_matching_losses():
    rng = np.random.default_rng(3)
    b = 3
    m1 = np.full((b, NQ), -1, np.int32)
    m2 = np.full((b, NQ), -1, np.int32)
    for i in range(b):
        m1[i, rng.permutation(NQ)[:6]] = rng.permutation(6)
        m2[i, rng.permutation(NQ)[:5]] = rng.permutation(5)
    c1 = np.zeros((b, NQ), np.int32)
    c2 = np.zeros((b, NQ), np.int32)
    cv = np.zeros((b, NQ), bool)
    for i in range(b):
        n = 6 - i
        c1[i, :n], c2[i, :n], cv[i, :n] = rng.permutation(6)[:n], rng.permutation(6)[:n], True
    ref = np.asarray(JM.build_pred_corr_matrix(*(jnp.asarray(a) for a in (m1, m2, c1, c2, cv)),
                                               NQ))
    got = M.build_pred_corr_matrix(t(m1), t(m2), t(c1), t(c2), t(cv), NQ).numpy()
    np.testing.assert_array_equal(got, ref)
    rows, cols = m1 >= 0, m2 >= 0
    ref_i = np.asarray(JM.intersect_with_valid(jnp.asarray(ref), jnp.asarray(rows),
                                               jnp.asarray(cols)))
    got_i = M.intersect_with_valid(t(got), t(rows), t(cols)).numpy()
    np.testing.assert_array_equal(got_i, ref_i)
    scores = rng.normal(-2, 1, (b, NQ + 1, NQ + 1)).astype(np.float32)
    ref_l = float(JM.matching_nll_loss(jnp.asarray(scores), jnp.asarray(ref_i)))
    got_l = float(M.matching_nll_loss(t(scores), t(got_i)))
    assert abs(got_l - ref_l) <= LOSS_TOL * abs(ref_l)


def test_matching_head_training_sends_gradient_to_the_gnn():
    torch.manual_seed(0)
    head = MatchingHead(sinkhorn_iterations=5, gnn_pairs=2)
    rng = np.random.default_rng(4)
    qf0, qf1 = (t(rng.normal(size=(2, NQ, 256)).astype(np.float32)) for _ in range(2))
    p0, p1 = (t(rng.normal(size=(2, NQ, 3)).astype(np.float32)) for _ in range(2))
    cam = t(np.tile(np.array([0.1, 0.2, 0.3, 1.0, 0.0, 0.0, 0.0], np.float32), (2, 1)))
    rows = t(rng.random((2, NQ)) < 0.3)
    cols = t(rng.random((2, NQ)) < 0.3)
    scores = head(qf0, qf1, cam, p0.requires_grad_(True), p1, row_masks=rows, col_masks=cols,
                  training=True)
    assert scores.grad_fn is not None
    scores[:, :-1, :-1].clamp_max(0).sum().backward()
    assert float(head.gnn.layers[0].q_proj.weight.grad.abs().sum()) > 0
    assert float(head.planeApp_proj.weight.grad.abs().sum()) > 0
    assert float(head.bin_score.grad.abs()) > 0
    assert p0.grad is None or not p0.grad.any()  # the geometric prior is detached


def _refine_dict(seed, b=2, m=NQ):
    rng = np.random.default_rng(seed)
    hyp = np.concatenate([np.ones((b, 1), bool), rng.random((b, m)) < 0.2], axis=1)
    rots = rng.normal(size=(b, m + 1, 4)).astype(np.float32)
    return {
        "tran_avg_excl": rng.normal(size=(b, 3)).astype(np.float32),
        "rot_avg_excl": rng.normal(size=(b, 4)).astype(np.float32),
        "tran_soft": rng.normal(size=(b, 3)).astype(np.float32),
        "rot_soft": rng.normal(size=(b, 4)).astype(np.float32),
        "hyp_valid": hyp, "rots_all": rots,
        "trans_all": rng.normal(size=(b, m + 1, 3)).astype(np.float32),
        "score_rot": rng.uniform(size=(b, m + 1)).astype(np.float32),
        "score_trans": rng.uniform(size=(b, m + 1)).astype(np.float32),
        "l2_dist": rng.uniform(size=(b, m + 1, m)).astype(np.float32),
    }, hyp[:, 1:], hyp[:, 1:].sum(1).astype(np.int32)


def test_camera_losses():
    rng = np.random.default_rng(5)
    gt = np.concatenate([rng.normal(size=(2, 3)), rng.normal(size=(2, 4))], 1).astype(np.float32)
    tr, rot = rng.normal(size=(2, 3)).astype(np.float32), rng.normal(size=(2, 4)).astype(np.float32)
    for r, g in zip(JCL.camera_pose_loss(jnp.asarray(tr), jnp.asarray(rot), jnp.asarray(gt)),
                    CL.camera_pose_loss(t(tr), t(rot), t(gt))):
        assert abs(float(g) - float(r)) <= LOSS_TOL * abs(float(r))
    assert abs(float(CL.rot_rec_loss(t(rot), t(rot[::-1].copy())))
               - float(JCL.rot_rec_loss(jnp.asarray(rot), jnp.asarray(rot[::-1])))) <= 1e-6
    ref_dict, valid, num = _refine_dict(6)
    ref = JCL.refine_losses({k: jnp.asarray(v) for k, v in ref_dict.items()}, jnp.asarray(gt),
                            jnp.asarray(valid), jnp.asarray(num), "x", 0.5)
    got = CL.refine_losses({k: t(v) for k, v in ref_dict.items()}, t(gt), t(valid), t(num),
                           "x", 0.5)
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        assert abs(float(got[key]) - float(r)) <= LOSS_TOL * abs(float(r)), key


def test_aim_random_poses_from_the_same_draws():
    key = jax.random.PRNGKey(3)
    r1, r2 = jax.random.split(key)
    u_rot = np.asarray(jax.random.uniform(r1, (64, 3)))
    u_tr = np.asarray(jax.random.uniform(r2, (64, 3)))
    np.testing.assert_allclose(CL.rot_from_uniform(t(u_rot)).numpy(),
                               np.asarray(JCL.rand_aim_rot(r1, 64)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(CL.trans_from_uniform(t(u_tr)).numpy(),
                               np.asarray(JCL.rand_aim_trans(r2, 64)), atol=1e-6, rtol=0)
    gen = torch.Generator().manual_seed(0)
    q = CL.rand_aim_rot(gen, 16)
    assert q.shape == (16, 4) and (q[:, 0] >= 0).all()
    assert torch.allclose(q.norm(dim=1), torch.ones(16))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,n_planes", [(96, 128, 6), (48, 64, 12)])
def test_mapper_and_collate_equal_jax(h, w, n_planes):
    jpairs = [jax_make_pair(np.random.default_rng(7), n_planes=n_planes, h=h, w=w, pair_id=i)
              for i in range(2)]
    pairs = [make_pair(np.random.default_rng(7), n_planes=n_planes, h=h, w=w, pair_id=i)
             for i in range(2)]
    ref = jax_collate([JaxPairMapper(is_train=True, image_size=(h, w))(p) for p in jpairs])
    got = collate([PairMapper(image_size=(h, w))(p) for p in pairs])
    for m_ref, m_got in zip(ref.pop("meta"), got.pop("meta")):
        for key in ("image_id0", "image_id1", "rel_pose", "gt_corrs"):
            assert m_got[key] == m_ref[key], key
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        if isinstance(r, dict):
            assert sorted(got[key]) == sorted(r), key
            for k, v in r.items():
                assert got[key][k].dtype == v.dtype, (key, k)
                np.testing.assert_array_equal(got[key][k], v, err_msg=f"{key}.{k}")
        else:
            assert got[key].dtype == r.dtype, key
            np.testing.assert_array_equal(got[key], r, err_msg=key)
    # the device unpack of the wire format
    dev = batch_to_device(got, "cpu")
    for view in ("targets0", "targets1"):
        want = jax.tree_util.tree_map(np.asarray, jax_unpack_targets(
            jax.tree_util.tree_map(jnp.asarray, ref[view])))
        have = unpack_targets(dev[view])
        assert sorted(have) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(have[k].numpy(), v, rtol=1e-6, atol=1e-6, err_msg=k)
