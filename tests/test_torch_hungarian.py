"""The port's matcher against the JAX package's on-device one, on the CPU:
`hungarian_plain` (kernel H1's plain version) equal to `hungarian_device`
on seeded cost families (`nopesac_torch/losses/hungarian_cases.py`), ties and non-finite
costs included; its total cost scipy's optimum; `match_planes_multi` equal to
the JAX package's on the same level outputs; the kernel wrapper's refusals,
reached before any library is loaded.

One JAX solve per shape serves every case of that shape: all families are
stacked into one batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from nopesac_tpu.losses import criterion as JCR
from nopesac_tpu.losses.hungarian import hungarian_device

from nopesac_torch.losses import criterion as CR
from nopesac_torch.losses.hungarian import (hungarian, hungarian_plain, lap_jv_rect,
                                            pad_and_sanitize)
from nopesac_torch.losses.hungarian_cases import FAMILIES, SHAPES, cost_family
from nopesac_torch.ops import _build
from nopesac_torch.ops.hungarian import hungarian_cuda
from nopesac_torch.utils.device import LAUNCHES
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

OPT_RTOL = 1e-5  # total cost against scipy's f64 optimum: f32 duals and sums
CASES = [(p, n, f) for p, n in SHAPES for f in FAMILIES]


@pytest.fixture(scope="module")
def jax_matches():
    """JAX's match of every family, one hungarian_device call per shape."""
    out = {}
    for p, n in SHAPES:
        cases = [cost_family(f, p, n) for f in FAMILIES]
        padded = np.concatenate([c[2] for c in cases])
        num_gt = np.concatenate([c[1] for c in cases]).astype(np.int32)
        match = np.asarray(hungarian_device(jnp.asarray(padded), jnp.asarray(num_gt)))
        for k, f in enumerate(FAMILIES):
            out[p, n, f] = match[k * p:(k + 1) * p]
    return out


@pytest.fixture(scope="module")
def plain_matches():
    return {(p, n, f): hungarian_plain(*(torch.from_numpy(a) for a in cost_family(f, p, n)[:2]))
            for p, n, f in CASES}


@pytest.mark.parametrize("p,n,family", CASES)
def test_plain_equals_jax_solver(jax_matches, plain_matches, p, n, family):
    got = plain_matches[p, n, family]
    assert got.dtype == torch.int64 and tuple(got.shape) == (p, n)
    np.testing.assert_array_equal(got.numpy(), jax_matches[p, n, family])


@pytest.mark.parametrize("p,n,family", CASES)
def test_plain_is_optimal(plain_matches, p, n, family):
    """Each of the first num_gt GT planes assigned to exactly one query, and
    the total cost scipy's optimum of the sanitised [NQ, num_gt] block."""
    cost, num_gt, _ = cost_family(family, p, n)
    match = plain_matches[p, n, family].numpy()
    sane = pad_and_sanitize(torch.from_numpy(cost)).double().numpy()
    for b in range(p):
        k = int(num_gt[b])
        assigned = match[b][match[b] >= 0]
        assert sorted(assigned.tolist()) == list(range(k))
        if k == 0:
            continue
        rows, cols = linear_sum_assignment(sane[b, :, :k])
        best = sane[b, rows, cols].sum()
        q = np.nonzero(match[b] >= 0)[0]
        total = sane[b, q, match[b, q]].sum()
        assert abs(total - best) <= OPT_RTOL * max(abs(best), 1.0), (b, total, best)


def test_plain_clamps_num_gt_and_takes_empty_batches():
    cost, num_gt, padded = cost_family("layout", 4, 50, seed=3)
    ng = cost.shape[2]
    over = num_gt.copy()
    over[3] = ng + 7
    under = num_gt.copy()
    under[0] = -2
    want = hungarian_plain(torch.from_numpy(cost), torch.from_numpy(np.clip(over, 0, ng)))
    assert torch.equal(hungarian_plain(torch.from_numpy(cost), torch.from_numpy(over)), want)
    assert torch.equal(hungarian_plain(torch.from_numpy(cost), torch.from_numpy(under)),
                       hungarian_plain(torch.from_numpy(cost),
                                       torch.from_numpy(np.clip(under, 0, ng))))
    for shape in ((0, 50, 50), (3, 0, 0)):
        got = hungarian_plain(torch.zeros(shape), torch.zeros(shape[0], dtype=torch.int64))
        assert got.dtype == torch.int64 and tuple(got.shape) == shape[:2]


def test_lap_jv_rect_counts_dijkstra_steps():
    """The optional tally the bound counts: one step per row where each row's
    cheapest column is its own and free; more where rows contend for one
    column; the solution is the same with and without the tally."""
    own = torch.full((2, 5, 5), 9.0)
    own[:, range(5), range(5)] = 1.0
    contend = own.clone()
    contend[1, :, 0] = 0.0  # every row's cheapest column is 0
    steps = torch.zeros(2, dtype=torch.int64)
    num_rows = torch.tensor([5, 5])
    col4row = lap_jv_rect(contend, num_rows, steps)
    assert torch.equal(col4row, lap_jv_rect(contend, num_rows))
    assert steps[0] == 5 and steps[1] > 5
    assert torch.equal(col4row[0], torch.arange(5))


def test_hungarian_on_cpu_is_the_plain_version():
    cost, num_gt, _ = cost_family("integers", 8, 50, seed=4)
    LAUNCHES.reset()
    got = hungarian(torch.from_numpy(cost).double(), torch.from_numpy(num_gt))
    assert torch.equal(got, hungarian_plain(torch.from_numpy(cost), torch.from_numpy(num_gt)))
    assert LAUNCHES["hungarian"] == 0


COST_W = {"cost_class": 1.0, "cost_mask": 20.0, "cost_dice": 1.0, "cost_center": 0.5,
          "cost_param": 0.25, "cost_param_offset": 0.01, "cost_param_normal_angle": 0.0028}


def _levels(seed, levels=3, b=4, nq=50, ng=20, h=12, w=16):
    """Seeded outputs of `levels` supervision levels and targets with ng < nq
    GT slots (match_planes_multi pads them with zero columns), num_gt
    0, 1, 12 and ng."""
    rng = np.random.default_rng(seed)
    outs = [{"pred_logits": rng.normal(size=(b, nq, 2)).astype(np.float32),
             "pred_mask_logits": rng.normal(0, 2, (b, nq, h, w)).astype(np.float32),
             "pred_params": rng.normal(size=(b, nq, 3)).astype(np.float32),
             "pred_centers": rng.uniform(size=(b, nq, 2)).astype(np.float32)}
            for _ in range(levels)]
    valid = np.zeros((b, ng), bool)
    masks = np.zeros((b, ng, 4 * h, 4 * w), np.uint8)
    for i, n in enumerate((0, 1, 12, ng)[:b]):
        valid[i, :n] = True
        lab = rng.integers(0, n + 1, size=(h, w)).repeat(4, 0).repeat(4, 1)
        for g in range(n):
            masks[i, g] = lab == g + 1
    targets = {"gt_valid": valid, "gt_masks": masks,
               "gt_params": rng.normal(size=(b, ng, 3)).astype(np.float32) * valid[..., None],
               "gt_centers": rng.uniform(size=(b, ng, 2)).astype(np.float32) * valid[..., None]}
    return outs, targets


@pytest.mark.parametrize("seed", [0, 1])
def test_match_planes_multi_equals_jax(seed):
    outs, targets = _levels(seed)
    ref = JCR.match_planes_multi([jax.tree_util.tree_map(jnp.asarray, o) for o in outs],
                                 jax.tree_util.tree_map(jnp.asarray, targets), COST_W)
    got = CR.match_planes_multi([{k: torch.from_numpy(v) for k, v in o.items()} for o in outs],
                                {k: torch.from_numpy(v) for k, v in targets.items()}, COST_W)
    assert len(got) == len(ref) == len(outs)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("cost,num_gt,error,match", [
    (torch.zeros(2, 50, 50, dtype=torch.float64), torch.zeros(2, dtype=torch.int64), TypeError,
     "f32 costs"),
    (torch.zeros(1, 129, 129), torch.zeros(1, dtype=torch.int64), ValueError, "at most 128"),
    (torch.zeros(2, 50, 60), torch.zeros(2, dtype=torch.int64), ValueError,
     "as many GT planes as queries"),
    (torch.zeros(2, 50, 50), torch.zeros(2), TypeError, "must be int64"),
    (torch.zeros(2, 50, 50), torch.zeros(2, dtype=torch.int32), TypeError, "int64, got torch.int32"),
    (torch.zeros(2, 50, 50), torch.zeros(3, dtype=torch.int64), ValueError, r"num_gt must be \[2\]"),
    (torch.zeros(2, 50, 50), torch.zeros(2, dtype=torch.int64), ValueError, "CUDA tensors"),
])
def test_kernel_wrapper_refuses(cost, num_gt, error, match):
    """Dtypes and shapes are checked from the metadata before the device, so
    each refusal is reached on the CPU without building or loading the
    kernel's library."""
    with pytest.raises(error, match=match):
        hungarian_cuda(cost, num_gt)
    assert "hungarian" not in _build._LIBS
