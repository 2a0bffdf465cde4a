"""Seeded cost families of the matcher, in numpy alone: the CPU tests hold
the plain version (`hungarian_plain`) to the JAX package's solver on them,
and the card tests (`tests/test_torch_gpu.py`) hold kernel H1 to the plain
version on the same costs."""
import numpy as np

FAMILIES = ("normal", "integers", "layout", "nonfinite")
SHAPES = ((96, 50), (4, 127))  # (problems, queries): the train step's, and near the cap
LAYOUT_GT = {50: 20, 127: 50}  # GT slots of the "layout" family, fewer than the queries


def cost_family(name, p, n, seed=0):
    """(cost [p, n, ng] f32, num_gt [p] int64, padded [p, n, n]): the costs
    `losses/criterion.py:match_planes_multi` hands the solver, and the same
    costs with the GT side zero-padded to n, as the JAX solver takes them.
      normal     N(0, 1) * 5: one optimum;
      integers   0-3: many assignments tie, and argmin's tie rule decides;
      layout     NG < NQ GT slots, num_gt in {0, 1, 12, NG};
      nonfinite  normal * 5 with NaN entries, an +inf column, a -inf row and
                 an all-NaN problem."""
    rng = np.random.default_rng(seed)
    num_gt = rng.integers(0, n + 1, p).astype(np.int64)
    num_gt[:2] = (n, 0)
    if name == "normal":
        cost = rng.normal(size=(p, n, n)).astype(np.float32) * 5
    elif name == "integers":
        cost = rng.integers(0, 4, (p, n, n)).astype(np.float32)
    elif name == "layout":
        ng = LAYOUT_GT[n]
        cost = rng.normal(size=(p, n, ng)).astype(np.float32) * 5
        num_gt = np.resize(np.array([0, 1, 12, ng], np.int64), p)
    elif name == "nonfinite":
        cost = rng.normal(size=(p, n, n)).astype(np.float32) * 5
        cost[rng.random((p, n, n)) < 0.02] = np.nan
        cost[0, :, 2] = np.inf
        cost[1 % p, 3, :] = -np.inf
        cost[-1] = np.nan
        num_gt[-1] = n // 2
    else:
        raise ValueError(f"no cost family {name!r}")
    padded = np.zeros((p, n, n), np.float32)
    padded[:, :, :cost.shape[2]] = cost
    return cost, num_gt, padded
