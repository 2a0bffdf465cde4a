"""The port's core math and its two kernels' plain versions against the JAX
package: geometry, assignment, the plain masked Sinkhorn, and kernels B1
(select maps) and B2 (Sinkhorn) held against the Pallas kernels run with
interpret=True. The kernels themselves are held against their plain
versions on the card by test_torch_gpu.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nopesac_tpu.core import assignment as jassign
from nopesac_tpu.core import geometry as jgeo
from nopesac_tpu.core.sinkhorn import log_optimal_transport_masked as jax_ot
from nopesac_tpu.ops.select_pallas import fused_select_maps as jax_select
from nopesac_tpu.ops.sinkhorn_pallas import log_optimal_transport_masked_pallas

from nopesac_torch.core import assignment, geometry
from nopesac_torch.core.sinkhorn import log_optimal_transport_masked
from nopesac_torch.ops import _build, select, sinkhorn
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

GEO_TOL = 1e-6  # absolute, and relative for the warps (a few f32 ulps on O(1) values)
OT_TOL = 1e-5       # plain loop vs lax loop, same algorithm and order
OT_KERNEL_TOL = 1e-4  # vs the Pallas kernel: other reduction order, compounded over iterations


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# geometry and assignment
# ---------------------------------------------------------------------------

class TestGeometry:
    def setup_method(self):
        rng = np.random.default_rng(0)
        self.q = rng.normal(size=(4, 6, 4)).astype(np.float32)
        self.planes = rng.normal(size=(4, 7, 3)).astype(np.float32)
        self.planes[:, -1] = 0.0  # zero padding must stay zero
        self.tran = rng.normal(size=(4, 6, 3)).astype(np.float32)

    def test_quaternion_ops(self):
        np.testing.assert_allclose(geometry.quat_to_rotmat(t(self.q)).numpy(),
                                   np.asarray(jgeo.quat_to_rotmat(self.q)), atol=GEO_TOL)
        np.testing.assert_array_equal(geometry.canonicalize_quat_sign(t(self.q)).numpy(),
                                      np.asarray(jgeo.canonicalize_quat_sign(self.q)))

    def test_norms(self):
        v = np.concatenate([self.planes, np.zeros((4, 1, 3), np.float32)], axis=1)
        np.testing.assert_allclose(geometry.safe_norm(t(v)).numpy(),
                                   np.asarray(jgeo.safe_norm(v)), atol=GEO_TOL)
        for eps in (1e-12, 1e-3):
            np.testing.assert_allclose(geometry.normalize(t(v), eps=eps).numpy(),
                                       np.asarray(jgeo.normalize(v, eps=eps)), atol=GEO_TOL)

    def test_warps(self):
        # [B, P, 3] planes through [B, 4] poses
        got = geometry.warp_planes_to_global(t(self.planes), t(self.q[:, 0]), t(self.tran[:, 0]))
        ref = jgeo.warp_planes_to_global(self.planes, self.q[:, 0], self.tran[:, 0])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GEO_TOL, rtol=GEO_TOL)
        assert (got[:, -1] == 0).all()
        # hypothesis broadcast [B, 1, P, 3] x [B, H, 4] -> [B, H, P, 3] (the JAX vmap)
        got = geometry.warp_planes_to_global(t(self.planes)[:, None], t(self.q), t(self.tran))
        ref = jax.vmap(jgeo.warp_planes_to_global, in_axes=(None, 1, 1), out_axes=1)(
            self.planes, self.q, self.tran)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GEO_TOL, rtol=GEO_TOL)
        np.testing.assert_array_equal(geometry.warp_planes_identity(t(self.planes)).numpy(),
                                      np.asarray(jgeo.warp_planes_identity(self.planes)))


@pytest.mark.parametrize("seed", [0, 1])
def test_assignment_exact(seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(3, 11, 9)).astype(np.float32) * 2.0
    s[0, :, :] = np.log(0.01)  # no match passes the threshold
    got = assignment.mutual_max_assignment(t(s), 0.2)
    ref = np.asarray(jassign.mutual_max_assignment(jnp.asarray(s), 0.2))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[1:].sum() > 0
    idx1, idx2, valid, num = assignment.assignment_to_sequence(got, 6)
    for b in range(3):
        r = jassign.assignment_to_sequence(jnp.asarray(ref[b]), 6)
        for g, rr in zip((idx1[b], idx2[b], valid[b], num[b]), r):
            np.testing.assert_array_equal(g.numpy(), np.asarray(rr))


@pytest.mark.parametrize("masked", [False, True])
def test_plain_sinkhorn_matches_lax(masked):
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(2, 50, 50)).astype(np.float32)
    row = rng.random((2, 50)) > 0.4 if masked else None
    col = rng.random((2, 50)) > 0.4 if masked else None
    ref = np.asarray(jax_ot(jnp.asarray(scores), jnp.float32(1.3), 50,
                            None if row is None else jnp.asarray(row),
                            None if col is None else jnp.asarray(col)))
    got = log_optimal_transport_masked(t(scores), torch.tensor(1.3), 50,
                                       None if row is None else t(row),
                                       None if col is None else t(col)).numpy()
    keep = np.abs(ref) < 1e4
    np.testing.assert_allclose(got[keep], ref[keep], atol=OT_TOL, rtol=0)
    if masked:  # invalid rows/cols stay in the finite -1e5 band, never -inf
        assert np.isfinite(got).all() and (~keep).any()


# ---------------------------------------------------------------------------
# kernel B1: select maps
# ---------------------------------------------------------------------------

def _select_inputs(seed, b=2, nq=12, h=24, w=32, all_invalid_view=False):
    rng = np.random.default_rng(seed)
    prob = rng.random((b, nq, h, w)).astype(np.float32)
    score = rng.random((b, nq)).astype(np.float32)
    valid = rng.random((b, nq)) > 0.3
    if all_invalid_view:
        valid[0] = False
    return prob, score, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_select_plain_matches_pallas(seed):
    prob, score, valid = _select_inputs(seed)
    ref = [np.asarray(x) for x in jax_select(jnp.asarray(prob), jnp.asarray(score),
                                             jnp.asarray(valid), 0.5, 96, 128,
                                             use_pallas=True, interpret=True)]
    got = [x.numpy() for x in select.fused_select_maps(t(prob), t(score), t(valid), 0.5, 96, 128)]
    assert (got[0] == ref[0]).mean() > 0.999
    np.testing.assert_allclose(got[1], ref[1], atol=2e-5, rtol=0)
    if (got[0] == ref[0]).all():
        np.testing.assert_array_equal(got[2][:, [0, 3, 6]], ref[2][:, [0, 3, 6]])
        np.testing.assert_allclose(got[2][:, [1, 2, 4, 5]], ref[2][:, [1, 2, 4, 5]], rtol=1e-5)


def test_select_all_invalid_view_labels_zero():
    prob, score, valid = _select_inputs(3, all_invalid_view=True)
    seg, mx, _ = select.fused_select_maps(t(prob), t(score), t(valid), 0.5, 96, 128)
    assert (seg[0] == 0).all() and (mx[0] == -1).all()


def test_select_rejects_non_integer_ratio():
    prob, score, valid = _select_inputs(0, h=20, w=20)
    with pytest.raises(ValueError):
        select.fused_select_maps(t(prob), t(score), t(valid), 0.5, 150, 200)


def test_cuda_wrappers_refuse_cpu_tensors():
    prob, score, valid = _select_inputs(0)
    with pytest.raises(ValueError):
        select.select_maps_cuda(t(prob).to(torch.bfloat16), t(score), t(valid), 0.5, 96, 128)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.sinkhorn_cuda(torch.zeros((1, 3, 3)), torch.tensor(1.0), 2)


# CPU F.interpolate rounds the interior row taps in another order than ATen's
# CUDA kernel and csrc/select.cu where a map is small (h or w < 4 here): up to
# 2 f32 ulps apart there; at 24x32 it takes the same form, and at the edges
# (rows and columns 0, 1: weights (1, 0)) every form gives the same value
PHASE_ULPS = 2


def _wide_bf16(rng, shape):
    """bf16 probabilities of very different magnitudes side by side, so that
    the 2-tap sums round (sums of like magnitudes are exact in f32)."""
    big = rng.uniform(0.5, 1.0, shape)
    tiny = rng.uniform(0.5, 1.0, shape) * 2.0 ** -rng.integers(8, 30, shape)
    x = np.where(rng.random(shape) < 0.5, big, tiny).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("h,w", [(h, w) for h in (1, 2, 3) for w in (1, 2, 3)] + [(24, 32)])
def test_upsample4_phase_plain_matches_interpolate(h, w):
    x = _wide_bf16(np.random.default_rng(h * 10 + w), (16, h, w))
    got = select.upsample4_phase_plain(x)
    ref = torch.nn.functional.interpolate(x[None], size=(4 * h, 4 * w), mode="bilinear",
                                          align_corners=False)[0]
    assert got.dtype == torch.float32 and got.shape == ref.shape
    ulps = ((got - ref).abs().double().numpy() / np.spacing(ref.abs().numpy())).max()
    assert ulps <= PHASE_ULPS, ulps
    assert torch.equal(got[:, :2], ref[:, :2]) and torch.equal(got[:, :, :2], ref[:, :, :2])
    if h * w > 9:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("rows,cols,want", [
    (51, 51, {"variant": "register", "values": 7, "threads": 416}),  # main path
    (2, 2, {"variant": "register", "values": 1, "threads": 32}),
    (64, 3, {"variant": "register", "values": 8, "threads": 512}),
    (5, 64, {"variant": "register", "values": 8, "threads": 512}),
    (101, 38, {"variant": "general", "values": 0, "threads": 512,
               "smem": 4 * (101 * 38 + 101 + 38)}),
    (3, 65, {"variant": "general", "values": 0, "threads": 512, "smem": 4 * (3 * 65 + 3 + 65)}),
])
def test_sinkhorn_config(rows, cols, want):
    assert sinkhorn.sinkhorn_config(rows, cols) == want


@pytest.mark.parametrize("n", [1, 8, 9, 33, 64])
def test_sinkhorn_register_variant_fits_one_block(n):
    """Every shape the register variant takes fits one block of <= 1024
    threads, with a group of GROUP lanes per row and per column."""
    cfg = sinkhorn.sinkhorn_config(n, n)
    assert cfg["variant"] == "register"
    assert cfg["values"] * sinkhorn.GROUP >= n > (cfg["values"] - 1) * sinkhorn.GROUP
    assert sinkhorn.GROUP * n <= cfg["threads"] <= 1024 and cfg["threads"] % 32 == 0


@pytest.mark.parametrize("what,error", [
    ("f64 scores", TypeError), ("2-d scores", TypeError), ("row mask shape", ValueError),
    ("column mask dtype", TypeError), ("two bin scores", ValueError),
    ("negative iterations", ValueError), ("cpu", ValueError),
])
def test_sinkhorn_kernel_argument_checks(what, error):
    scores, alpha = torch.zeros((2, 4, 5)), torch.tensor(1.0)
    rows, cols = torch.ones((2, 4), dtype=torch.bool), torch.ones((2, 5), dtype=torch.bool)
    args = {"f64 scores": (scores.double(), alpha, 5, rows, cols),
            "2-d scores": (scores[0], alpha, 5, None, None),
            "row mask shape": (scores, alpha, 5, rows[:, :3], cols),
            "column mask dtype": (scores, alpha, 5, rows, cols.float()),
            "two bin scores": (scores, torch.ones(2), 5, rows, cols),
            "negative iterations": (scores, alpha, -1, rows, cols),
            "cpu": (scores, alpha, 5, rows, cols)}[what]
    with pytest.raises(error):
        sinkhorn.sinkhorn_cuda(*args)


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("select")
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# kernel B2: Sinkhorn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_plain_matches_pallas(masked):
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(2, 50, 50)).astype(np.float32)
    row = rng.random((2, 50)) > 0.4 if masked else None
    col = rng.random((2, 50)) > 0.4 if masked else None
    ref = np.asarray(log_optimal_transport_masked_pallas(
        jnp.asarray(scores), jnp.float32(1.3), 50,
        None if row is None else jnp.asarray(row),
        None if col is None else jnp.asarray(col), interpret=True))
    got = sinkhorn.log_optimal_transport_masked(
        t(scores), torch.tensor(1.3), 50,
        None if row is None else t(row), None if col is None else t(col)).numpy()
    keep = np.abs(ref) < 1e4
    np.testing.assert_allclose(got[keep], ref[keep], atol=OT_KERNEL_TOL, rtol=0)
