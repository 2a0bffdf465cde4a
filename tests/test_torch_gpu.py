"""On the card: each CUDA kernel against its plain PyTorch version. The eval
step through the kernels is held against its CPU run by `chip_smoke.py`.

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package, so they run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from nopesac_torch.core.sinkhorn import masked_ot_prologue
from nopesac_torch.ops import select, sinkhorn
from nopesac_torch.utils.device import LAUNCHES

pytestmark = pytest.mark.gpu

OT_KERNEL_TOL = 1e-4  # other reduction order and expf/logf ulps, compounded over 200 iterations


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _select_inputs(dev, seed, b, nq, h, w):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 4, (b, nq, h, w)).astype(np.float32)
    prob = torch.sigmoid(torch.from_numpy(logits)).to(dev).to(torch.bfloat16)
    score = torch.from_numpy(rng.uniform(0.5, 1.0, (b, nq)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((b, nq)) > 0.5).to(dev)
    valid[0] = False  # a view with no valid query: every label is 0
    return prob, score, valid


@pytest.mark.parametrize("seed,b,nq,h,w", [(0, 8, 50, 120, 160), (1, 3, 50, 120, 160),
                                           (2, 2, 12, 24, 32)])
def test_select_kernel_bit_equal_to_plain(cuda, seed, b, nq, h, w):
    prob, score, valid = _select_inputs(cuda, seed, b, nq, h, w)
    before = LAUNCHES["select_maps"]
    got = select.fused_select_maps(prob, score, valid, 0.5, 4 * h, 4 * w)
    assert LAUNCHES["select_maps"] == before + 1
    ref = select.select_maps_plain(prob.float(), score, valid, 0.5, 4 * h, 4 * w)
    assert torch.equal(got[0], ref[0]), int((got[0] != ref[0]).sum())
    assert torch.equal(got[1], ref[1]), int((got[1] != ref[1]).sum())
    assert (got[0][0] == 0).all()
    assert torch.equal(got[2][:, [0, 3, 6]], ref[2][:, [0, 3, 6]])
    torch.testing.assert_close(got[2][:, [1, 2, 4, 5]], ref[2][:, [1, 2, 4, 5]], rtol=1e-5, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_kernel_matches_plain(cuda, masked):
    gen = torch.Generator(device=cuda).manual_seed(0)
    scores = torch.randn((4, 50, 50), generator=gen, device=cuda) * 3
    row = torch.rand((4, 50), generator=gen, device=cuda) > 0.4 if masked else None
    col = torch.rand((4, 50), generator=gen, device=cuda) > 0.4 if masked else None
    before = LAUNCHES["sinkhorn"]
    got = sinkhorn.log_optimal_transport_masked(scores, torch.tensor(1.0, device=cuda), 200,
                                                row, col)
    assert LAUNCHES["sinkhorn"] == before + 1
    z, mu, nu, norm = masked_ot_prologue(scores, torch.tensor(1.0, device=cuda), row, col)
    ref = sinkhorn.sinkhorn_plain(z, mu, nu, norm, 200)
    keep = ref.abs() < 1e4  # leave out the -1e5 masked band
    assert torch.isfinite(got).all()
    assert float((got - ref).abs()[keep].max()) <= OT_KERNEL_TOL


def test_select_kernel_rejects_other_ratios(cuda):
    prob, score, valid = _select_inputs(cuda, 3, 2, 12, 24, 32)
    with pytest.raises(ValueError):
        select.fused_select_maps(prob, score, valid, 0.5, 48, 64)
