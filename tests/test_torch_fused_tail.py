"""MODEL.RESNETS.FUSE_TAIL on the port's normal path, on the CPU at 96x128
with seeded random weights: the key builds the fused backbone through
`build_model_from_cfg` and through the `--eval-only` entry point; the bf16
fused eval step against the benchmark's plain reference
(`cardbench/reference`) with its plain fused tail; the key off against the
same reference unfused; and `model.fused_tail_calls`, eagerly and through
the graph cache's capture and replays (a stand-in capture, as in
`test_torch_eval_graphs.py`; the card's graphs are in `test_torch_gpu.py`).

Tolerance against the reference: none, the outputs are bit-equal. On the
CPU both sides run the same plain arithmetic in the same order: the tail as
one f32 product of the bf16 values rounded once (`conv1x1_bn_act_plain` and
its copy), and a bf16 convolution as the f32 convolution of bf16 values
(`models/layers.py:conv2d` and its copy). Any difference is a change of
arithmetic, not rounding noise."""
import json
import os

import numpy as np
import pytest
import torch

from cardbench.harness import fused_tail
from cardbench.harness.weights import load_params, param_specs, seeded_params
from cardbench.reference.build import Cfg, build_model, eval_step as reference_step
from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step
from nopesac_torch.models import resnet
from nopesac_torch.utils import graphs, trace
from nopesac_torch.utils.device import LAUNCHES
from test_torch_eval_graphs import StandIn
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
IDENTITY_BLOCKS = 12  # ResNet-50: all but the first block of each stage
CALLS = "model.fused_tail_calls"


def _cfg(dtype="bfloat16", fuse=True):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "inference_mp3d.yaml"))
    cfg.merge_from_list(["INPUT.IMAGE_SIZE", f"({H}, {W})", "MODEL.MATCHING_HEAD.SINKHORN_ITERS",
                         "10", "MODEL.COMPUTE_DTYPE", dtype, "MODEL.RESNETS.FUSE_TAIL", str(fuse)])
    return cfg


def _models(cfg, seed):
    """The port's model of `cfg` and the reference's (its tails fused as the
    key says) on the same seeded parameters and FrozenBN statistics away
    from the identity, so that B4's epilogue does work."""
    port = build_model_from_cfg(cfg, device="cpu")
    ref = build_model(Cfg(cfg.to_dict()))
    if cfg.MODEL.RESNETS.FUSE_TAIL:
        fused_tail.fuse(ref)
    params = seeded_params(param_specs(ref), seed, torch.device("cpu"))
    load_params(port, params)
    load_params(ref, params)
    gen = torch.Generator().manual_seed(seed)
    for name, buf in port.backbone.named_buffers():
        if buf.dim() == 1:
            new = (torch.rand(buf.shape, generator=gen) + 0.5
                   if name.endswith(("weight", "running_var"))
                   else torch.randn(buf.shape, generator=gen) * 0.1)
            buf.copy_(new)
            ref.backbone.get_buffer(name).copy_(new)
    return port, ref


def _images(seed, b=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8))
            for _ in range(2)]


def _leaves(tree, out=None, prefix=""):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, out, f"{prefix}/{k}")
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    return out


def _assert_bit_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.fixture
def tail_calls(monkeypatch):
    """Counts the calls that reach B4's wrapper from the backbone."""
    calls = []
    tail = resnet.conv1x1_bn_act

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return tail(*args, **kwargs)

    monkeypatch.setattr(resnet, "conv1x1_bn_act", counted)
    return calls


@pytest.fixture
def counts():
    trace.reset()
    trace.enable()
    yield lambda: trace.snapshot()["counts"]
    trace.disable()
    trace.reset()


@pytest.mark.parametrize("fuse", [False, True])
def test_the_key_builds_the_fused_backbone(fuse):
    assert get_cfg().MODEL.RESNETS.FUSE_TAIL is False
    model = build_model_from_cfg(_cfg(fuse=fuse), device="cpu")
    blocks = [m for m in model.backbone.modules() if isinstance(m, resnet.Bottleneck)]
    identity = [m for m in blocks if m.shortcut is None]
    assert len(blocks) == 16 and len(identity) == IDENTITY_BLOCKS
    assert all(m.fuse_tail == fuse for m in blocks)


@pytest.mark.parametrize("fuse", [False, True])
def test_eval_only_entry_point_reads_the_key(fuse, tail_calls, counts, capsys, tmp_path):
    """`engine/test.py`'s main with --eval-only on the smoke config's test
    split (4 pairs, batches of 4): 24 tail calls per batch with the key, none
    without."""
    from nopesac_torch.engine.test import main as eval_main

    smoke = os.path.join(REPO, "configs", "smoke_synthetic.yaml")
    assert eval_main(["--config-file", smoke, "--eval-only", "--device", "cpu", "--seed", "2",
                      "MODEL.COMPUTE_DTYPE", "bfloat16", "MODEL.RESNETS.FUSE_TAIL", str(fuse),
                      "OUTPUT_DIR", str(tmp_path)]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["eval_stats"]["pairs"] == 4 and all(np.isfinite(v) for v in row["results"].values())
    assert len(tail_calls) == (2 * IDENTITY_BLOCKS if fuse else 0)
    assert counts().get(CALLS, 0) == len(tail_calls)
    if fuse:
        assert {s[0] for s in tail_calls} == {8}  # one backbone call, both views of 4 pairs


@pytest.mark.parametrize("seed", [5, 2**31 + 1])
def test_bf16_fused_eval_step_is_the_plain_reference(seed):
    cfg = _cfg()
    port, ref = _models(cfg, seed)
    im = _images(seed)
    step = make_eval_step(port, H, W, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    _assert_bit_equal(step(*im), reference_step(ref, im[0], im[1], Cfg(cfg.to_dict())))


def test_key_off_f32_eval_step_is_unchanged(tail_calls):
    """Off, the f32 step is the unfused one: bit-equal to the reference's
    frozen copy of the model, and the tail's wrapper is never called."""
    cfg = _cfg("float32", fuse=False)
    port, ref = _models(cfg, 7)
    im = _images(7)
    step = make_eval_step(port, H, W, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    _assert_bit_equal(step(*im), reference_step(ref, im[0], im[1], Cfg(cfg.to_dict())))
    assert tail_calls == []


def test_the_counter_reads_24_calls_per_batch(counts):
    """Eagerly (the CPU's plain path), then through the graph cache: the
    eager call, the capture (with its own replay) and a replay each count
    24, though the capture's and the replays' Python runs once; the replays
    give the eager step's outputs. The plain path launches no kernel."""
    cfg = _cfg()
    port, _ = _models(cfg, 3)
    step = make_eval_step(port, H, W, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
    batches = [_images(s) for s in (1, 2)]
    LAUNCHES.reset()
    want = [step(*b) for b in batches]
    assert counts()[CALLS] == 2 * 2 * IDENTITY_BLOCKS
    assert LAUNCHES["bottleneck_tail"] == 0
    capture = StandIn()
    graphs.attach(port, graphs.GraphCache(capture=capture, device_type="cpu"))
    trace.reset()
    for k, b in enumerate(batches + batches):
        got = step(*b)  # from the third call on, the capture's buffers
        if k >= 2:
            _assert_bit_equal(got, want[k - 2])
    assert capture.captured > 0
    assert counts()[CALLS] == 4 * 2 * IDENTITY_BLOCKS
    assert counts()["eval.graph_replays"] > 0
