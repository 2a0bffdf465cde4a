"""The eval step's cache of CUDA graphs (`nopesac_torch/utils/graphs.py`).

A CUDA graph needs a card, so the state machine is driven here through a
stand-in capture on the CPU: it runs the segment once at capture and again
at each replay, writing into the outputs of the capture as a graph writes
into its static buffers. `tests/test_torch_gpu.py` replays real graphs on the
card. On the CPU the eval step itself never engages the cache and stays
eager, bit-equal to a direct `model.inference`.
"""
import numpy as np
import pytest
import torch

from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.predict import build_model_from_cfg, make_eval_step, synthetic_pairs
from nopesac_torch.utils import graphs, trace
from nopesac_torch.utils.device import LAUNCHES
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

COUNTERS = ("eval.graph_eager", "eval.graph_captures", "eval.graph_replays")


class StandIn:
    """A capture that runs `fn` and replays it into the captured outputs.
    As on the card, only the capture's run reports to `on_replay`."""

    def __init__(self):
        self.captured, self.replayed, self.pools = 0, 0, []

    def __call__(self, fn, args, pool):
        self.captured += 1
        self.pools.append(pool)
        out = fn(*args)
        static = []
        graphs._flatten(out, static)

        def replay():
            self.replayed += 1
            fresh = []
            with graphs.recording([]):
                graphs._flatten(fn(*args), fresh)
            for s, f in zip(static, fresh):
                if s is not f:
                    s.copy_(f)

        return replay, out


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(2.0))
        self.calls = 0

    def double(self, x, extra=None):
        self.calls += 1
        y = x * self.scale
        return {"y": y if extra is None else y + extra, "parts": [y, y + 1]}


def _stand_in(model):
    capture = StandIn()
    graphs.attach(model, graphs.GraphCache(capture=capture, device_type="cpu"))
    return capture


@pytest.fixture
def counts():
    trace.reset()
    trace.enable()
    yield lambda: {k: trace.snapshot()["counts"].get(k, 0) for k in COUNTERS}
    trace.disable()
    trace.reset()


def _call(model, *args, step_key=None):
    with torch.inference_mode(), graphs.opened(model, *(step_key or args)):
        return graphs.segment("double", model.double, *args)


def test_first_call_is_eager_the_second_captures_and_later_calls_replay(counts):
    model = Tiny().eval()
    capture = _stand_in(model)
    xs = [torch.full((3,), float(v)) for v in (1, 2, 3, 4)]
    outs = [_call(model, x) for x in xs]
    assert capture.captured == 1 and capture.replayed == 3  # the capture's own replay and two
    assert counts() == {"eval.graph_eager": 1, "eval.graph_captures": 1,
                        "eval.graph_replays": 2}
    assert len(graphs.cache_of(model)) == 1
    for out in outs[2:]:  # the capture's buffers, holding the last call's values
        assert out["parts"][0].data_ptr() == outs[1]["parts"][0].data_ptr()
    assert torch.equal(outs[-1]["y"], xs[-1] * 2) and torch.equal(outs[-1]["parts"][1],
                                                                   xs[-1] * 2 + 1)
    assert outs[2] is not outs[3] and outs[2]["parts"] is not outs[3]["parts"]
    assert torch.equal(outs[0]["y"], xs[0] * 2)  # the eager call's own tensors


@pytest.mark.parametrize("change", ["shape", "dtype", "optional input", "constant"])
def test_another_signature_is_its_own_entry(counts, change):
    model = Tiny().eval()
    capture = _stand_in(model)
    x = torch.ones(3)
    first = {"shape": (torch.ones(4),), "dtype": (torch.ones(3, dtype=torch.float64),),
             "optional input": (x, torch.ones(3)), "constant": (x, 0.5)}[change]
    for _ in range(2):
        _call(model, x)
    for _ in range(3):
        out = _call(model, *first)
    assert capture.captured == 2 and len(graphs.cache_of(model)) == 2
    assert counts() == {"eval.graph_eager": 2, "eval.graph_captures": 2,
                        "eval.graph_replays": 1}
    assert torch.equal(out["y"], model.double(*first)["y"])


def test_an_eval_step_signature_is_its_own_entry(counts):
    model = Tiny().eval()
    capture = _stand_in(model)
    x = torch.ones(3)
    for key in ((torch.ones(2),), (torch.ones(2),), (torch.ones(5),), (torch.ones(5),)):
        _call(model, x, step_key=key)
    assert capture.captured == 2 and counts()["eval.graph_eager"] == 2
    assert len(graphs.cache_of(model).pools) == 2


def test_work_reported_at_the_capture_counts_at_every_replay(counts):
    """A kernel's launch counter and a forward hook report through
    `on_replay`: once per call, eager, captured or replayed, though the
    host runs the segment's Python only at the eager call and the capture."""
    model = Tiny().eval()
    capture = _stand_in(model)
    runs = []

    def double(x):
        LAUNCHES.bump("select_maps")
        graphs.on_replay(lambda: runs.append(1))
        return model.double(x)

    LAUNCHES.reset()
    for n in range(1, 5):
        with torch.inference_mode(), graphs.opened(model, torch.ones(3)):
            graphs.segment("double", double, torch.full((3,), float(n)))
        assert len(runs) == n and LAUNCHES["select_maps"] == n
    LAUNCHES.reset()
    assert capture.captured == 1 and capture.replayed == 3
    assert counts() == {"eval.graph_eager": 1, "eval.graph_captures": 1,
                        "eval.graph_replays": 2}


def test_segments_captured_in_one_call_share_a_pool_and_a_later_capture_has_its_own():
    """Graphs of one pool replay in the order of their capture only within
    the call that captured them: one captured in a later call (its signature
    new then) takes a pool of its own, where the graphs ahead of it cannot
    overwrite its outputs."""
    model = Tiny().eval()
    capture = _stand_in(model)
    x = torch.ones(3)

    def step(n_late):
        with torch.inference_mode(), graphs.opened(model, x):
            first = graphs.segment("first", model.double, x)
            late = graphs.segment("late", model.double, torch.ones(n_late))
            return first, late, graphs.segment("last", model.double, first["y"])

    for n_late in (3, 3, 4, 4, 4):
        first, late, last = step(n_late)
    assert torch.equal(last["y"], x * 4) and torch.equal(late["y"], torch.full((4,), 2.0))
    names = [k[1] for k in graphs.cache_of(model).entries]
    assert capture.captured == 4 and names.count("late") == 2
    shared, own = capture.pools[0], capture.pools[3]  # call 2: first, late, last; call 4: late
    assert capture.pools[:3] == [shared] * 3 and own is not shared
    assert len(graphs.cache_of(model).pools) == 1


def test_train_and_a_move_drop_the_cache():
    model = Tiny().eval()
    _stand_in(model)
    for _ in range(2):
        _call(model, torch.ones(3))
    assert len(graphs.cache_of(model)) == 1
    model.eval()  # train(False) keeps it
    assert len(graphs.cache_of(model)) == 1
    cfg = get_cfg()
    cfg.merge_from_file("configs/smoke_synthetic.yaml")
    net = build_model_from_cfg(cfg, device="cpu", seed=0)
    for drop in (lambda m: m.train(), lambda m: m.to(torch.float32)):
        cache = graphs.GraphCache(capture=StandIn(), device_type="cpu")
        graphs.attach(net, cache)
        cache.entries["seen"] = object()
        drop(net)
        assert graphs.cache_of(net) is not cache and not graphs.cache_of(net).entries
        net.eval()


@pytest.mark.parametrize("where", ["outside the eval step", "outside inference mode",
                                   "model in train mode", "tensors off the cache's device"])
def test_nothing_engages_outside_the_open_eval_step(counts, where):
    model = Tiny().eval()
    capture = _stand_in(model)
    x = torch.ones(3)
    for _ in range(3):
        if where == "outside the eval step":
            with torch.inference_mode():
                out = graphs.segment("double", model.double, x)
        elif where == "outside inference mode":
            with graphs.opened(model, x):
                out = graphs.segment("double", model.double, x)
        elif where == "model in train mode":
            model.train()
            out = _call(model, x)
        else:
            graphs.attach(model, graphs.GraphCache(capture=capture, device_type="cuda"))
            out = _call(model, x)
        assert torch.equal(out["y"], x * 2)
    assert model.calls == 3 and capture.captured == 0
    assert counts() == dict.fromkeys(COUNTERS, 0)


def test_an_output_feeds_the_next_segment_without_a_copy_and_another_tensor_runs_eagerly(counts):
    model = Tiny().eval()
    capture = _stand_in(model)
    x = torch.ones(3)

    def chain(inp):
        with torch.inference_mode(), graphs.opened(model, inp):
            first = graphs.segment("first", model.double, inp)
            return first, graphs.segment("second", model.double, first["parts"][1])

    for _ in range(3):
        first, second = chain(x)
    cache = graphs.cache_of(model)
    second_graph = [e for k, e in cache.entries.items() if k[1] == "second"][0]
    assert second_graph.aliased == [True]  # a view of "first"'s output, not a copy of it
    assert second_graph.inputs[0].data_ptr() == first["parts"][1].data_ptr()
    assert torch.equal(second["y"], (x * 2 + 1) * 2)
    assert counts() == {"eval.graph_eager": 2, "eval.graph_captures": 2,
                        "eval.graph_replays": 2}
    with torch.inference_mode(), graphs.opened(model, x):
        other = graphs.segment("second", model.double, torch.full((3,), 7.0))
    assert torch.equal(other["y"], torch.full((3,), 14.0))
    assert torch.equal(first["parts"][1], x * 2 + 1)  # "first"'s output left as it was
    assert counts()["eval.graph_eager"] == 3 and capture.captured == 2


def _smoke_model():
    cfg = get_cfg()
    cfg.merge_from_file("configs/smoke_synthetic.yaml")
    h, w = cfg.INPUT.IMAGE_SIZE
    model = build_model_from_cfg(cfg, device="cpu", seed=0)
    return cfg, model, make_eval_step(model, h, w, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)


def _leaves(tree, path="out"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


def _direct(model, cfg, images, out_hw=None):
    """model.inference on the eval step's normalised inputs, no cache open."""
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32)
    inv_std = torch.from_numpy((1.0 / np.asarray(cfg.MODEL.PIXEL_STD, np.float32))
                               .astype(np.float32))
    x = [((im.to(torch.float32) - mean) * inv_std).permute(0, 3, 1, 2).contiguous()
         for im in images]
    h, w = out_hw or cfg.INPUT.IMAGE_SIZE
    with torch.inference_mode():
        return model.inference(*x, out_h=h, out_w=w)


def _equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_eval_step_on_the_cpu_stays_eager_and_bit_equal(counts):
    cfg, model, step = _smoke_model()
    h, w = cfg.INPUT.IMAGE_SIZE
    for seed in (1, 2, 3):
        images = synthetic_pairs(2, h, w, seed=seed, device="cpu")
        _equal(step(*images), _direct(model, cfg, images))
    assert counts() == dict.fromkeys(COUNTERS, 0) and len(graphs.cache_of(model)) == 0


def test_eval_step_through_the_stand_in_replays_every_segment_bit_equal(counts):
    """Three batches of distinct images: the eager first call, the capture,
    a replay; each bit-equal to the direct forward. Every segment engages,
    and a replay copies only the backbone's input and the outputs of the
    eager kernels B1 (three) and B2 (one): every other argument is an
    earlier segment's output."""
    cfg, model, step = _smoke_model()
    capture = _stand_in(model)
    h, w = cfg.INPUT.IMAGE_SIZE
    batches = [synthetic_pairs(2, h, w, seed=seed, device="cpu") for seed in (1, 2, 3)]
    for images in batches:
        _equal(step(*images), _direct(model, cfg, images))
    segments = len(graphs.cache_of(model))
    assert segments == 12 and capture.captured == segments
    assert counts() == dict.fromkeys(COUNTERS, segments)
    copied = [k[1] for k, g in graphs.cache_of(model).entries.items() for a in g.aliased
              if not a]
    assert sorted(copied) == ["assignment", "backbone"] + ["select_filter"] * 3


def test_eval_steps_at_two_output_sizes_keep_graphs_and_pools_of_their_own(counts):
    """Two eval steps of one model on one input signature that differ in
    their output size: each has its own graphs and pool, captured in one
    call, and replays bit-equal to the direct forward at its size."""
    cfg, model, _ = _smoke_model()
    capture = _stand_in(model)
    h, w = cfg.INPUT.IMAGE_SIZE
    sizes = [(h, w), (h // 2, w // 2)]
    steps = [make_eval_step(model, oh, ow, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)
             for oh, ow in sizes]
    for seed in (1, 2, 3):
        images = synthetic_pairs(2, h, w, seed=seed, device="cpu")
        for step, size in zip(steps, sizes):
            _equal(step(*images), _direct(model, cfg, images, size))
    cache = graphs.cache_of(model)
    assert len(cache.pools) == 2 and len(cache) == 24 and capture.captured == 24
    assert len(set(map(id, capture.pools))) == 2
    assert counts() == dict.fromkeys(COUNTERS, 24)
