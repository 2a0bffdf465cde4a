"""CUDA graphs of the eval step's segments, captured once per input
signature and replayed after that, so that the host issues a graph launch
where it issued each of a segment's kernels.

The eval step (`engine/predict.py:make_eval_step`) opens its model's cache
for each call (`opened`); inside, the model runs each segment of its
inference through `segment(name, fn, *args)`. A segment is the work between
two calls that stay eager: the hand-written kernels B1 (`ops/select.py`) and
B2 (`ops/sinkhorn.py`), and the module calls and spans around which callers
time or trace the work (`ResNet.forward`, `MatchingHead.forward`,
`utils/trace.py`'s spans). Per key (the eval step's input signature, the
segment's name and its arguments' signature: each tensor's shape, dtype and
device, each other argument's value, the nesting of dicts, lists and tuples):

  * the first call runs `fn` eagerly: it makes the lazy state (cuDNN and
    cuBLAS plans, the constants kept per device) before any capture;
  * the second captures `fn` on its tensor arguments copied into static
    buffers, then replays the graph;
  * every later call copies its tensor arguments into the static buffers and
    replays. An argument that already is its buffer is not copied; at
    capture, an argument that is (a view of) an earlier segment's output is
    taken as its buffer, as when one graph feeds the next. A later call that
    passes another tensor there runs `fn` eagerly instead of overwriting that
    output.

A segment returns its static outputs in fresh containers: they hold their
values until the next call with the same eval-step signature. The segments
of one eval-step signature captured in one call share one memory pool, since
each later call replays them in the order of their capture: a later graph
may take an earlier one's temporaries, never its outputs, which the cache
keeps alive. A segment captured in a later call than its pool's first graph
(a signature that first showed then) would replay before graphs captured
ahead of it, which could overwrite its outputs: it takes a pool of its own.

The host runs a captured segment's Python once, at the capture, and a
replay runs none. What counts work on the card (`utils/device.py:LAUNCHES`,
a forward hook) reports it through `on_replay`, which a capture defers to
each replay of its graph.

`segment` calls `fn` straight through unless a cache is open, the model is
in eval mode, inference mode is on and every tensor argument is on the
cache's device type (CUDA): training, the CPU and direct callers of the
model's methods run eagerly, as before. `fn` must take its tensors as
arguments and depend on nothing else that changes between calls but the
model's parameters and buffers, which a replay reads where they were at
capture: an update in place (an optimizer step, a state_dict load) shows in
the next replay, and `drop` (called by the model's `train()` and `_apply`, so
by a move or a cast) forgets the graphs.

Counters (`utils/trace.py`): `eval.graph_replays`, `eval.graph_captures`,
and `eval.graph_eager` (a segment run eagerly inside an open cache).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch

from . import trace

_CACHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # model -> GraphCache
_local = threading.local()  # .open: (model, step key, call) of the eval step running on this
# thread; .recording: the callbacks of the segment being captured
_SEEN = object()  # a key run eagerly once: its next call captures
_streams: Dict[int, "torch.cuda.Stream"] = {}  # capture streams per device


def _flatten(x, leaves: List[torch.Tensor]):
    """x's structure with each tensor replaced by its signature (the tensors
    go to `leaves`, in order): a hashable key, and the spec `_rebuild` takes."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (torch.Tensor, tuple(x.shape), x.dtype, x.device)
    if type(x) is dict:
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if type(x) in (list, tuple):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    return x


def _rebuild(spec, leaves):
    """The structure of `spec` in fresh containers, its tensors taken from
    the iterator `leaves`."""
    if type(spec) is tuple:
        kind, body = spec[0], spec[1]
        if kind is torch.Tensor:
            return next(leaves)
        if kind is dict:
            return {k: _rebuild(s, leaves) for k, s in body}
        return kind(_rebuild(s, leaves) for s in body)
    return spec


def capture_cuda(fn: Callable, args: tuple, pool) -> Tuple[Callable[[], None], Any]:
    """Capture `fn(*args)` as a CUDA graph in `pool` on a side stream of the
    current device; returns (replay, the graph's static outputs)."""
    dev = torch.cuda.current_device()
    stream = _streams.get(dev)
    if stream is None:
        stream = _streams[dev] = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn(*args)
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph.replay, out


@contextlib.contextmanager
def recording(into: List[Callable[[], None]]):
    """Send `on_replay`'s callbacks to `into` rather than calling them."""
    prev = getattr(_local, "recording", None)
    _local.recording = into
    try:
        yield
    finally:
        _local.recording = prev


def on_replay(fn: Callable[[], None]) -> None:
    """`fn()` for work the card does: now, or where a segment is being
    captured, at each replay of its graph (the capture's own first replay
    included), so that a count of launches or module runs holds under
    graphs."""
    into = getattr(_local, "recording", None)
    if into is None:
        fn()
    else:
        into.append(fn)


class _Graph:
    __slots__ = ("graph_replay", "on_replay", "inputs", "aliased", "out_spec", "outputs")

    def __init__(self, graph_replay, on_replay, inputs, aliased, out_spec, outputs):
        self.graph_replay = graph_replay
        self.on_replay = on_replay
        self.inputs = inputs
        self.aliased = aliased
        self.out_spec = out_spec
        self.outputs = outputs

    def replay(self) -> None:
        self.graph_replay()
        for fn in self.on_replay:
            fn()

    def load(self, leaves: List[torch.Tensor]) -> bool:
        """Copy the call's tensors into the static inputs; False where a call
        passes another tensor than an aliased output."""
        for x, s, aliased in zip(leaves, self.inputs, self.aliased):
            if x.data_ptr() == s.data_ptr() and x.stride() == s.stride():
                continue
            if aliased:
                return False
            s.copy_(x)
        return True

    def result(self):
        return _rebuild(self.out_spec, iter(self.outputs))


class GraphCache:
    """The graphs of one model's eval step, by key (see the module's doc).
    `capture(fn, args, pool) -> (replay, static outputs)` and `device_type`
    are CUDA's unless a caller stands in its own."""

    def __init__(self, capture: Callable = capture_cuda, device_type: str = "cuda"):
        self.capture = capture
        self.device_type = device_type
        self.entries: Dict[Any, Any] = {}
        self.pools: Dict[Any, Any] = {}  # step key -> (memory pool, the call that opened it)
        self.owned: Dict[Any, set] = {}  # step key -> storages of its static outputs

    def __len__(self) -> int:
        return sum(isinstance(e, _Graph) for e in self.entries.values())

    def run(self, step_key, call, name: str, fn: Callable, args: tuple):
        leaves: List[torch.Tensor] = []
        spec = _flatten(args, leaves)
        if not leaves or any(t.device.type != self.device_type for t in leaves):
            return fn(*args)
        key = (step_key, name, spec)
        entry = self.entries.get(key)
        if entry is None:
            self.entries[key] = _SEEN
            trace.count("eval.graph_eager")
            return fn(*args)
        if entry is _SEEN:
            entry = self.entries[key] = self._capture(step_key, call, fn, spec, leaves)
            trace.count("eval.graph_captures")
            return entry.result()
        if not entry.load(leaves):
            trace.count("eval.graph_eager")
            return fn(*args)
        entry.replay()
        trace.count("eval.graph_replays")
        return entry.result()

    def _new_pool(self):
        return torch.cuda.graph_pool_handle() if self.device_type == "cuda" else object()

    def _capture(self, step_key, call, fn: Callable, spec,
                 leaves: List[torch.Tensor]) -> _Graph:
        owned = self.owned.setdefault(step_key, set())
        aliased = [x.untyped_storage().data_ptr() in owned for x in leaves]
        inputs = [x if a else x.clone() for x, a in zip(leaves, aliased)]
        if step_key not in self.pools:
            self.pools[step_key] = (self._new_pool(), call)
        pool, opened_by = self.pools[step_key]
        if opened_by is not call:  # a later call's capture: a pool of its own
            pool = self._new_pool()
        done: List[Callable[[], None]] = []
        with recording(done):
            graph_replay, out = self.capture(fn, _rebuild(spec, iter(inputs)), pool)
        outputs: List[torch.Tensor] = []
        out_spec = _flatten(out, outputs)
        owned.update(t.untyped_storage().data_ptr() for t in outputs)
        graph = _Graph(graph_replay, done, inputs, aliased, out_spec, outputs)
        graph.replay()
        return graph


def cache_of(model) -> GraphCache:
    """The model's cache, made on first use."""
    cache = _CACHES.get(model)
    if cache is None:
        cache = _CACHES[model] = GraphCache()
    return cache


def attach(model, cache: GraphCache) -> None:
    """Give the model a cache of another capture (a stand-in, on the CPU)."""
    _CACHES[model] = cache


def drop(model) -> None:
    """Forget the model's graphs. Where it had CUDA graphs, first wait for
    the card: a replay still queued reads their memory."""
    cache = _CACHES.pop(model, None)
    if cache is not None and len(cache) and cache.device_type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def opened(model, *inputs):
    """Open the model's cache for one eval-step call on `inputs` (its device
    tensors, optional dicts and the other values its segments depend on;
    their signature keys the call's graphs and pool)."""
    prev = getattr(_local, "open", None)
    _local.open = (model, _flatten(inputs, []), object())
    try:
        yield
    finally:
        _local.open = prev


def segment(name: str, fn: Callable, *args):
    """`fn(*args)`, through the open cache's graph of this key where one
    engages (see the module's doc), else straight through."""
    opened_by = getattr(_local, "open", None)
    if opened_by is None:
        return fn(*args)
    model, step_key, call = opened_by
    if model.training or not torch.is_inference_mode_enabled():
        return fn(*args)
    return cache_of(model).run(step_key, call, name, fn, args)
