"""CUDA graphs of the port's fixed-shape paths.

A path that runs the same shapes call after call (a batched entry point,
its turbo loop) is captured as CUDA graphs on a key's second call and
replayed from then on: the same kernels in the same order on the same
buffers, one launch a graph where the eager path dispatches one operation
at a time.  A key's first call runs eagerly, so that a shape met once is
never captured; the CPU always runs eagerly.

* `on_capture_stream` and `captured`: a block captured on the device's
  side stream (a graph cannot be captured on the default one).
* `Cache`: the objects that hold a path's graphs, per device and key, the
  least recently used dropped first.
* `Step` and `run`: a call as a list of steps over a dict of named
  tensors, each step under its program spans (`runtime.trace.span`).
* `Graphed`: an entry point's steps, run eagerly or, per input shape,
  replayed: each step one CUDA graph under its spans, so that the
  per-span readers attribute the replayed kernels as the eager ones.  A
  step that is not a graph (the turbo loop, which holds host reads and
  replays graphs of its own) runs as it is on every call, its results
  copied into buffers that the next graph reads.  The entries count
  `entry_calls` and `entry_graph_replays` (`runtime.trace.count`); what a
  step counts while it is captured, when nothing runs, is taken out again
  and counted at each replay of its graph (`mmse4_launches`).
"""

from __future__ import annotations

import contextlib
import itertools
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from .device import pinned
from .runtime.trace import count, counts, span

_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def on_capture_stream(dev: torch.device):
    """Run the block on the device's capture stream, after the current
    stream's work and before its next."""
    current = torch.cuda.current_stream(dev)
    side = _CAPTURE_STREAMS.get(dev)
    if side is None:
        side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        yield
    current.wait_stream(side)


def captured(fn, pool=None) -> torch.cuda.CUDAGraph:
    """`fn()` captured as a CUDA graph on the current stream, its memory
    from `pool` (`torch.cuda.graph_pool_handle`, shared by graphs that
    replay in the order they were captured) or a pool of its own: nothing
    runs; the tensors it makes are the graph's, rewritten by every replay."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool)
    try:
        fn()
    finally:
        graph.capture_end()
    return graph


class Cache:
    """Holders of CUDA graphs, per device and key.  `get` returns None on a
    key's first call, which runs eagerly and is remembered among the `seen`
    keys met last; it makes the holder on the key's second call and returns
    it from then on, keeping on each device the `per_device` used last."""

    def __init__(self, per_device: int, seen: int = 64):
        self.per_device, self.seen_max = per_device, seen
        self.by_device: dict[torch.device, OrderedDict] = {}
        self.seen: OrderedDict = OrderedDict()

    def get(self, dev: torch.device, key, make: Callable[[], object]):
        held = self.by_device.setdefault(dev, OrderedDict())
        obj = held.get(key)
        if obj is not None:
            held.move_to_end(key)
            return obj
        if self.seen.pop((dev, key), None) is None:
            self.seen[(dev, key)] = True
            if len(self.seen) > self.seen_max:
                self.seen.popitem(last=False)
            return None
        obj = held[key] = make()
        if len(held) > self.per_device:
            held.popitem(last=False)
        return obj


class Step(NamedTuple):
    """One step of a call: `fn(state)` reads the named tensors of `state`
    and returns the new ones, under the program spans `spans` (outermost
    first).  `graphed` False: the step runs as it is on every call."""

    spans: tuple[str, ...]
    fn: Callable[[dict], dict]
    graphed: bool = True


class _Spans:
    """The program spans around a call's steps: `at(spans)` before each
    step closes the spans open that are not among the step's and opens the
    step's that are not open, so that steps whose spans begin alike share
    one range of those (`fe.mimo` inside the `fe.equalize` of the RE
    gathers)."""

    def __init__(self):
        self.names: list[str] = []
        self.open: list = []

    def at(self, spans: tuple[str, ...]):
        keep = 0
        while keep < min(len(self.names), len(spans)) and self.names[keep] == spans[keep]:
            keep += 1
        self._close(keep)
        for name in spans[keep:]:
            opened = span(name)
            opened.__enter__()
            self.names.append(name)
            self.open.append(opened)

    def _close(self, keep: int = 0):
        while len(self.open) > keep:
            self.names.pop()
            self.open.pop().__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._close()


def run(steps, state: dict) -> dict:
    """Run `steps` eagerly in order over `state`; returns it, updated."""
    with _Spans() as spans:
        for st in steps:
            spans.at(st.spans)
            state.update(st.fn(state))
    return state


def _merged(steps) -> list[Step]:
    """`steps` with each run of graph steps under the same spans joined
    into one step (one graph)."""
    out: list[Step] = []
    for st in steps:
        if out and st.graphed and out[-1].graphed and st.spans == out[-1].spans:
            out[-1] = out[-1]._replace(fn=_chained(out[-1].fn, st.fn))
        else:
            out.append(st)
    return out


def _chained(first, then):
    def both(state: dict) -> dict:
        new = first(state)
        return {**new, **then({**state, **new})}

    return both


# the graphs of the entry points, per device and key (entry, input shape, dtype)
ENTRY_GRAPHS_PER_DEVICE = 4
ENTRIES = Cache(ENTRY_GRAPHS_PER_DEVICE)
_ENTRY_IDS = itertools.count()


class Graphed:
    """An entry point's steps (`Step`), called with its input `samples`;
    returns the state's tensors named by `outputs`.

    On a CUDA device, from the second call with an input shape
    (`ENTRIES`), the call replays (`_Replay`) and returns copies of the
    graphs' outputs, which the next replay leaves as they are.  Elsewhere,
    and on a shape's first call, the steps run eagerly."""

    def __init__(self, steps, outputs: tuple[str, ...]):
        self.steps = _merged(steps)
        self.outputs = outputs
        self.id = next(_ENTRY_IDS)  # never reused, as an id() may be

    def __call__(self, samples: torch.Tensor) -> list[torch.Tensor]:
        count("entry_calls")
        if samples.device.type == "cuda":
            key = (self.id, tuple(samples.shape), samples.dtype)
            held = ENTRIES.get(samples.device, key, lambda: _Replay(self.steps, samples))
            if held is not None:
                if held(samples):
                    count("entry_graph_replays")
                return [_owned(held.state[name]) for name in self.outputs]
        state = run(self.steps, {"samples": samples})
        return [state[name] for name in self.outputs]


def _owned(t: torch.Tensor) -> torch.Tensor:
    """A copy of a graph's output, which no replay rewrites, in its layout:
    a view copies the whole of its base, one device-to-device copy where a
    strided one would be a kernel, and views the copy alike."""
    base = t._base
    if base is None:
        return t.clone()
    return base.clone().as_strided(t.size(), t.stride(),
                                   t.storage_offset() - base.storage_offset())


class _Replay:
    """One key of a `Graphed`: a static input buffer, and per step its CUDA
    graph or, for a step that is not a graph, the buffers that its results
    are copied into.  The first call captures: each graph step runs once
    eagerly on the capture stream (which warms the libraries' handles for
    it), is captured into the key's one memory pool and replayed at once,
    so that the next step reads real outputs.  Every step's outputs stay
    alive in `state`, and the tables each capture fetched in `pins`
    (`device.pinned`), as long as the graphs that read them."""

    def __init__(self, steps, samples: torch.Tensor):
        self.steps = steps
        self.state = {"samples": torch.empty_like(samples)}
        self.plan: list | None = None
        self.pool = None
        self.pins: list = []  # the tables the graphs read
        self.counts: dict[int, dict[str, int]] = {}  # what each graph counts a replay

    def __call__(self, samples: torch.Tensor) -> bool:
        """One call over `samples`; True where it replayed the graphs (False
        on the call that captured them)."""
        self.state["samples"].copy_(samples)
        plan = None
        if self.plan is None:
            self.pool, plan = torch.cuda.graph_pool_handle(), []
        with _Spans() as spans:
            for i, st in enumerate(self.steps):
                spans.at(st.spans)
                if plan is not None:
                    plan.append(self._capture(st, i))
                elif st.graphed:
                    self.plan[i].replay()
                    _recount(self.counts[i])
                else:
                    _load(self.plan[i], st.fn(self.state))
        if plan is None:
            return True
        self.plan = plan
        return False

    def _capture(self, st: Step, i: int):
        if not st.graphed:
            new = st.fn(self.state)
            held = {name: torch.empty_like(v) for name, v in new.items()}
            _load(held, new)
            self.state.update(held)
            return held
        new = {}
        with on_capture_stream(self.state["samples"].device):
            st.fn(self.state)
            with pinned() as tables, _uncounted() as self.counts[i]:
                graph = captured(lambda: new.update(st.fn(self.state)), self.pool)
            graph.replay()
            _recount(self.counts[i])
        self.pins += tables
        self.state.update(new)
        return graph


@contextlib.contextmanager
def _uncounted():
    """Counts made inside (a capture, in which nothing runs) are taken out
    of `runtime.trace.counts` again on exit; yields a dict that holds them
    then."""
    taken: dict[str, int] = {}
    before = counts()
    try:
        yield taken
    finally:
        for name, n in counts().items():
            if n != before.get(name, 0):
                taken[name] = n - before.get(name, 0)
                count(name, -taken[name])


def _recount(taken: dict[str, int]):
    """Count what `_uncounted` took out of a graph's capture, for one run of
    the graph."""
    for name, n in taken.items():
        count(name, n)


def _load(buffers: dict, new: dict):
    for name, v in new.items():
        buffers[name].copy_(v)
