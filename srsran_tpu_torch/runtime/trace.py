"""Host copy of `srsran_tpu/runtime/trace.py`, held to it by `tests/test_torch_stack.py`.

Chrome-trace event tracing (re-design of srslog's event tracer,
`lib/include/srslte/srslog/event_trace.h:34-65` / `event_trace.cpp`).

Emits the Chrome Trace Event JSON format (load in chrome://tracing or
Perfetto). Duration events via the `trace_duration` context manager /
decorator, complete events via `trace_complete`, instant events via
`trace_instant`. Disabled (zero-cost no-op) until `enable()` is called —
the analog of the ENABLE_SRSLOG_EVENT_TRACE compile flag.

The port adds two things the reference has not.  `span(name)` marks a
stage of the device pipelines: while the tracer is off it returns one
shared no-op context manager (a flag test, nothing allocated, no torch
call); while it is on it opens `torch.profiler.record_function(name)`,
which stamps the range on the profiler's own clock beside the host
operations and kernels it encloses, and records the same Chrome "X" event
as `duration`.  `count(name, n)` adds to a module-level dict of integers
that is always on, as `phy/fec/turbo_cuda.LAUNCHES` is; `counts()` returns
a copy.  The pipelines count `host_reads`: every wait of the host for the
device on their path.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time


class EventTracer:
    def __init__(self):
        self.enabled = False
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def enable(self):
        self.enabled = True
        self._t0 = time.perf_counter()

    def disable(self):
        self.enabled = False

    def _us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict):
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def duration(self, name: str, category: str = "phy", **args):
        if not self.enabled:
            yield
            return
        t0 = self._us()
        try:
            yield
        finally:
            self._emit(
                dict(name=name, cat=category, ph="X", ts=t0, dur=self._us() - t0,
                     pid=os.getpid(), tid=threading.get_ident() & 0xFFFF, args=args)
            )

    def span(self, name: str):
        """A stage of a device pipeline: `_NO_SPAN` while off; while on, a
        `torch.profiler.record_function` range and the Chrome "X" event
        that `duration` records."""
        if not self.enabled:
            return _NO_SPAN
        return self._profiled(name)

    @contextlib.contextmanager
    def _profiled(self, name: str):
        from torch.profiler import record_function  # torch only once a span is taken

        # `duration`'s event, with the process id read once: os.getpid() is
        # a system call, slow where system calls are trapped
        with record_function(name):
            t0 = self._us()
            try:
                yield
            finally:
                self._emit(
                    dict(name=name, cat="phy", ph="X", ts=t0, dur=self._us() - t0,
                         pid=_pid(), tid=threading.get_ident() & 0xFFFF, args={})
                )

    def instant(self, name: str, category: str = "phy", **args):
        if not self.enabled:
            return
        self._emit(
            dict(name=name, cat=category, ph="i", ts=self._us(), s="t",
                 pid=os.getpid(), tid=threading.get_ident() & 0xFFFF, args=args)
        )

    def counter(self, name: str, **values):
        if not self.enabled:
            return
        self._emit(
            dict(name=name, ph="C", ts=self._us(), pid=os.getpid(), args=values)
        )

    def traced(self, name: str | None = None, category: str = "phy"):
        """Decorator form."""

        def wrap(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.duration(label, category):
                    return fn(*a, **kw)

            return inner

        return wrap

    def save(self, path: str):
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def clear(self):
        with self._lock:
            self._events.clear()


# the span of a tracer that is off: reused by every call, it allocates nothing
_NO_SPAN = contextlib.nullcontext()
# this process's id once a span has read it; a forked child reads its own
_PID = []


def _pid() -> int:
    if not _PID:
        _PID.append(os.getpid())
        os.register_at_fork(after_in_child=_PID.clear)
    return _PID[0]


# the port's counters since the process started: name -> int
COUNTS = {}
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1):
    with _COUNTS_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n


def counts() -> dict[str, int]:
    with _COUNTS_LOCK:
        return dict(COUNTS)


# module-level tracer (like the srslog singleton)
tracer = EventTracer()
trace_duration = tracer.duration
trace_instant = tracer.instant
trace_counter = tracer.counter
span = tracer.span
