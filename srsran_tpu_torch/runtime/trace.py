"""Host copy of `srsran_tpu/runtime/trace.py`, held to it by `tests/test_torch_stack.py`.

Chrome-trace event tracing (re-design of srslog's event tracer,
`lib/include/srslte/srslog/event_trace.h:34-65` / `event_trace.cpp`).

Emits the Chrome Trace Event JSON format (load in chrome://tracing or
Perfetto). Duration events via the `trace_duration` context manager /
decorator, complete events via `trace_complete`, instant events via
`trace_instant`. Disabled (zero-cost no-op) until `enable()` is called —
the analog of the ENABLE_SRSLOG_EVENT_TRACE compile flag.
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


# module-level tracer (like the srslog singleton)
tracer = EventTracer()
trace_duration = tracer.duration
trace_instant = tracer.instant
trace_counter = tracer.counter
