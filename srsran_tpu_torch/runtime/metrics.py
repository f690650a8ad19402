"""Host copy of `srsran_tpu/runtime/metrics.py`, held to it by `tests/test_torch_stack.py`.

Metrics hub: periodic polling fanned out to listeners.

Re-design of `metrics_hub.h` + `metrics_stdout.cc` / `metrics_csv.cc`:
producers register `get_metrics()` callables returning flat dicts; the hub
polls on a timer (or manually in tests) and forwards to all listeners.
"""

from __future__ import annotations

import csv
import sys
import threading
import time


class MetricsHub:
    def __init__(self, period_s: float = 1.0):
        self.period = period_s
        self.producers = []  # callables -> dict
        self.listeners = []  # objects with .consume(dict)
        self._stop = threading.Event()
        self._thread = None

    def add_producer(self, fn):
        self.producers.append(fn)

    def add_listener(self, listener):
        self.listeners.append(listener)

    def poll_once(self):
        merged = {"ts": time.time()}
        for p in self.producers:
            merged.update(p() or {})
        for l in self.listeners:
            l.consume(merged)
        return merged

    def start(self):
        def run():
            while not self._stop.wait(self.period):
                self.poll_once()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class StdoutMetrics:
    """Live table like metrics_stdout.cc."""

    def __init__(self, keys=None, out=sys.stdout):
        self.keys = keys
        self.out = out
        self._hdr_every = 10
        self._n = 0

    def consume(self, m: dict):
        keys = self.keys or [k for k in m if k != "ts"]
        if self._n % self._hdr_every == 0:
            self.out.write("  ".join(f"{k:>10}" for k in keys) + "\n")
        self._n += 1
        row = []
        for k in keys:
            v = m.get(k, "")
            row.append(f"{v:>10.3g}" if isinstance(v, float) else f"{v!s:>10}")
        self.out.write("  ".join(row) + "\n")


class CsvMetrics:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w", newline="")
        self._w = None

    def consume(self, m: dict):
        if self._w is None:
            self._w = csv.DictWriter(self._f, fieldnames=list(m.keys()))
            self._w.writeheader()
        self._w.writerow({k: m.get(k, "") for k in self._w.fieldnames})
        self._f.flush()

    def close(self):
        self._f.close()
