"""Host copy of `srsran_tpu/runtime/logger.py`, held to it by `tests/test_torch_stack.py`.

Async logger — frontends enqueue, a backend thread formats and writes.

Re-design of srslog (`lib/src/srslog/log_backend_impl.h:43-61`,
`backend_worker.cpp`): log calls never block on I/O; entries go through a
queue to one backend thread with file/stream sinks, per-channel levels and
hex dumps, flushed on close.

`set_log_file(native=True)` takes the native backend of `native.py`, whose
library is built at its first use; a failed build raises.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

from ..native import NativeLogBackend

LEVELS = {"none": 0, "error": 1, "warning": 2, "info": 3, "debug": 4}


class _Backend:
    def __init__(self):
        self.q: queue.Queue = queue.Queue(maxsize=8192)
        self.sinks = [sys.stdout]
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                break
            for s in self.sinks:
                try:
                    s.write(item)
                except ValueError:
                    pass
        for s in self.sinks:
            try:
                s.flush()
            except Exception:
                pass

    def stop(self):
        self.q.put(None)
        self.thread.join(timeout=2)


_backend: _Backend | None = None
_lock = threading.Lock()


def _get_backend() -> _Backend:
    global _backend
    with _lock:
        if _backend is None:
            _backend = _Backend()
        return _backend


def set_log_file(path: str, native: bool = True):
    """Route log output to `path`.  With native=True (default) the file
    sink is the C++ async backend (native/log_backend.cpp, the srslog
    backend_worker role) — the Python queue thread then only relays to
    it, and the actual I/O happens entirely off the GIL.  A native library
    that cannot be built raises: the port keeps no Python sink in its place."""
    b = _get_backend()
    if native:
        b.sinks = [_NativeSink(NativeLogBackend(path))]
        return
    b.sinks = [open(path, "a")]


class _NativeSink:
    def __init__(self, backend):
        self.backend = backend

    def write(self, line: str):
        self.backend.write(line)

    def flush(self):
        self.backend.flush()


class Logger:
    def __init__(self, channel: str, level: str = "info", hex_limit: int = 32):
        self.channel = channel
        self.level = LEVELS[level]
        self.hex_limit = hex_limit
        self._b = _get_backend()

    def _log(self, lvl: str, msg: str, hexdata=None):
        if LEVELS[lvl] > self.level:
            return
        t = time.time()
        line = f"{t:.6f} [{self.channel:<5}] [{lvl[0].upper()}] {msg}\n"
        if hexdata is not None and self.hex_limit > 0:
            data = bytes(hexdata)[: self.hex_limit]
            line += "  " + " ".join(f"{b:02x}" for b in data) + "\n"
        try:
            self._b.q.put_nowait(line)
        except queue.Full:
            pass  # drop under pressure, like the reference's non-blocking mode

    def error(self, msg, hexdata=None):
        self._log("error", msg, hexdata)

    def warning(self, msg, hexdata=None):
        self._log("warning", msg, hexdata)

    def info(self, msg, hexdata=None):
        self._log("info", msg, hexdata)

    def debug(self, msg, hexdata=None):
        self._log("debug", msg, hexdata)


_loggers: dict[str, Logger] = {}


def get_logger(channel: str, level: str = "info") -> Logger:
    if channel not in _loggers:
        _loggers[channel] = Logger(channel, level)
    return _loggers[channel]


def flush():
    b = _get_backend()
    while not b.q.empty():
        time.sleep(0.01)
