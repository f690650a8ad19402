"""Host copy of `srsran_tpu/runtime/crash.py`, held to it by `tests/test_torch_stack.py`.

Crash handler: fatal-signal backtrace dump (re-design of
`lib/src/common/crash_handler.c` + `backtrace.c`).

The reference installs SIGSEGV/SIGABRT/... handlers that append a
timestamped backtrace to `./srsLTE.backtrace.crash`.  Same contract here
via `faulthandler` for hard faults plus an `sys.excepthook` for unhandled
Python exceptions, writing to `srsran_tpu.backtrace.crash`.
"""

from __future__ import annotations

import datetime
import faulthandler
import sys
import traceback

DEFAULT_PATH = "./srsran_tpu.backtrace.crash"

_state: dict = {"file": None, "prev_hook": None}


def enable(path: str = DEFAULT_PATH):
    """Install the crash handlers (srslte_debug_handle_crash analog)."""
    f = open(path, "a")
    _state["file"] = f
    faulthandler.enable(file=f, all_threads=True)

    def hook(exc_type, exc, tb):
        f.write(f"--- srsran_tpu crashed. {datetime.datetime.now().isoformat()}\n")
        traceback.print_exception(exc_type, exc, tb, file=f)
        f.write("---  exiting  ---\n")
        f.flush()
        if _state["prev_hook"] is not None:
            _state["prev_hook"](exc_type, exc, tb)

    _state["prev_hook"] = sys.excepthook
    sys.excepthook = hook
    return path


def disable():
    faulthandler.disable()
    if _state["prev_hook"] is not None:
        sys.excepthook = _state["prev_hook"]
        _state["prev_hook"] = None
    if _state["file"] is not None:
        _state["file"].close()
        _state["file"] = None
