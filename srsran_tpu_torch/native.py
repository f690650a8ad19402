"""Host copy of `srsran_tpu/native.py`, held to it by `tests/test_torch_stack.py`.

ctypes bindings for the native sample transport (native/sample_ring.cpp).

`SampleRing` is the RF-boundary buffer between native ingest (UDP pump /
radio driver) and the device-feeding Python loop — the role of the
reference's `ringbuffer.c` + `rf_zmq_imp.c` receive path, with the UDP pump
running entirely off the GIL.

The library is built at its first use (`build`) from the repo's
`native/sample_ring.cpp` and the port's `csrc/log_backend.cpp` with `g++` and
the flags of `native/Makefile`, into `srsran_tpu_torch/_build/` (never into
`native/`), named by a hash of the sources, the flags and the host CPU
(`-march=native`), and written to a temporary file that is renamed into
place, so that processes that start together build it safely.  A failed
build raises; there is no Python ring in its place.  The port's log backend
is a copy of `native/log_backend.cpp` with a `slog_flush` that returns once every line
accepted before it is in the file (the reference's returns once the queue is
empty, which can be before its worker has written the last batch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG.parent / "native" / "sample_ring.cpp", _PKG / "csrc" / "log_backend.cpp")
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def build() -> Path:
    """Compile the native library if it is not built yet; returns its path."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)
                            + " ".join(CXXFLAGS).encode() + _cpu_flags())
    lib_path = BUILD_DIR / f"libsrsran_native_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES), "-lpthread"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native library:\n{r.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = str(build())
    lib = ctypes.CDLL(path)
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    for f in ("ring_readable", "ring_writable"):
        getattr(lib, f).restype = ctypes.c_size_t
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.ring_dropped.restype = ctypes.c_uint64
    lib.ring_dropped.argtypes = [ctypes.c_void_p]
    lib.ring_write.restype = ctypes.c_size_t
    lib.ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ring_read.restype = ctypes.c_size_t
    lib.ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ring_read_blocking.restype = ctypes.c_size_t
    lib.ring_read_blocking.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,
    ]
    lib.udp_pump_start.restype = ctypes.c_int
    lib.udp_pump_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lib = lib
    return lib


class SampleRing:
    """Lock-free SPSC complex64 ring with optional native UDP ingest."""

    def __init__(self, capacity_samples: int):
        self._lib = _load()
        self._h = self._lib.ring_create(capacity_samples)
        self.capacity = capacity_samples

    def write(self, samples: np.ndarray) -> int:
        x = np.ascontiguousarray(samples, np.complex64)
        return self._lib.ring_write(self._h, x.ctypes.data_as(ctypes.c_void_p), len(x))

    def read(self, n: int, timeout_s: float = 0.0) -> np.ndarray:
        out = np.empty(n, np.complex64)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        if timeout_s > 0:
            got = self._lib.ring_read_blocking(self._h, ptr, n, int(timeout_s * 1e6))
        else:
            got = self._lib.ring_read(self._h, ptr, n)
        return out[:got]

    @property
    def readable(self) -> int:
        return self._lib.ring_readable(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.ring_dropped(self._h)

    def start_udp_pump(self, port: int):
        rc = self._lib.udp_pump_start(self._h, port)
        if rc != 0:
            raise OSError(f"udp_pump_start failed: {rc}")

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeLogBackend:
    """Async file-sink log backend (native/log_backend.cpp) — the srslog
    backend_worker role: `write()` never blocks on I/O; one native thread
    drains a bounded queue into the file."""

    def __init__(self, path: str, queue_capacity: int = 8192):
        lib = _load()
        if not hasattr(lib.slog_create, "_configured"):
            lib.slog_create.restype = ctypes.c_void_p
            lib.slog_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.slog_write.restype = ctypes.c_int
            lib.slog_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
            for f in ("slog_dropped", "slog_written"):
                getattr(lib, f).restype = ctypes.c_uint64
                getattr(lib, f).argtypes = [ctypes.c_void_p]
            lib.slog_flush.argtypes = [ctypes.c_void_p]
            lib.slog_destroy.argtypes = [ctypes.c_void_p]
            lib.slog_create._configured = True
        self._lib = lib
        self._h = lib.slog_create(path.encode(), queue_capacity)
        if not self._h:
            raise OSError(f"cannot open log sink {path}")

    def write(self, line: str) -> bool:
        data = line.encode()
        return bool(self._lib.slog_write(self._h, data, len(data)))

    def flush(self):
        self._lib.slog_flush(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.slog_dropped(self._h)

    @property
    def written(self) -> int:
        return self._lib.slog_written(self._h)

    def close(self):
        if self._h:
            self._lib.slog_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
