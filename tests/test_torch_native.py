"""The port's native binding (`srsran_tpu_torch/native.py`) on the CPU.

- The reference's `tests/test_native.py` on the port, with its inputs and
  asserts: the SPSC ring's write/read, wrap-around and overflow count, the
  GIL-free UDP pump (on a free port of its own), the native log backend's
  round trip and its drops under pressure, and the port's logger routed
  through the native sink.
- The build: the library is compiled from the repo's `native/` sources
  into `srsran_tpu_torch/_build/` under a name that hashes the sources and
  flags, never into `native/`; two processes that build into one empty
  directory at once both load the one library; a source that does not
  compile raises (no Python ring takes its place).
- The two packages' rings carry the same bytes: what the reference's ring
  holds, read by the port's, and the UDP pump of one fed by the other's
  `NetSink`.
"""

import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu_torch import native
from srsran_tpu_torch.native import SampleRing

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- tests/test_native.py on the port --------------------------------------


def test_ring_write_read():
    r = SampleRing(4096)
    data = (np.arange(1000) + 1j * np.arange(1000)).astype(np.complex64)
    assert r.write(data) == 1000
    assert r.readable == 1000
    got = r.read(600)
    np.testing.assert_array_equal(got, data[:600])
    got2 = r.read(400)
    np.testing.assert_array_equal(got2, data[600:])
    assert r.readable == 0
    r.close()


def test_ring_wraparound_and_overflow():
    r = SampleRing(1024)
    a = np.ones(800, np.complex64)
    assert r.write(a) == 800
    r.read(700)
    b = (np.arange(1200) * 1j).astype(np.complex64)
    wrote = r.write(b)  # only 924 samples of space → rest dropped
    assert wrote == 924
    assert r.dropped == 1200 - 924
    got = r.read(1024)
    assert len(got) == 100 + 924
    np.testing.assert_array_equal(got[100:], b[:924])
    r.close()


def test_udp_pump():
    r = SampleRing(65536)
    port = _free_udp_port()
    r.start_udp_pump(port)
    time.sleep(0.05)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    data = (np.arange(8192) + 1j).astype(np.complex64)
    raw = data.tobytes()
    for i in range(0, len(raw), 8192):
        sock.sendto(raw[i : i + 8192], ("127.0.0.1", port))
    got = r.read(8192, timeout_s=2.0)
    assert len(got) == 8192
    np.testing.assert_array_equal(got, data)
    sock.close()
    r.close()


def test_native_log_backend_roundtrip(tmp_path):
    path = tmp_path / "native.log"
    b = native.NativeLogBackend(str(path))
    n = 5000
    for i in range(n):
        assert b.write(f"line {i}\n")
    b.flush()
    assert b.written == n and b.dropped == 0
    b.close()
    lines = path.read_text().splitlines()
    assert len(lines) == n and lines[0] == "line 0" and lines[-1] == f"line {n-1}"


@pytest.mark.parametrize("n", [1, 3000])
def test_flush_puts_every_accepted_line_in_the_file(tmp_path, n):
    """Read before close: the port's slog_flush waits for the file, where the
    reference's returns once the queue is empty."""
    path = tmp_path / "flushed.log"
    b = native.NativeLogBackend(str(path))
    try:
        for rnd in range(3):
            for i in range(n):
                assert b.write(f"{rnd} {i}\n")
            b.flush()
            assert b.written == (rnd + 1) * n
            lines = path.read_text().splitlines()
            assert len(lines) == (rnd + 1) * n and lines[-1] == f"{rnd} {n - 1}"
    finally:
        b.close()


def test_native_log_backend_drops_under_pressure(tmp_path):
    b = native.NativeLogBackend(str(tmp_path / "tiny.log"), queue_capacity=4)
    sent = sum(b.write("x" * 512 + "\n") for _ in range(20000))
    b.flush()
    assert sent + b.dropped == 20000
    b.close()


def test_logger_routes_through_native_sink(tmp_path):
    from srsran_tpu_torch.runtime import logger as L

    backend = L._get_backend()
    sinks = backend.sinks
    path = tmp_path / "routed.log"
    try:
        L.set_log_file(str(path))
        assert isinstance(backend.sinks[0], L._NativeSink)
        lg = L.get_logger("TEST8", "debug")
        lg.info("hello native", hexdata=b"\x01\x02")
        lg.error("boom")
        L.flush()
        for s in backend.sinks:
            s.flush()
        text = path.read_text()
    finally:
        backend.sinks = sinks
    assert "hello native" in text and "boom" in text and "01 02" in text


# --- the build ----------------------------------------------------------------


def test_the_library_is_built_from_native_into_the_ports_build_directory():
    lib = native.build()
    assert lib.parent == ROOT / "srsran_tpu_torch" / "_build" and lib.exists()
    assert lib.name.startswith("libsrsran_native_") and lib.suffix == ".so"
    assert [p.relative_to(ROOT).as_posix() for p in native.SOURCES] == [
        "native/sample_ring.cpp", "srsran_tpu_torch/csrc/log_backend.cpp"]
    assert native.build() == lib  # unchanged sources: reused
    assert set(native.CXXFLAGS) >= {"-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"}


def test_two_processes_build_into_one_directory_at_once(tmp_path):
    code = (
        "import sys; from pathlib import Path\n"
        "import srsran_tpu_torch.native as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "r = n.SampleRing(64); print(n.build()); r.close()\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(paths.pop()).name]  # no temp file left


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


# --- the two packages ---------------------------------------------------------


def test_the_rings_of_both_packages_carry_the_same_bytes():
    from srsran_tpu.io.net import NetSink as RNetSink
    from srsran_tpu.native import SampleRing as RRing

    data = (np.random.default_rng(3).standard_normal(3000) * (1 + 2j)).astype(np.complex64)
    r_ring, t_ring = RRing(4096), SampleRing(4096)
    assert r_ring.write(data) == t_ring.write(data) == 3000
    assert r_ring.read(3000).tobytes() == t_ring.read(3000).tobytes() == data.tobytes()
    r_ring.close()
    # the reference's UDP sink into the port's native pump
    port = _free_udp_port()
    t_ring.start_udp_pump(port)
    time.sleep(0.05)
    sink = RNetSink("127.0.0.1", port, "udp")
    sink.write(data)
    sink.close()
    got = t_ring.read(3000, timeout_s=2.0)
    assert got.tobytes() == data.tobytes()
    t_ring.close()
