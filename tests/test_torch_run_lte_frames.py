"""The S1AP framing of `srsran_tpu_torch.apps.run_lte_3proc` over a real
socket pair: `_drain_frames` keeps the bytes of a frame that has not all
arrived in the caller's buffer, and returns every frame whole and in order,
wherever the stream was split.  The reference's `_drain_frames`
(`apps/run_lte_3proc.py:66`) drops the bytes it has read when its 0.5 ms
timeout fires inside a frame, and then reads body bytes as a length; the
case that shows it is here too.  The frame format on the wire is the
reference's (4-byte big-endian length, then the body), so the two packages'
processes still talk to each other (`tests/test_torch_run_lte_crossed.py`).
"""

import importlib.util
import socket
import struct
import time
from pathlib import Path

import pytest

from srsran_tpu_torch.apps import run_lte_3proc as t_run

REF_PATH = Path(__file__).resolve().parents[1] / "apps" / "run_lte_3proc.py"
WAIT_S = 0.01  # 20x the reference's 0.5 ms read timeout


def frame(body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + body


@pytest.fixture
def pair():
    a, b = socket.socketpair()
    yield a, b
    a.close()
    b.close()


def drain(sock, buf) -> list:
    out = []
    t_run._drain_frames(sock, out, buf)
    return out


# a split after the header, inside the header, inside the body
SPLITS = {"after the header": 4, "inside the header": 2, "inside the body": 4 + 17}


@pytest.mark.parametrize("where", list(SPLITS))
def test_drain_frames_returns_a_split_frame_whole_and_the_next(pair, where):
    tx, rx = pair
    first, second = bytes(range(40)), b"\x5a" * 300
    wire = frame(first) + frame(second)
    cut = SPLITS[where]
    buf = bytearray()
    tx.sendall(wire[:cut])
    time.sleep(WAIT_S)
    assert drain(rx, buf) == []
    assert bytes(buf) == wire[:cut]  # kept for the next call
    tx.sendall(wire[cut:])
    time.sleep(WAIT_S)
    assert drain(rx, buf) == [first, second]
    assert buf == bytearray()


def test_drain_frames_byte_by_byte(pair):
    """A stream that arrives one byte a call: each frame comes out once,
    whole, on the call that completes it."""
    tx, rx = pair
    bodies = [b"", b"\x01", bytes(range(256)) * 3, b"s1ap"]
    wire = b"".join(frame(x) for x in bodies)
    buf, got = bytearray(), []
    for i in range(len(wire)):
        tx.sendall(wire[i : i + 1])
        got += drain(rx, buf)
    assert got == bodies and buf == bytearray()


def test_drain_frames_on_an_empty_and_a_closed_socket(pair):
    """Nothing queued: no frame, no wait.  A closed peer ends the read; the
    frames before the close still come out, a partial one stays."""
    tx, rx = pair
    buf = bytearray()
    t0 = time.perf_counter()
    assert drain(rx, buf) == []
    assert time.perf_counter() - t0 < 0.5
    tx.sendall(frame(b"last") + frame(b"cut short")[:6])
    tx.close()
    time.sleep(WAIT_S)
    assert drain(rx, buf) == [b"last"]
    assert drain(rx, buf) == [] and len(buf) == 6
    assert rx.gettimeout() is None  # left blocking, as the callers expect


def test_mme_proxy_pump_reassembles_a_split_frame(pair):
    """The eNB's S1AP handle keeps its own buffer from one pump to the next."""
    tx, rx = pair
    got = []
    proxy = t_run.MmeProxy(rx)
    proxy.register_enb(0x19B, got.append)
    wire = frame(b"S1SetupResponse") + frame(b"DownlinkNASTransport")
    tx.sendall(wire[:10])
    time.sleep(WAIT_S)
    proxy.pump()
    assert got == []
    tx.sendall(wire[10:])
    time.sleep(WAIT_S)
    proxy.pump()
    assert got == [b"S1SetupResponse", b"DownlinkNASTransport"]


def test_reference_drain_frames_loses_a_frame_split_after_its_header(pair):
    """The fault the port repairs: the reference reads the header, times out
    waiting for the body and drops the four bytes, so the body that follows
    is read as a length and neither frame comes out.  The port returns both
    (`test_drain_frames_returns_a_split_frame_whole_and_the_next`)."""
    spec = importlib.util.spec_from_file_location("ref_run_lte_3proc", REF_PATH)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    tx, rx = pair
    first, second = b"\x00\x00\x00\x02" + b"x" * 36, b"second"
    tx.sendall(frame(first)[:4])
    time.sleep(WAIT_S)
    out = []
    ref._drain_frames(rx, out)
    assert out == []
    tx.sendall(frame(first)[4:] + frame(second))
    time.sleep(WAIT_S)
    ref._drain_frames(rx, out)
    assert out == [b"xx"]  # the body's first four bytes, read as a length
