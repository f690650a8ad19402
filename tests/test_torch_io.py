"""The port's sample I/O (`srsran_tpu_torch/io/`) on the CPU.

- The reference's `tests/test_rf_zmq.py` on the port, with its inputs and
  asserts: the fc32 and sc16 byte layouts, ZOH interpolation and sum
  decimation, the rf_args parser, and real REQ/REP loopbacks through pyzmq
  (decimation gain, leftover buffering, timestamps, timed-TX zero fill, the
  facade and the `Radio` stack over the wire).
- The five I/O cases of `tests/test_resampling_io.py` on the port: the cf32
  file round trip, the bit source, the UDP round trip, the radio's TX gap
  fill and trim, and its channel mapping and RX timestamps.
- The reference's `tests/test_e2e_zmq.py` on the port: the port's eNB and
  UE stacks (`device="cpu"`) attach over the ZMQ fake-RF wire in two
  threads and carry a DL IP packet.
- The reference's `tests/test_tun_e2e.py` on the port: a kernel ICMP ping
  from the UE's TUN in a netns through the port's whole stack to the SPGW's
  SGi TUN.  The test runs in a child process inside a network namespace of
  its own (the SGi side), with the UE's TUN in a second one and its own
  interface names, so that it cannot meet the reference's TUN tests, whose
  SGi interface holds 172.16.0.254/24 in the root namespace.
- The two packages speak one wire: the port's ZMQ transmitter to the
  reference's receiver and back.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu_torch.io import FileSink, FileSource, NetSink, NetSource, binsource
from srsran_tpu_torch.io.rf_zmq import (
    ZmqRf,
    ZmqRfRx,
    ZmqRfTx,
    decode_fc32,
    decode_sc16,
    encode_fc32,
    encode_sc16,
    parse_rf_args,
    sum_decimate,
    zoh_interpolate,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# --- tests/test_rf_zmq.py on the port ---------------------------------------


def test_fc32_byte_layout():
    x = np.array([1.0 + 2.0j, -0.5 + 0.25j], np.complex64)
    b = encode_fc32(x)
    assert b == np.array([1.0, 2.0, -0.5, 0.25], "<f4").tobytes()
    np.testing.assert_array_equal(decode_fc32(b), x)


def test_sc16_byte_layout():
    x = np.array([1.0 + 0.0j, -1.0 + 0.5j], np.complex64)
    b = encode_sc16(x)
    assert np.frombuffer(b, "<i2").tolist() == [32767, 0, -32767, 16384]
    got = decode_sc16(b)
    np.testing.assert_allclose(got, x, atol=1.0 / 32767)


def test_zoh_and_sum_decimation_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100) + 1j * rng.standard_normal(100)).astype(np.complex64)
    for f in (1, 2, 4, 12):
        up = zoh_interpolate(x, f)
        assert len(up) == f * len(x)
        down = sum_decimate(up, f)
        np.testing.assert_allclose(down, f * x, rtol=1e-6)


def test_parse_rf_args_channel_indexing():
    opts = parse_rf_args(
        "tx_port=tcp://*:2000,rx_port=tcp://localhost:2001,"
        "rx_port1=tcp://localhost:2101,id=enb,base_srate=23040000")
    assert opts["tx_port"] == "tcp://*:2000"
    assert opts["rx_port1"] == "tcp://localhost:2101"
    assert opts["id"] == "enb"
    assert int(opts["base_srate"]) == 23040000


@pytest.fixture
def port_pair():
    port = _free_port()
    return f"tcp://*:{port}", f"tcp://localhost:{port}"


def test_loopback_req_rep_with_decimation(port_pair):
    bind, conn = port_pair
    base = 1920000 * 4
    tx = ZmqRfTx(bind, base_srate=base, srate=1920000)
    rx = ZmqRfRx(conn, base_srate=base, srate=1920000)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300)).astype(np.complex64)
    err = []

    def sender():
        try:
            tx.send(x)
        except Exception as e:  # surface in main thread
            err.append(e)

    t = threading.Thread(target=sender)
    t.start()
    got, ts = rx.recv(200)
    t.join()
    assert not err
    assert ts == 0
    np.testing.assert_allclose(got, 4 * x[:200], rtol=1e-5)
    got2, ts2 = rx.recv(100)
    assert ts2 == 200 * 4
    np.testing.assert_allclose(got2, 4 * x[200:], rtol=1e-5)


def test_loopback_timed_tx_gap_alignment(port_pair):
    bind, conn = port_pair
    tx = ZmqRfTx(bind, base_srate=1000, srate=1000)
    rx = ZmqRfRx(conn, base_srate=1000, srate=1000)
    x = np.ones(50, np.complex64)
    t = threading.Thread(target=lambda: tx.send(x, timestamp=80))
    t.start()
    got, _ = rx.recv(130)
    t.join()
    np.testing.assert_array_equal(got[:80], np.zeros(80, np.complex64))
    np.testing.assert_allclose(got[80:], x)
    assert tx.nsamples == 130


def test_loopback_sc16_format(port_pair):
    bind, conn = port_pair
    tx = ZmqRfTx(bind, base_srate=1000, srate=1000, fmt="sc16")
    rx = ZmqRfRx(conn, base_srate=1000, srate=1000, fmt="sc16")
    rng = np.random.default_rng(2)
    x = (0.9 * (rng.uniform(-1, 1, 64) + 1j * rng.uniform(-1, 1, 64))).astype(np.complex64)
    t = threading.Thread(target=lambda: tx.send(x))
    t.start()
    got, _ = rx.recv(64)
    t.join()
    np.testing.assert_allclose(got, x, rtol=0, atol=2.0 / 32767)


def test_zmq_rf_facade(port_pair):
    bind, conn = port_pair
    rf_enb = ZmqRf(f"tx_port={bind},id=enb,base_srate=1920000")
    rf_ue = ZmqRf(f"rx_port={conn},id=ue,base_srate=1920000")
    rf_enb.set_srate(960000)
    rf_ue.set_srate(960000)
    assert rf_enb.tx[0].decim_factor == 2
    x = np.full(10, 1 + 1j, np.complex64)
    t = threading.Thread(target=lambda: rf_enb.tx[0].send(x))
    t.start()
    got, _ = rf_ue.rx[0].recv(10)
    t.join()
    np.testing.assert_allclose(got, 2 * x)
    rf_enb.close()
    rf_ue.close()


def test_zmq_radio_stack(port_pair):
    from srsran_tpu_torch.io.rf_zmq import zmq_radio

    bind, conn = port_pair
    enb = zmq_radio(f"tx_port={bind},base_srate=1920000", srate_hz=1.92e6)
    ue = zmq_radio(f"rx_port={conn},base_srate=1920000", srate_hz=1.92e6)
    x = (np.arange(1920) % 7 / 7.0 + 0.5j).astype(np.complex64)

    def sender():
        enb.tx(x, timestamp=0.0)
        enb.tx(x, timestamp=0.001)

    t = threading.Thread(target=sender)
    t.start()
    got = ue.source.read(3840)
    t.join()
    np.testing.assert_allclose(got[:1920], x, atol=1e-6)
    np.testing.assert_allclose(got[1920:], x, atol=1e-6)
    enb.rf.close()
    ue.rf.close()


@pytest.mark.parametrize("tx_pkg", ["port", "reference"])
def test_the_two_packages_speak_one_wire(port_pair, tx_pkg):
    """One package's transmitter, the other's receiver: the same samples."""
    import srsran_tpu.io.rf_zmq as r_zmq
    import srsran_tpu_torch.io.rf_zmq as t_zmq

    tx_mod, rx_mod = (t_zmq, r_zmq) if tx_pkg == "port" else (r_zmq, t_zmq)
    bind, conn = port_pair
    tx = tx_mod.ZmqRfTx(bind, base_srate=3840000, srate=1920000)
    rx = rx_mod.ZmqRfRx(conn, base_srate=3840000, srate=1920000)
    x = (np.random.default_rng(4).standard_normal(500) * (1 - 1j)).astype(np.complex64)
    t = threading.Thread(target=lambda: tx.send(x, timestamp=80))  # base-rate samples
    t.start()
    got, ts = rx.recv(540)
    t.join()
    assert ts == 0 and tx.nsamples == 1080
    np.testing.assert_array_equal(got[:40], 0)
    np.testing.assert_allclose(got[40:], 2 * x, rtol=1e-6)
    assert t_zmq.encode_fc32(x) == r_zmq.encode_fc32(x)
    assert t_zmq.encode_sc16(0.5 * x) == r_zmq.encode_sc16(0.5 * x)
    tx.close()
    rx.close()


# --- the I/O cases of tests/test_resampling_io.py on the port ----------------


def test_file_roundtrip(tmp_path):
    p = str(tmp_path / "iq.bin")
    rng = np.random.default_rng(1)
    data = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64)
    with FileSink(p) as sink:
        sink.write(data)
    src = FileSource(p)
    got = src.read(1000)
    np.testing.assert_array_equal(got, data)
    src2 = FileSource(p, repeat=True)
    got2 = src2.read(1500)
    np.testing.assert_array_equal(got2[1000:], data[:500])


def test_binsource_deterministic():
    a, b = binsource(5, 100), binsource(5, 100)
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) <= {0, 1}


def test_net_udp_roundtrip():
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    src = NetSource("127.0.0.1", port, "udp")
    sink = NetSink("127.0.0.1", port, "udp")
    data = (np.arange(2048) + 1j * np.arange(2048)).astype(np.complex64)
    tx = threading.Thread(target=lambda: sink.write(data))
    tx.start()
    got = src.read(2048)
    tx.join()
    np.testing.assert_array_equal(got, data)
    sink.close()
    src.close()


class _MemSink:
    def __init__(self):
        self.data = []

    def write(self, samples):
        self.data.append(np.asarray(samples, np.complex64))

    def all(self):
        return np.concatenate(self.data) if self.data else np.zeros(0, np.complex64)


def test_radio_tx_gap_fill_and_trim():
    from srsran_tpu_torch.io.radio import Radio

    sink = _MemSink()
    r = Radio(sink, srate_hz=1000.0, tx_max_gap=0.5)
    a = np.ones(100, np.complex64)
    assert r.tx(a, timestamp=1.0)
    assert r.tx(a * 2, timestamp=1.15)
    out = sink.all()
    assert len(out) == 250
    assert np.all(out[:100] == 1) and np.all(out[100:150] == 0) and np.all(out[150:] == 2)
    assert r.stats["gap_zeros"] == 50
    assert r.tx(a * 3, timestamp=1.25 - 0.03)
    out = sink.all()
    assert len(out) == 250 + 70
    assert np.all(out[250:] == 3)
    assert r.stats["trimmed"] == 30
    assert r.tx(a, timestamp=0.0)
    assert len(sink.all()) == 320 and r.stats["late"] == 1
    assert r.tx(a * 4, timestamp=10.0)
    out = sink.all()
    assert len(out) == 420 and r.stats["burst_ends"] == 1
    assert np.all(out[320:] == 4)


def test_radio_channel_mapping_and_rx_timestamps():
    from srsran_tpu_torch.io.radio import ChannelMapping, Radio

    m = ChannelMapping(2)
    assert m.allocate_freq(5, 2.4e9) and m.allocate_freq(9, 3.5e9)
    assert not m.allocate_freq(7, 1e9)
    assert m.get_device_mapping(5) == 0 and m.get_device_mapping(9) == 1
    assert m.release_freq(5) and not m.is_allocated(5)
    assert m.allocate_freq(7, 1e9) and m.get_device_mapping(7) == 0

    class _Src:
        def __init__(self):
            self.n = 0

        def read(self, n):
            self.n += n
            return np.zeros(n, np.complex64)

    s0, s1 = _MemSink(), _MemSink()
    r = Radio([s0, s1], source=_Src(), srate_hz=100.0)
    r.mapping.allocate_freq(3, 1e9)
    r.mapping.allocate_freq(8, 2e9)
    r.tx(np.ones(10, np.complex64), 0.0, logical_ch=8)
    assert len(s1.all()) == 10 and len(s0.all()) == 0
    _, t0 = r.rx_now(100)
    _, t1 = r.rx_now(100)
    assert t0 == 0.0 and abs(t1 - 1.0) < 1e-9


# --- tests/test_e2e_zmq.py on the port ---------------------------------------


def _stack_modules():
    from srsran_tpu_torch.apps.full_stack import EnbStack, UeStack
    from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.stack import security as sec
    from srsran_tpu_torch.stack.nas_ue import Usim

    opc = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    return EnbStack, UeStack, Hss, Mme, Spgw, Subscriber, Cell, Usim, opc


def test_attach_and_traffic_over_zmq_wire():
    """The port's stacks on the CPU in two threads, joined only by the
    reference's REQ/REP sample protocol; each subframe is read to numpy at
    its socket and goes back to a tensor at the other end."""
    from srsran_tpu_torch.device import as_samples

    EnbStack, UeStack, Hss, Mme, Spgw, Subscriber, Cell, Usim, opc = _stack_modules()
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    sf_len = cell.sf_len
    srate = int(cell.srate)
    dl_port, ul_port = _free_port(), _free_port()

    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, opc, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5, device=CPU)
    ue = UeStack(cell, Usim(IMSI, KEY, opc), device=CPU)

    T = 120000
    enb_tx = ZmqRfTx(f"tcp://*:{dl_port}", base_srate=srate, srate=srate, timeout_ms=T)
    enb_rx = ZmqRfRx(f"tcp://localhost:{ul_port}", base_srate=srate, srate=srate, timeout_ms=T)
    ue_tx = ZmqRfTx(f"tcp://*:{ul_port}", base_srate=srate, srate=srate, timeout_ms=T)
    ue_rx = ZmqRfRx(f"tcp://localhost:{dl_port}", base_srate=srate, srate=srate, timeout_ms=T)

    N = 160
    errors = []
    dl_done = threading.Event()

    def enb_loop():
        try:
            ul = None
            for _ in range(N):
                dl = enb.run_tti(None if ul is None else as_samples(ul, enb.device))
                enb_tx.send(dl.numpy())
                ul, _ts = enb_rx.recv(sf_len)
        except Exception as e:  # surface in the main thread
            errors.append(e)
        finally:
            dl_done.set()

    def ue_loop():
        try:
            for _ in range(N):
                dl, _ts = ue_rx.recv(sf_len)
                ul = ue.run_tti(as_samples(dl, ue.device))
                ue_tx.send(np.zeros(sf_len, np.complex64) if ul is None else ul.numpy())
        except Exception as e:
            errors.append(e)

    te = threading.Thread(target=enb_loop)
    tu = threading.Thread(target=ue_loop)
    te.start()
    tu.start()
    for _ in range(600):
        if ue.nas.state == ue.nas.REGISTERED and ue.ue_ip:
            spgw.sgi_tx(ue.ue_ip, b"\x5a" * 40)
            break
        threading.Event().wait(0.05)
        if dl_done.is_set():
            break
    te.join(timeout=120)
    tu.join(timeout=120)
    assert not errors, errors
    assert ue.nas.state == ue.nas.REGISTERED, "attach over the wire failed"
    assert ue.rrc_state == UeStack.RRC_ACTIVE
    assert ue.ip_rx == [b"\x5a" * 40], "DL user-plane packet lost"
    for s in (enb_tx, enb_rx, ue_tx, ue_rx):
        s.close()


# --- tests/test_tun_e2e.py on the port ---------------------------------------

# the SGi side runs in a namespace of its own and the UE's TUN in another, both
# of this run (`tun_namespaces`), so that the interfaces (`tun_sgi_pt0`,
# `tun_ue_pt0`) and 172.16.0.254/24 never meet the reference tests' in the root one
_TUN_PING = textwrap.dedent('''
    import json, subprocess, sys, time
    import torch
    torch.set_num_threads(1)
    from srsran_tpu_torch.apps.full_stack import EnbStack, UeStack
    from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.stack import security as sec
    from srsran_tpu_torch.stack.nas_ue import Usim

    IMSI, KEY = "001010123456789", bytes.fromhex("00112233445566778899aabbccddeeff")
    OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    ue_ns = sys.argv[1]
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\\x80\\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5, device="cpu")
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), device="cpu")
    ul = None
    for _ in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED:
            break
    assert ue.nas.state == ue.nas.REGISTERED
    try:
        spgw.attach_tun(name="tun_sgi_pt0")
        gw = ue.attach_tun(name="tun_ue_pt0", netns=ue_ns)
        gw.tun.add_route("default")
        ping = subprocess.Popen(
            ["ip", "netns", "exec", ue_ns, sys.executable, "-m",
             "srsran_tpu_torch.io.icmp_ping", "172.16.0.254", "3", "30"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        deadline = time.time() + 60
        while ping.poll() is None and time.time() < deadline:
            dl = enb.run_tti(ul)
            ul = ue.run_tti(dl)
            spgw.pump_tun()
        out, _ = ping.communicate(timeout=10)
    finally:
        if ue.gw:
            ue.gw.close()
        if spgw.sgi_tun is not None:
            spgw.sgi_tun.close()
    print(json.dumps({"rc": ping.returncode, "out": out}))
''')


def del_netns(*names: str):
    for ns in names:
        subprocess.run(["ip", "netns", "del", ns], capture_output=True)


def tun_ok(ns: str) -> bool:
    """`TunDevice.available()` asked inside the namespace `ns`: its probe
    interface (`tunprobe0`) exists there alone, where in the root namespace
    two probes at once make one of them report no TUN."""
    code = ("import sys; from srsran_tpu_torch.io.tun import TunDevice; "
            "sys.exit(0 if TunDevice.available() else 1)")
    return subprocess.run(["ip", "netns", "exec", ns, sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT))).returncode == 0


def netns_name(tag: str) -> str:
    """A namespace name of this run alone (`srstpu_<tag>_<random>`): two test
    runs on one machine never meet in `/run/netns`, nor meet the reference
    tests' `srstpu_test` and `srstpu_3p`."""
    return f"srstpu_{tag}_{uuid.uuid4().hex[:8]}"


def tun_namespaces(*tags: str) -> list[str]:
    """New namespaces of this run, one per tag, loopback up and TUN in the
    first, or a skip with the reference tests' reasons.  Only namespaces
    created here are deleted, by `del_netns` once the test is done."""
    if os.geteuid() != 0 or shutil.which("ip") is None:
        pytest.skip("cannot create network namespaces")
    names = []
    try:
        for tag in tags:
            ns = netns_name(tag)
            if subprocess.run(["ip", "netns", "add", ns], capture_output=True).returncode != 0:
                pytest.skip("cannot create network namespaces")
            names.append(ns)
            subprocess.run(["ip", "netns", "exec", ns, "ip", "link", "set", "lo", "up"],
                           check=True)
        if not tun_ok(names[0]):
            pytest.skip("no TUN in this environment")
    except BaseException:
        del_netns(*names)
        raise
    return names


def test_kernel_ping_through_stack():
    epc_ns, ue_ns = tun_namespaces("pt_epc", "pt_ue")
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        p = subprocess.run(["ip", "netns", "exec", epc_ns, sys.executable, "-c", _TUN_PING, ue_ns],
                           capture_output=True, text=True, cwd=ROOT, env=env, timeout=180)
        assert p.returncode == 0, p.stdout + p.stderr
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["rc"] == 0, f"kernel ping failed:\n{res['out']}"
        assert " 0% packet loss" in res["out"], res["out"]
    finally:
        del_netns(epc_ns, ue_ns)
