"""The port's runtime layer (`srsran_tpu_torch/runtime/`) and operator config
plane against the reference's on the CPU.

- The reference's `tests/test_runtime.py` on the port, with its inputs and
  asserts: INI config and overrides, the logger's levels and hex dumps, the
  metrics hub with stdout and CSV listeners, the MAC pcap format and the
  NAS/S1AP/RLC variants, the `UeSync` checkpoint and resume (the port's
  sync on the CPU), the state file's types, the plots and the crash
  handler.
- The reference's `tests/test_enb_cfg.py` on the port: the libconfig
  parser, the example files, and `make_enb` booting the port's `EnbStack`
  (`device="cpu"`) whose broadcast SIBs a SI-acquiring port UE decodes.
- Between the packages, for the same calls: log lines, pcap files, CSV
  metrics, trace events and `.npz` state files are byte-identical (the
  clock pinned); a `UeSync` snapshot of either package restores into the
  other and the resumed subframes equal the uninterrupted run's within
  2e-6 of their largest magnitude, with the same subframe indices; and
  `convert.from_reference` turns the reference's `AppConfig` and
  `EnbConfig` into the port's equal ones.
"""

import io
import json
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import srsran_tpu.runtime as r_rt
import srsran_tpu.runtime.logger as r_logger
import srsran_tpu.runtime.pcap as r_pcap
import srsran_tpu.runtime.state as r_state
import srsran_tpu.runtime.trace as r_trace
import srsran_tpu_torch.runtime as t_rt
import srsran_tpu_torch.runtime.logger as t_logger
import srsran_tpu_torch.runtime.pcap as t_pcap
import srsran_tpu_torch.runtime.state as t_state
import srsran_tpu_torch.runtime.trace as t_trace
from srsran_tpu_torch.runtime import (
    AppConfig,
    CsvMetrics,
    Logger,
    MacPcap,
    MetricsHub,
    StdoutMetrics,
    load_config,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
T_FIXED = 1700000000.25


# --- tests/test_runtime.py on the port -------------------------------------


def test_config_ini_and_overrides(tmp_path):
    ini = tmp_path / "ue.conf"
    ini.write_text(
        """
[rf]
srate_hz = 15.36e6
device = udp

[phy]
nof_prb = 50
cell_id = 301

[pcap]
enable = true
"""
    )
    cfg = load_config(str(ini), overrides=["phy.cfi=3", "rnti=0x5A"])
    assert cfg.rf.srate_hz == 15.36e6
    assert cfg.rf.device == "udp"
    assert cfg.phy.nof_prb == 50 and cfg.phy.cell_id == 301
    assert cfg.phy.cfi == 3
    assert cfg.pcap.enable is True
    assert cfg.rnti == 0x5A


def test_config_defaults():
    cfg = load_config()
    assert cfg.phy.nof_prb == 6
    assert isinstance(cfg, AppConfig)


def test_logger_levels_and_hex():
    log = Logger("test", level="info")
    sink = io.StringIO()
    log._b.sinks = [sink]
    log.debug("should not appear")
    log.info("hello", hexdata=b"\x01\x02\xff")
    log.error("bad thing")
    t_logger.flush()
    out = sink.getvalue()
    assert "hello" in out and "01 02 ff" in out and "bad thing" in out
    assert "should not appear" not in out


def test_metrics_hub_and_csv(tmp_path):
    hub = MetricsHub()
    hub.add_producer(lambda: {"dl_mbps": 42.5, "bler": 0.01})
    out = io.StringIO()
    hub.add_listener(StdoutMetrics(out=out))
    csv_path = str(tmp_path / "m.csv")
    c = CsvMetrics(csv_path)
    hub.add_listener(c)
    m = hub.poll_once()
    m = hub.poll_once()
    assert m["dl_mbps"] == 42.5
    assert "dl_mbps" in out.getvalue()
    c.close()
    lines = open(csv_path).read().strip().splitlines()
    assert len(lines) == 3 and "dl_mbps" in lines[0]


def test_mac_pcap_format(tmp_path):
    p = str(tmp_path / "mac.pcap")
    with MacPcap(p, ue_id=1) as pc:
        pc.write_pdu(b"\x21\x08\x22" + b"\x00" * 10, rnti=0x46, sfn=100, sf_idx=3)
    data = open(p, "rb").read()
    magic, vmaj, vmin, _, _, snaplen, dlt = struct.unpack("<IHHiIII", data[:24])
    assert magic == 0xA1B2C3D4 and dlt == 147
    ts, tus, incl, orig = struct.unpack("<IIII", data[24:40])
    pkt = data[40 : 40 + incl]
    assert pkt[0] == 1  # FDD
    assert pkt[1] == 1  # downlink
    assert pkt[2] == 3  # C-RNTI
    assert pkt[3] == 0x02 and struct.unpack(">H", pkt[4:6])[0] == 0x46
    idx = pkt.index(b"\x04", 6)
    fsf = struct.unpack(">H", pkt[idx + 1 : idx + 3])[0]
    assert fsf == (100 << 4) | 3
    assert pkt.endswith(b"\x01" + b"\x21\x08\x22" + b"\x00" * 10)


def _port_stream() -> np.ndarray:
    """30 subframes of the 6 PRB cell 11 (the reference test's stream),
    rendered by the port on the CPU, as numpy."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.enb.enb_dl import DlSched, enb_dl_subframe
    from srsran_tpu_torch.phy.phch.pbch import Mib

    cell = Cell(nof_prb=6, nof_ports=1, id=11)
    mib = Mib(nof_prb=6)
    return np.concatenate([
        enb_dl_subframe(cell, t % 10, DlSched(cfi=1), mib=mib, sfn=t // 10, device=CPU)[1][0].numpy()
        for t in range(30)])


def _pushed(sync, samples):
    sync.push(samples)
    return sync


def _pop_all(sync) -> list:
    out = []
    while (o := sync.pop_subframe()) is not None:
        s, i = o
        out.append((np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s), i))
    return out


def test_checkpoint_resume_ue_sync(tmp_path):
    """SURVEY §5.4 on the port: stop the sync mid-stream, snapshot, restore
    into a fresh instance, and get bit-identical subframes against an
    uninterrupted run."""
    from srsran_tpu_torch.phy.ue.ue_sync import UeSync

    stream = _port_stream()
    ref_out = _pop_all(_pushed(UeSync(nof_prb=6, device=CPU), stream))
    half = len(stream) // 2
    a = _pushed(UeSync(nof_prb=6, device=CPU), stream[:half])
    out = _pop_all(a)
    p = str(tmp_path / "sync_state.npz")
    t_state.save_state(p, {"sync": t_state.ue_sync_state(a)})
    b = t_state.restore_ue_sync(UeSync(nof_prb=6, device=CPU), t_state.load_state(p)["sync"])
    assert b.buf.device == torch.device(CPU) and b.buf.dtype == torch.complex64
    out += _pop_all(_pushed(b, stream[half:]))
    assert len(out) == len(ref_out)
    for (sa, ia), (sb, ib) in zip(out, ref_out):
        assert ia == ib
        np.testing.assert_array_equal(sa, sb)


def test_state_roundtrip_types(tmp_path):
    st = {
        "a": np.arange(5, dtype=np.float32),
        "nested": {"s": "hello", "n": 3, "f": 1.5, "flag": True, "lst": [1, 2]},
    }
    p = str(tmp_path / "st.npz")
    t_state.save_state(p, st)
    back = t_state.load_state(p)
    np.testing.assert_array_equal(back["a"], st["a"])
    assert back["nested"] == st["nested"]


def test_pcap_variants(tmp_path):
    for cls, dlt in ((t_pcap.NasPcap, 148), (t_pcap.S1apPcap, 150), (t_pcap.RlcPcap, 149)):
        p = str(tmp_path / f"{cls.__name__}.pcap")
        w = cls(p)
        w.write_pdu(b"\x07\x41\x01")
        w.close()
        raw = open(p, "rb").read()
        magic, _, _, _, _, _, network = struct.unpack("<IHHiIII", raw[:24])
        assert magic == 0xA1B2C3D4 and network == dlt
        assert len(raw) > 24 + 16


def test_plots_render(tmp_path):
    from srsran_tpu_torch.runtime.plots import LiveScope, plot_channel, plot_constellation, plot_psd

    rng = np.random.default_rng(0)
    qpsk = (rng.choice([-1, 1], 500) + 1j * rng.choice([-1, 1], 500)) / np.sqrt(2)
    sym = qpsk + (rng.standard_normal(500) + 1j * rng.standard_normal(500)) * 0.05
    p1 = plot_constellation(sym, str(tmp_path / "const.png"))
    ce = 1.0 + 0.3 * np.exp(-2j * np.pi * np.arange(600) * 5 / 1024)
    p2 = plot_channel(ce[None, :], str(tmp_path / "chan.png"))
    x = np.exp(2j * np.pi * 0.1 * np.arange(8192)).astype(np.complex64)
    p3 = plot_psd(x, 1.92e6, str(tmp_path / "psd.png"))
    for p in (p1, p2, p3):
        data = open(p, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 2000

    scope = LiveScope(str(tmp_path / "live.png"), period_s=0.0)
    assert scope.update(sym)
    scope.period_s = 100.0
    assert not scope.update(sym)  # rate-limited
    assert scope.frames == 1


def test_crash_handler_writes_backtrace(tmp_path):
    crash = tmp_path / "bt.crash"
    code = (
        "from srsran_tpu_torch.runtime import crash\n"
        f"crash.enable({str(crash)!r})\n"
        "raise RuntimeError('boom-for-test')\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0
    content = crash.read_text()
    assert "srsran_tpu crashed" in content
    assert "boom-for-test" in content and "RuntimeError" in content


# --- tests/test_enb_cfg.py on the port ------------------------------------

RR = str(ROOT / "apps/configs/rr.conf.example")
SIB = str(ROOT / "apps/configs/sib.conf.example")
DRB = str(ROOT / "apps/configs/drb.conf.example")
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")


def test_libconfig_parser_syntax():
    from srsran_tpu_torch.runtime.enb_cfg import parse_libconfig

    cfg = parse_libconfig("""
    // comment
    top = { a = 0x10; b = -3.5; c = "str"; d = true; /* block */
            e = [1, 2, 3]; };
    lst = ( { x = 1; }, { x = 2; } );
    bare = 7;
    """)
    assert cfg["top"] == {"a": 16, "b": -3.5, "c": "str", "d": True, "e": [1, 2, 3]}
    assert [e["x"] for e in cfg["lst"]] == [1, 2]
    assert cfg["bare"] == 7


def test_example_files_parse():
    from srsran_tpu_torch.runtime.enb_cfg import EnbConfig

    cfg = EnbConfig.load(RR, SIB, DRB)
    cell = cfg.cells[0]
    assert cell["cell_id"] == 0x1A and cell["pci"] == 7
    assert cell["tac"] == 7 and cell["dl_earfcn"] == 3400
    assert cell["meas_cell_list"][0]["eci"] == 0x19C02
    assert cfg.sib["sib1"]["sched_info"][0]["si_mapping_info"] == [3]
    q9 = cfg.qci_config(9)
    assert q9["rlc_config"]["ul_am"]["t_poll_retx"] == 120
    assert q9["logical_channel_config"]["priority"] == 11


def test_config_boots_cell_and_ue_acquires_it():
    """make_enb on the port's EnbStack (CPU): the configured cell broadcasts
    SIBs that a SI-acquiring port UE decodes; attach completes and the
    decoded SI matches the files."""
    from srsran_tpu_torch.apps.full_stack import UeStack
    from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu_torch.runtime.enb_cfg import EnbConfig, make_enb
    from srsran_tpu_torch.stack import security as sec
    from srsran_tpu_torch.stack.nas_ue import Usim

    opc = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    cfg = EnbConfig.load(RR, SIB, DRB)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, opc, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_enb(cfg, mme, spgw, nof_prb=15)  # the card by default
    enb = make_enb(cfg, mme, spgw, nof_prb=15, device=CPU)
    assert enb.device == torch.device(CPU)
    assert enb.cell.id == 7
    assert enb.enb_id == 0x1A
    assert enb.earfcn == 3400
    assert enb.s1_neighbors == {2: 0x19C02 >> 8}
    assert enb.prach_cfg.root_seq_index == 128
    assert enb.prach_cfg.freq_offset == 2

    ue = UeStack(enb.cell, Usim(IMSI, KEY, opc), acquire_si=True, device=CPU)
    ul = None
    for tti in range(250):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED:
            break
    assert ue.nas.state == ue.nas.REGISTERED

    info = ue.sib1["cell_access_related_info"]
    assert info["tac"] == 7
    assert info["cell_id"] == (0x1A << 8) | 7
    assert ue.sib1["sched_info_list"][0]["si_periodicity"] == "rf16"
    prach = ue.sib2["rr_cfg_common"]["prach_cfg"]
    assert prach["root_seq_idx"] == 128
    assert prach["prach_cfg_info"]["prach_freq_offset"] == 2
    assert ue.sib2["rr_cfg_common"]["rach_cfg_common"]["preamb_info"]["nof_ra_preambs"] == "n52"
    assert ue.sib3_params is not None
    assert ue.sib3_params["q_rx_lev_min_dbm"] == 2 * -61


# --- the two packages side by side ------------------------------------------


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T_FIXED)
    monkeypatch.setattr(time, "perf_counter", lambda: 12.5)


def test_log_lines_are_identical(fixed_clock):
    outs = []
    for mod in (r_logger, t_logger):
        log = mod.Logger("CMP", level="debug", hex_limit=4)
        sink = io.StringIO()
        sinks, log._b.sinks = log._b.sinks, [sink]
        try:
            log.debug("dbg 1")
            log.info("with hex", hexdata=bytes(range(10)))
            log.warning("warn")
            log.error("err", hexdata=b"\xff")
            mod.flush()
            time.sleep(0.05)
        finally:
            log._b.sinks = sinks
        outs.append(sink.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") == 6
    assert f"{T_FIXED:.6f} [CMP  ] [I] with hex\n  00 01 02 03\n" in outs[1]


def _pcap_calls(mod, d: Path):
    with mod.MacPcap(str(d / "mac.pcap"), ue_id=3) as pc:
        pc.write_pdu(b"\x3d\x21" + bytes(range(20)), rnti=0x46, sfn=511, sf_idx=9, crc_ok=False,
                     direction=mod.DIRECTION_UPLINK, cc_idx=1)
        pc.write_pdu(b"", rnti=0xFFFF, rnti_type=mod.SI_RNTI)
    for cls, args, kw in ((mod.NasPcap, (b"\x07\x41",), {}), (mod.S1apPcap, (b"\x00\x0c\x40",), {}),
                          (mod.RlcPcap, (b"\x80\x01\x02",), dict(mode=2, direction=0, lcid=3,
                                                                  sn_bits=5))):
        w = cls(str(d / f"{cls.__name__}.pcap"))
        w.write_pdu(*args, **kw)
        w.close()


def test_pcap_files_are_identical(tmp_path, fixed_clock):
    for pkg in ("r", "t"):
        (tmp_path / pkg).mkdir()
    _pcap_calls(r_pcap, tmp_path / "r")
    _pcap_calls(t_pcap, tmp_path / "t")
    names = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert len(names) == 4
    for name in names:
        assert (tmp_path / "r" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name


def test_csv_and_stdout_metrics_are_identical(tmp_path, fixed_clock):
    outs = []
    for rt in (r_rt, t_rt):
        hub = rt.MetricsHub()
        hub.add_producer(lambda: {"dl_mbps": 42.5, "bler": 0.01, "ues": 2})
        hub.add_producer(lambda: {"state": "TRACK", "cfo": -1.25e-3})
        text = io.StringIO()
        hub.add_listener(rt.StdoutMetrics(out=text))
        path = tmp_path / f"{rt.__name__}.csv"
        c = rt.CsvMetrics(str(path))
        hub.add_listener(c)
        for _ in range(12):
            hub.poll_once()
        c.close()
        outs.append((path.read_bytes(), text.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0].count(b"\n") == 13


def test_trace_events_are_identical(tmp_path, fixed_clock):
    outs = []
    for mod in (r_trace, t_trace):
        tr = mod.EventTracer()
        with tr.duration("off"):
            pass
        tr.enable()
        with tr.duration("decode", "phy", tti=3):
            tr.instant("crc", ok=True)
        tr.counter("queue", depth=4)

        @tr.traced("wrapped", "mac")
        def f(x):
            return x + 1

        assert f(1) == 2
        path = tmp_path / f"{mod.__name__}.json"
        tr.save(str(path))
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    ev = json.loads(outs[1])["traceEvents"]
    assert [e["name"] for e in ev] == ["crc", "decode", "queue", "wrapped"]


def test_state_files_are_identical(tmp_path):
    st = {"a": np.arange(7, dtype=np.int16), "c": (np.arange(4) * 1j).astype(np.complex64),
          "nested": {"s": "x", "n": -3, "f": 2.5, "flag": False, "lst": [1, "two"], "none": None}}
    r_state.save_state(str(tmp_path / "r.npz"), st)
    t_state.save_state(str(tmp_path / "t.npz"), st)
    assert (tmp_path / "r.npz").read_bytes() == (tmp_path / "t.npz").read_bytes()
    assert t_state.load_state(str(tmp_path / "r.npz"))["nested"] == r_state.load_state(
        str(tmp_path / "t.npz"))["nested"]


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_ue_sync_snapshot_crosses_packages(tmp_path, direction):
    """A snapshot taken from one package's `UeSync` mid-stream, saved to one
    `.npz` and restored into the other package's: the resumed subframes
    equal that package's uninterrupted run within 2e-6 of their largest
    magnitude, with the same subframe indices; the two packages' snapshots
    after the same pushes have the same keys, dtypes and buffer bytes."""
    from srsran_tpu.phy.ue.ue_sync import UeSync as RSync
    from srsran_tpu_torch.phy.ue.ue_sync import UeSync as TSync

    stream = _port_stream()
    half = len(stream) // 2
    syncs = {"reference": (lambda: RSync(nof_prb=6), r_state),
             "port": (lambda: TSync(nof_prb=6, device=CPU), t_state)}
    src, dst = direction.split("->")
    make_src, st_src = syncs[src]
    make_dst, st_dst = syncs[dst]

    a = _pushed(make_src(), stream[:half])
    out = _pop_all(a)
    # the other package after the same pushes: the same snapshot layout and buffer
    twin = _pushed(make_dst(), stream[:half])
    twin_out = _pop_all(twin)
    snap, twin_snap = st_src.ue_sync_state(a), st_dst.ue_sync_state(twin)
    assert snap.keys() == twin_snap.keys()
    assert snap["buf"].dtype == twin_snap["buf"].dtype == np.float32
    assert snap["buf"].tobytes() == twin_snap["buf"].tobytes()
    assert [i for _, i in out] == [i for _, i in twin_out]
    assert (snap["state"], snap["sf_idx"], snap["consumed"], snap["cell_id"]) == (
        twin_snap["state"], twin_snap["sf_idx"], twin_snap["consumed"], twin_snap["cell_id"])

    path = str(tmp_path / "sync.npz")
    st_src.save_state(path, {"sync": snap})
    b = st_dst.restore_ue_sync(make_dst(), st_dst.load_state(path)["sync"])
    resumed = _pop_all(_pushed(b, stream[half:]))
    whole = _pop_all(_pushed(make_dst(), stream))
    got = twin_out + resumed
    assert [i for _, i in got] == [i for _, i in whole]
    for (sa, _), (sb, _) in zip(got, whole):
        np.testing.assert_allclose(sa, sb, rtol=0, atol=2e-6 * np.abs(sb).max())


def test_from_reference_takes_app_and_operator_configs(tmp_path):
    from srsran_tpu.runtime.enb_cfg import EnbConfig as REnbConfig
    from srsran_tpu_torch.convert import from_reference
    from srsran_tpu_torch.runtime.enb_cfg import EnbConfig

    ini = tmp_path / "enb.conf"
    ini.write_text("[phy]\nnof_prb = 100\ncell_id = 301\n[expert]\npdsch_max_its = 3\n")
    over = ["phy.cfi=2", "pcap.enable=true", "rnti=0x47"]
    got = from_reference(r_rt.load_config(str(ini), overrides=over))
    assert type(got) is AppConfig and got == load_config(str(ini), overrides=over)
    assert got.phy.nof_prb == 100 and got.expert.pdsch_max_its == 3 and got.rnti == 0x47
    ref = REnbConfig.load(RR, SIB, DRB)
    op = from_reference(ref)
    assert type(op) is EnbConfig and op == EnbConfig.load(RR, SIB, DRB)
    op.rr["cell_list"][0]["pci"] = 99  # a copy, not the reference's dicts
    assert ref.cells[0]["pci"] == 7
