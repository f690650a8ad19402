"""The port's in-process apps (`srsran_tpu_torch/apps/{enb,ue}.py`), its MAC
PDU copy and `chip_smoke.py`'s phases 22-24 against the JAX reference on
the CPU.

Checks: `mac_pack` / `mac_unpack` bytes identical to the reference's; the
ping loop of `tests/test_e2e_apps.py` through the port's apps (every
message back in order, every TB CRC-clean); two crossings — the reference's
`EnbApp` samples into the port's `UeApp` and the port's `EnbApp` samples
into the reference's `UeApp` — deliver the messages the same way; the port's
`EnbApp` samples equal the reference's within 2e-6.  Phase 22 (the golden
vectors) runs as on the card; phase 23 at 25 PRB over 2 frames rendered by
the reference here (its checks: cell search, MIB, popped indices, CFI,
DCIs, TBs and CRC identical, cfo within 1e-4, psr within 1e-4 relative,
snr_db within 1e-3 dB); phase 24's link at 25 PRB over 2 frames with its
own checks.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu.apps.enb import EnbApp as REnbApp
from srsran_tpu.apps.ue import UeApp as RUeApp
from srsran_tpu.phy.common import Cell
import srsran_tpu.stack.mac_pdu as r_mac
from srsran_tpu_torch.apps.enb import EnbApp as TEnbApp
from srsran_tpu_torch.apps.ue import UeApp as TUeApp
from srsran_tpu_torch.convert import from_reference
import srsran_tpu_torch.stack.mac_pdu as t_mac

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = load("chip_smoke", ROOT / "chip_smoke.py")


def test_mac_pack_unpack():
    rng = np.random.default_rng(0)
    cases = [([(3, b"hello world")], 64), ([(3, b"a" * 40), (4, b"b" * 17)], 64),
             ([(3, b"x" * 130)], 200), ([(3, b"z" * 62)], 63), ([(3, b"z" * 61)], 63),
             ([(3, b"z" * 60)], 63), ([(29, b"\x05"), (3, b"q" * 300)], 400),
             ([(3, bytes(rng.integers(0, 256, 1400, dtype=np.uint8)))] * 6, 9422)]
    for sdus, tb in cases:
        ce = r_mac.DL_CE_SIZES if sdus[0][0] == 29 else None
        pdu = t_mac.mac_pack(sdus, tb, ce)
        assert pdu == r_mac.mac_pack(sdus, tb, ce) and len(pdu) == tb
        assert t_mac.mac_unpack(pdu, ce) == r_mac.mac_unpack(pdu, ce)
    assert t_mac.scell_activation_ce({1, 3, 7}) == r_mac.scell_activation_ce({1, 3, 7})
    assert t_mac.scell_activation_parse(b"\x8a") == r_mac.scell_activation_parse(b"\x8a")


def ping_loop(enb, ue, to_ue=lambda x: x, ttis=40):
    """tests/test_e2e_apps.py's ping loop: 12 messages of 30 bytes, the
    second half written at TTI 20, h = 0.9·e^{0.5j}, noise 0.01."""
    rng = np.random.default_rng(0)
    msgs = [bytes(rng.integers(0, 256, 30, dtype=np.uint8)) for _ in range(12)]
    for m in msgs[:6]:
        enb.write_sdu(m)
    h = np.complex64(0.9 * np.exp(0.5j))
    sent = []
    for tti in range(ttis):
        if tti == 20:
            for m in msgs[6:]:
                enb.write_sdu(m)
        x = enb.run_tti()
        sent.append(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))
        samples = sent[-1] * h
        samples = samples + (rng.standard_normal(len(samples))
                             + 1j * rng.standard_normal(len(samples))).astype(np.complex64) * 0.01
        ue.push_samples(to_ue(samples.astype(np.complex64)))
        ue.process()
    got = []
    while (s := ue.read_sdu()) is not None:
        got.append(s)
    return msgs, got, sent


def check_ping(msgs, got, ue, enb):
    assert got == msgs, (len(got), len(msgs))
    m = ue.get_metrics()
    assert m["rx_tbs_ok"] == m["rx_tbs"] and m["rx_tbs_ok"] >= 2
    assert ue.cell is not None and ue.cell.id == 42
    assert enb.get_metrics()["tx_bytes"] == sum(len(x) for x in msgs)


def test_ping_loop_on_the_port(tmp_path):
    cell = from_reference(Cell(nof_prb=6, nof_ports=1, id=42))
    enb = TEnbApp(cell, rnti=0x46, mcs=5, cfi=2, pcap_path=str(tmp_path / "enb.pcap"), device=CPU)
    ue = TUeApp(nof_prb=6, rnti=0x46, cfi=2, pcap_path=str(tmp_path / "ue.pcap"), device=CPU)
    msgs, got, _ = ping_loop(enb, ue, to_ue=torch.from_numpy)
    check_ping(msgs, got, ue, enb)
    enb.pcap.close()
    ue.pcap.close()
    head = (tmp_path / "enb.pcap").read_bytes()[:24]
    assert head[:4] == b"\xd4\xc3\xb2\xa1" and head[20:24] == (147).to_bytes(4, "little")
    assert (tmp_path / "ue.pcap").stat().st_size > 24


def test_enb_app_samples_equal_the_reference():
    ref_cell = Cell(nof_prb=6, nof_ports=1, id=42)
    r = REnbApp(ref_cell, rnti=0x46, mcs=5, cfi=2)
    g = TEnbApp(from_reference(ref_cell), rnti=0x46, mcs=5, cfi=2, device=CPU)
    rng = np.random.default_rng(3)
    for tti in range(12):
        for _ in range(2 if tti % 3 == 0 else 0):
            m = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
            r.write_sdu(m)
            g.write_sdu(m)
        a, b = np.asarray(r.run_tti()), g.run_tti().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
    assert g.get_metrics() == r.get_metrics()


@pytest.mark.parametrize("direction", ["reference eNB to port UE", "port eNB to reference UE"])
def test_crossed_apps(direction):
    ref_cell = Cell(nof_prb=6, nof_ports=1, id=42)
    if direction == "reference eNB to port UE":
        enb = REnbApp(ref_cell, rnti=0x46, mcs=5, cfi=2)
        ue = TUeApp(nof_prb=6, rnti=0x46, cfi=None, device=CPU)
    else:
        enb = TEnbApp(from_reference(ref_cell), rnti=0x46, mcs=5, cfi=2, device=CPU)
        ue = RUeApp(nof_prb=6, rnti=0x46, cfi=None)
    msgs, got, _ = ping_loop(enb, ue)
    check_ping(msgs, got, ue, enb)


def test_entry_points_take_the_card_by_default():
    """With no device given, the apps and the receive chain's entry points
    ask for the card and raise where there is none (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from srsran_tpu_torch.phy.enb.enb_dl import DlSched, enb_dl_subframe
    from srsran_tpu_torch.phy.ue.intra_measure import measure_cells
    from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe
    from srsran_tpu_torch.phy.ue.ue_sync import UeSync, cell_search, mib_search

    cell = from_reference(Cell(nof_prb=6))
    x = np.zeros(7 * cell.sf_len, np.complex64)
    for call in (lambda: TUeApp(nof_prb=6), lambda: TEnbApp(cell), lambda: UeSync(nof_prb=6),
                 lambda: cell_search(x, 6), lambda: mib_search(x, cell, 0),
                 lambda: measure_cells(x, 6), lambda: enb_dl_subframe(cell, 0, DlSched()),
                 lambda: ue_dl_decode_subframe(cell, x[None, : cell.sf_len], 0, 0x46)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_phase_22_golden_vectors_on_the_cpu():
    info = SMOKE.golden_checks(CPU)
    assert info["psr"] > 10 and info["sib5"].startswith("604004")


def test_phase_23_received_frame_on_the_cpu():
    """Phase 23's checks at 25 PRB over 2 frames rendered by the reference."""
    tool = load("make_torch_fixture", ROOT / "tools" / "make_torch_fixture.py")
    fx = tool.ue_dl_frame_stimulus(25, 20)
    info = SMOKE.check_ue_dl_frame(fx, CPU)
    assert len(info["subframes"]) == len(fx["ref_sf"]) >= 10 and info["cell"] == 301


def test_phase_24_link_on_the_cpu():
    """Phase 24's link at 25 PRB over 2 frames: its checks hold, TRACK from
    the first frame, every TTI of the second frame delivered."""
    rec = SMOKE.link_run(CPU, nof_prb=25, n_frames=2)
    assert rec["track_tti"] < 10 and rec["first_frame"] == 10
    assert set(range(10, 19)) <= set(rec["ttis"]) and rec["tbs_ok"] >= 10
