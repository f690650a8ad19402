"""The mobility scenarios of `tests/test_reselection.py` and
`tests/test_handover.py` on the port's per-TTI stack
(`srsran_tpu_torch/apps/full_stack.py`, `device="cpu"`, the reference
tests' cells) with the reference tests' asserts: idle-mode reselection to a
stronger cell and a page answered there, no reselection inside the
hysteresis, the S1 inter-eNB handover through the MME, and the
inter-frequency handover with measurement gaps.  The samples between the
ends are complex64 torch tensors.
"""

import torch

import srsran_tpu_torch.stack.rrc as rrc
from srsran_tpu_torch.apps.full_stack import EnbStack, TwoCellEnb, UeStack
from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.stack import security as sec
from srsran_tpu_torch.stack.nas_ue import Usim

torch.set_num_threads(1)

CPU = "cpu"
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))


def core():
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    return Mme(hss, spgw), spgw


def registered(ue) -> bool:
    return ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED


def until(step, n: int, stop=None) -> bool:
    for _ in range(n):
        step()
        if stop is not None and stop():
            return True
    return False


def two_cell_idle(nof_prb: int = 15):
    """A `TwoCellEnb` in SR mode (the UL goes quiet, the inactivity release
    fires) and a UE on cell A that acquires the broadcast SI."""
    cell_a = Cell(nof_prb=nof_prb, nof_ports=1, id=1)
    cell_b = Cell(nof_prb=nof_prb, nof_ports=1, id=2)
    mme, spgw = core()
    enb = TwoCellEnb(cell_a, cell_b, mme, spgw, mcs=5, sr_enabled=True, device=CPU)
    for c in enb.cells:
        c.ul_inactivity_timeout = 30
    ue = UeStack(cell_a, Usim(IMSI, KEY, OPC), acquire_si=True, sr_enabled=True, device=CPU)
    return cell_a, cell_b, spgw, enb, ue


def test_idle_mode_cell_reselection_and_paging_resume():
    cell_a, cell_b, spgw, enb, ue = two_cell_idle()
    gains = [1.0, 0.0]  # cell B off during the attach
    ul = [None]

    def step():
        uls = [None, None]
        uls[0 if ue.cell.id == cell_a.id else 1] = ul[0]
        dls = enb.run_tti(uls)
        ul[0] = ue.run_tti(gains[0] * dls[0] + gains[1] * dls[1])

    assert until(step, 250, lambda: registered(ue))
    assert ue.sib3_params is not None, "SIB3 must ride the SI broadcast"
    assert ue.sib3_params["q_hyst_db"] == 4
    ip0 = ue.ue_ip
    assert until(step, 150, lambda: ue.idle_camped)
    assert ue.cell.id == cell_a.id
    gains[:] = [0.25, 1.0]  # B 12 dB above A
    assert until(step, 300, lambda: ue.cell.id == cell_b.id)
    assert ue.stats.get("reselection") == 1
    assert ue.idle_camped, "reselection must not leave idle mode"
    assert ue.nas.state == ue.nas.REGISTERED
    assert until(step, 120, lambda: ue.sib1 is not None and ue.sib2 is not None)
    spgw.sgi_tx(ip0, b"\xd5" * 80)
    assert until(step, 400, lambda: bool(ue.ip_rx))
    assert ue.stats.get("paged", 0) >= 1
    assert ue.ip_rx == [b"\xd5" * 80]
    assert ue.ue_ip == ip0
    assert ue.rrc_state == UeStack.RRC_ACTIVE
    assert ue.cell.id == cell_b.id
    assert any(u.crnti == ue.crnti for u in enb.cells[1].ues.values())


def test_no_reselection_below_hysteresis():
    cell_a, _cell_b, _spgw, enb, ue = two_cell_idle()
    gains = [1.0, 0.0]
    ul = [None]

    def step():
        dls = enb.run_tti([ul[0], None])
        ul[0] = ue.run_tti(gains[0] * dls[0] + gains[1] * dls[1])

    assert until(step, 250, lambda: ue.rrc_state == UeStack.RRC_ACTIVE)
    assert until(step, 150, lambda: ue.idle_camped)
    gains[:] = [0.75, 1.0]  # B ~2.5 dB above A, under the 4 dB Qhyst
    until(step, 200)
    assert ue.cell.id == cell_a.id
    assert ue.stats.get("reselection", 0) == 0


def two_enbs(mme, spgw, **kw_b):
    cell_a = Cell(nof_prb=6, nof_ports=1, id=1)
    cell_b = Cell(nof_prb=6, nof_ports=1, id=2)
    kw_a = {k: v for k, v in kw_b.items() if k != "earfcn"}
    if "earfcn" in kw_b:
        kw_a["earfcn"], kw_b["earfcn"] = kw_b["earfcn"]
    enb_a = EnbStack(cell_a, mme, spgw, mcs=5, enb_id=0x19B, device=CPU, **kw_a)
    enb_b = EnbStack(cell_b, mme, spgw, mcs=5, crnti=0x70, enb_id=0x19C, device=CPU, **kw_b)
    enb_a.s1_neighbors = {cell_b.id: enb_b.enb_id}
    enb_b.s1_neighbors = {cell_a.id: enb_a.enb_id}
    return cell_a, cell_b, enb_a, enb_b


def check_moved(ue, mme, enb_a, enb_b, cell_b):
    assert ue.stats["ho"] == 1
    assert ue.cell.id == cell_b.id
    assert ue.rrc_state == UeStack.RRC_ACTIVE
    assert not enb_a.ues, "source eNB must be released by the MME"
    mme_ue = next(iter(mme.ues.values()))
    assert mme_ue.serving_enb_id == enb_b.enb_id
    assert IMSI in mme.attached_imsis


def test_s1_inter_enb_handover():
    mme, spgw = core()
    cell_a, cell_b, enb_a, enb_b = two_enbs(mme, spgw)
    enb_a.meas_cfg = rrc.make_meas_config(a3_offset_db=-10.0)
    ue = UeStack(cell_a, Usim(IMSI, KEY, OPC), device=CPU)
    gain_b = [0.0]
    ul = [None]

    def step():
        ul_a = ul[0] if ue.cell.id == cell_a.id else None
        ul_b = ul[0] if ue.cell.id == cell_b.id else None
        dl_a = enb_a.run_tti(ul_a)
        dl_b = enb_b.run_tti(ul_b)
        ul[0] = ue.run_tti(dl_a + gain_b[0] * dl_b)

    until(step, 120, lambda: registered(ue))
    assert ue.nas.state == ue.nas.REGISTERED
    mme_ue = next(iter(mme.ues.values()))
    assert mme_ue.serving_enb_id == enb_a.enb_id
    gain_b[0] = 2.0
    until(step, 400, lambda: not enb_a.ues and any(
        u.rrc_state == EnbStack.RRC_ACTIVE for u in enb_b.ues.values()))
    check_moved(ue, mme, enb_a, enb_b, cell_b)
    assert any(u.rrc_state == EnbStack.RRC_ACTIVE for u in enb_b.ues.values())
    spgw.sgi_tx(ue.ue_ip, b"\xdd" * 52)
    until(step, 30, lambda: bool(ue.ip_rx))
    assert ue.ip_rx == [b"\xdd" * 52]
    ue.send_ip_packet(b"\xee" * 45)
    until(step, 40, lambda: bool(spgw.sgi_rx))
    assert spgw.sgi_rx and spgw.sgi_rx[-1][1] == b"\xee" * 45


def test_inter_frequency_handover():
    earfcn_a, earfcn_b = 3400, 2850
    mme, spgw = core()
    cell_a, cell_b, enb_a, enb_b = two_enbs(mme, spgw, earfcn=(earfcn_a, earfcn_b))
    enb_a.meas_cfg = rrc.make_meas_config(
        carrier_arfcn=earfcn_a, a3_offset_db=-10.0, inter_freq_arfcn=earfcn_b,
        gap_pattern="gp0", gap_offset=7)
    ue = UeStack(cell_a, Usim(IMSI, KEY, OPC), earfcn=earfcn_a, device=CPU)
    ul = [None]

    def step():
        ul_a = ul[0] if ue.earfcn == earfcn_a else None
        ul_b = ul[0] if ue.earfcn == earfcn_b else None
        dl_a = enb_a.run_tti(ul_a)
        dl_b = enb_b.run_tti(ul_b)
        # the UE hears whichever carrier it is tuned to (gaps retune it)
        ul[0] = ue.run_tti(dl_a if ue.tuned_earfcn() == earfcn_a else dl_b)

    until(step, 150, lambda: registered(ue))
    assert ue.nas.state == ue.nas.REGISTERED
    assert ue.meas_cfg is not None
    assert rrc.meas_config_gap(ue.meas_cfg) == (40, 7)
    until(step, 500, lambda: ue.stats["ho"] and not enb_a.ues)
    assert ue.stats["meas_report"] >= 1, "inter-freq A3 report not sent"
    assert ue.earfcn == earfcn_b, "UE must retune to the target carrier"
    check_moved(ue, mme, enb_a, enb_b, cell_b)
    spgw.sgi_tx(ue.ue_ip, b"\xab" * 40)
    until(step, 40, lambda: bool(ue.ip_rx))
    assert ue.ip_rx == [b"\xab" * 40]
    ue.send_ip_packet(b"\xcd" * 36)
    until(step, 40, lambda: bool(spgw.sgi_rx))
    assert spgw.sgi_rx and spgw.sgi_rx[-1][1] == b"\xcd" * 36
