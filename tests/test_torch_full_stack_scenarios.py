"""The scenarios of `tests/test_full_stack.py` and the intra-eNB handover of
`tests/test_handover.py`, run on the port's stack (`device="cpu"`, 15 PRB
or the reference test's cell) with the reference tests' asserts: two UEs,
the DL HARQ outage, UL HARQ over PHICH, scheduling requests, SRS with the
shortened PUSCH, RLF and re-establishment, TM2, the aperiodic CQI request,
the UE-initiated detach and one `TwoCellEnb` handover.  The samples between
the ends are torch tensors; an outage is `torch.zeros_like`.
"""

import numpy as np
import torch

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
IMSI2 = "001010999888777"
KEY2 = bytes(range(16))
OPC2 = sec.compute_opc(KEY2, bytes(16))


def core(two: bool = False):
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    if two:
        hss.add_subscriber(Subscriber("ue2", IMSI2, KEY2, OPC2, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    return Mme(hss, spgw), spgw


class Net:
    """One eNB and one UE on a 15 PRB cell (or `ports` ports), stepped one
    TTI at a time; `dl_hook`/`ul_hook` may replace what crosses the air."""

    def __init__(self, ports: int = 1, enb_kw=None, ue_kw=None):
        self.cell = Cell(nof_prb=15, nof_ports=ports, id=7)
        self.mme, self.spgw = core()
        self.enb = EnbStack(self.cell, self.mme, self.spgw, mcs=5, device=CPU, **(enb_kw or {}))
        self.ue = UeStack(self.cell, Usim(IMSI, KEY, OPC), device=CPU, **(ue_kw or {}))
        self.ul = None

    def step(self, dl_hook=None, ul_hook=None):
        dl = self.enb.run_tti(self.ul)
        if dl_hook is not None:
            dl = dl_hook(dl)
        self.ul = self.ue.run_tti(dl)
        if ul_hook is not None:
            self.ul = ul_hook(self.ul)
        return dl

    def run(self, n: int, stop=None, **hooks) -> bool:
        for _ in range(n):
            self.step(**hooks)
            if stop is not None and stop():
                return True
        return False

    def registered(self) -> bool:
        return self.ue.rrc_state == UeStack.RRC_ACTIVE and self.ue.nas.state == self.ue.nas.REGISTERED

    def attach(self, n: int = 200):
        assert self.run(n, self.registered), "no attach"


def _sum(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def test_two_ues_attach_and_traffic():
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    mme, spgw = core(two=True)
    enb = EnbStack(cell, mme, spgw, mcs=5, device=CPU)
    ue1 = UeStack(cell, Usim(IMSI, KEY, OPC), preamble=11, device=CPU)
    ue2 = UeStack(cell, Usim(IMSI2, KEY2, OPC2), preamble=29, attach_delay=40, device=CPU)
    ue2.ue_identity = b"\x99\x88\x77\x66\x55"
    ul1 = ul2 = None

    def step():
        nonlocal ul1, ul2
        dl = enb.run_tti(_sum(ul1, ul2))
        ul1 = ue1.run_tti(dl)
        ul2 = ue2.run_tti(dl)

    for _ in range(260):
        step()
        if ue1.nas.state == ue1.nas.REGISTERED and ue2.nas.state == ue2.nas.REGISTERED:
            break
    for _ in range(15):  # drain: let the Attach Completes reach the MME
        step()
    assert ue1.nas.state == ue1.nas.REGISTERED and ue2.nas.state == ue2.nas.REGISTERED
    assert ue1.crnti != ue2.crnti and ue1.ue_ip != ue2.ue_ip
    assert IMSI in mme.attached_imsis and IMSI2 in mme.attached_imsis
    spgw.sgi_tx(ue1.ue_ip, b"to-ue1" * 10)
    spgw.sgi_tx(ue2.ue_ip, b"to-ue2" * 10)
    for _ in range(40):
        step()
        if ue1.ip_rx and ue2.ip_rx:
            break
    assert ue1.ip_rx == [b"to-ue1" * 10]
    assert ue2.ip_rx == [b"to-ue2" * 10]


def test_dl_harq_retransmission_recovers_outage():
    net = Net()
    net.ue.n310 = 1000  # keep RLF out of this test
    net.attach()
    base_acks = net.enb.stats.get("dl_ack", 0)
    assert base_acks > 0
    pkt = b"\xab" * 120
    net.spgw.sgi_tx(net.ue.ue_ip, pkt)
    outage = [3]

    def blank(dl):
        if outage[0]:
            outage[0] -= 1
            return torch.zeros_like(dl)
        return dl

    assert net.run(60, lambda: bool(net.ue.ip_rx), dl_hook=blank)
    assert net.ue.ip_rx == [pkt]  # delivered exactly once despite the outage
    assert net.enb.stats.get("dl_nack", 0) > 0
    assert net.enb.stats.get("dl_ack", 0) > base_acks


def test_ul_harq_phich_retransmission():
    net = Net()
    net.enb.ul_inactivity_timeout = 10_000
    net.attach()
    pkt = b"\x5c" * 100
    net.ue.send_ip_packet(pkt)
    outage = [2]
    for _ in range(80):
        dl = net.enb.run_tti(net.ul)
        pre = set(net.ue._ul_inflight)
        net.ul = net.ue.run_tti(dl)
        if net.ul is not None and set(net.ue._ul_inflight) - pre and outage[0]:
            net.ul = torch.zeros_like(net.ul)
            outage[0] -= 1
        if net.spgw.sgi_rx:
            break
    got = [p for _ip, p in net.spgw.sgi_rx]
    assert pkt in got and got.count(pkt) == 1
    assert net.ue.stats.get("ul_retx", 0) > 0


def test_scheduling_request_drives_ul_grants():
    net = Net(enb_kw=dict(sr_enabled=True), ue_kw=dict(sr_enabled=True))
    net.enb.ul_inactivity_timeout = 10_000
    net.attach()
    net.run(40)  # the UL goes idle
    sr0 = net.ue.stats.get("sr_sent", 0)
    net.ue.send_ip_packet(b"\x99" * 80)
    assert net.run(60, lambda: any(p == b"\x99" * 80 for _a, p in net.spgw.sgi_rx))
    assert net.ue.stats.get("sr_sent", 0) > sr0
    assert net.enb.stats.get("sr_detected", 0) >= 1


def test_srs_sounding_with_shortened_pusch():
    net = Net(enb_kw=dict(srs_enabled=True), ue_kw=dict(srs_enabled=True))
    net.attach()
    ok0 = net.enb.stats["ul_crc_ok"]
    for _ in range(60):
        net.ue.send_ip_packet(b"\x21" * 30)
        net.step()
    assert net.enb.stats.get("srs_meas", 0) >= 3
    u = next(iter(net.enb.ues.values()))
    assert u.srs_snr_db is not None and u.srs_snr_db > 10.0
    assert net.enb.stats["ul_crc_ok"] > ok0 + 10
    assert net.enb.stats["ul_crc_ko"] <= 2


def test_rrc_reestablishment_preserves_session():
    net = Net()
    net.enb.ul_inactivity_timeout = 10_000
    net.attach()
    net.run(20)
    ip0, crnti0 = net.ue.ue_ip, net.ue.crnti

    def off(x):
        return None if x is None else torch.zeros_like(x)

    net.run(40, dl_hook=off, ul_hook=lambda x: None)  # N310/T310 → RLF
    assert net.ue.stats["rlf"] == 1
    assert net.run(150, lambda: net.ue.stats.get("reest", 0) == 1 and net.registered()
                   and net.enb.stats.get("reest_ok", 0) == 1)
    net.run(10)
    assert net.ue.rrc_state == UeStack.RRC_ACTIVE
    assert net.ue.ue_ip == ip0 and net.ue.crnti != crnti0
    assert net.ue.nas.state == net.ue.nas.REGISTERED
    net.spgw.sgi_tx(net.ue.ue_ip, b"\xcd" * 50)
    assert net.run(30, lambda: b"\xcd" * 50 in net.ue.ip_rx)


def test_two_port_tm2_attach_and_traffic():
    net = Net(ports=2)
    assert net.run(140, net.registered)
    assert net.step().ndim == 1  # one combined stream at the UE antenna
    pkts = [bytes([0x30 + i]) * 70 for i in range(3)]
    for p in pkts:
        net.spgw.sgi_tx(net.ue.ue_ip, p)
    assert net.run(40, lambda: len(net.ue.ip_rx) >= len(pkts))
    assert net.ue.ip_rx[: len(pkts)] == pkts


def test_aperiodic_cqi_request():
    net = Net()
    net.enb.apcqi_interval = 12
    assert net.run(200, lambda: net.enb.stats.get("apcqi_req", 0) >= 1
                   and net.enb.stats.get("cqi_rx", 0) >= 2)
    reported = net.enb.sched.ues[next(iter(net.enb.sched.ues))].cqi
    assert 1 <= reported <= 15


def test_ue_initiated_detach():
    net = Net()
    net.attach()
    net.run(15)  # the Attach Complete reaches the MME
    assert IMSI in net.mme.attached_imsis
    ip0 = net.ue.ue_ip
    assert net.spgw.ip_to_teid.get(ip0) is not None
    net.ue.detach()
    assert net.run(60, lambda: net.ue.nas.state == net.ue.nas.DEREGISTERED)
    assert IMSI not in net.mme.attached_imsis
    assert net.spgw.ip_to_teid.get(ip0) is None
    net.run(20)  # the eNB's delayed context removal drains
    assert not net.enb.ues


def test_intra_enb_handover():
    """`tests/test_handover.py`'s intra-eNB handover on the port: cell B
    powers up 6 dB above A, the A3 report moves the UE (new C-RNTI,
    contention-free RA), and the user plane continues through B."""
    cell_a = Cell(nof_prb=6, nof_ports=1, id=1)
    cell_b = Cell(nof_prb=6, nof_ports=1, id=2)
    mme, spgw = core()
    enb = TwoCellEnb(cell_a, cell_b, mme, spgw, mcs=5, device=CPU)
    ue = UeStack(cell_a, Usim(IMSI, KEY, OPC), device=CPU)
    gain_b = [0.0]
    ul = [None]

    def step():
        uls = [None, None]
        uls[0 if ue.cell.id == cell_a.id else 1] = ul[0]
        dls = enb.run_tti(uls)
        ul[0] = ue.run_tti(dls[0] + gain_b[0] * dls[1])

    def until(n, cond):
        for _ in range(n):
            step()
            if cond():
                return True
        return False

    assert until(120, lambda: ue.rrc_state == UeStack.RRC_ACTIVE
                 and ue.nas.state == ue.nas.REGISTERED)
    assert ue.meas_cfg is not None
    crnti_a = ue.crnti
    spgw.sgi_tx(ue.ue_ip, b"\xaa" * 40)
    assert until(20, lambda: bool(ue.ip_rx))
    assert ue.ip_rx == [b"\xaa" * 40]
    ue.ip_rx.clear()
    gain_b[0] = 2.0
    assert until(400, lambda: enb.stats["ho_completed"])
    assert ue.stats["meas_report"] >= 1
    assert enb.stats["ho_started"] == 1 and enb.stats["ho_completed"] == 1 and ue.stats["ho"] == 1
    assert ue.cell.id == cell_b.id and ue.crnti != crnti_a
    assert ue.rrc_state == UeStack.RRC_ACTIVE
    assert not enb.cells[0].ues
    assert any(u.crnti == ue.crnti for u in enb.cells[1].ues.values())
    assert IMSI in mme.attached_imsis
    spgw.sgi_tx(ue.ue_ip, b"\xbb" * 48)
    assert until(30, lambda: bool(ue.ip_rx))
    assert ue.ip_rx == [b"\xbb" * 48]
    ue.send_ip_packet(b"\xcc" * 44)
    assert until(40, lambda: bool(spgw.sgi_rx))
    assert spgw.sgi_rx[-1][1] == b"\xcc" * 44
    assert np.isfinite(enb.cells[1].ues[ue.crnti].last_ul_rx_db)
