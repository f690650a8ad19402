"""The RRC and link-maintenance scenarios of `tests/test_full_stack.py` on
the port's per-TTI stack (`srsran_tpu_torch/apps/full_stack.py`,
`device="cpu"`, the reference tests' 15 PRB cell) with the reference tests'
asserts: radio link failure with release and a fresh attach, the CQI
reporting loop, SI acquisition before the attach, UL closed-loop power
control, timing-advance maintenance, and idle-mode paging with a service
request.  The samples between the ends are complex64 torch tensors; an
outage is `torch.zeros_like`, a drift `torch.roll`, noise the reference
test's numpy draws added as a tensor.
"""

import numpy as np
import torch

from srsran_tpu_torch.apps.full_stack import EnbStack, UeStack
from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.stack import security as sec
from srsran_tpu_torch.stack.nas_ue import Usim
from srsran_tpu_torch.stack.rrc import sib2_rach_params

torch.set_num_threads(1)

CPU = "cpu"
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))


class Link:
    """One eNB and one UE on the reference tests' 15 PRB cell, stepped one
    TTI at a time; `dl_hook`/`ul_hook` may replace what crosses the air."""

    def __init__(self, enb_kw=None, ue_kw=None):
        self.cell = Cell(nof_prb=15, nof_ports=1, id=7)
        hss = Hss()
        hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
        self.spgw = Spgw()
        self.mme = Mme(hss, self.spgw)
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

    def run(self, n: int, stop=None, **hooks) -> bool:
        for _ in range(n):
            self.step(**hooks)
            if stop is not None and stop():
                return True
        return False

    def registered(self) -> bool:
        return self.ue.rrc_state == UeStack.RRC_ACTIVE and self.ue.nas.state == self.ue.nas.REGISTERED


def _off(x):
    return None if x is None else torch.zeros_like(x)


def test_radio_link_failure_and_reestablishment():
    """Outage → N310/T310 → RLF → context release → fresh random access →
    a new attach with a fresh bearer."""
    net = Link()
    net.run(120)
    assert net.ue.nas.state == net.ue.nas.REGISTERED
    first_ip = net.ue.ue_ip
    net.run(60, dl_hook=_off, ul_hook=lambda _x: None)
    assert net.ue.stats["rlf"] == 1
    assert net.enb.stats["ue_released"] >= 1
    assert net.ue.rrc_state in (UeStack.RRC_IDLE, UeStack.RRC_WAIT_RAR)
    net.run(150)
    assert net.ue.nas.state == net.ue.nas.REGISTERED
    assert net.ue.rrc_state == UeStack.RRC_ACTIVE
    assert net.ue.ue_ip != "" and net.ue.ue_ip != first_ip


def test_cqi_reporting_loop():
    """UE-measured SNR → periodic CQI on PUSCH → the scheduler's CQI."""
    net = Link()
    net.run(120, net.registered)
    net.ue.send_ip_packet(b"\x11" * 30)
    net.run(60, lambda: net.enb.stats.get("cqi_rx", 0) >= 2)
    assert net.ue.stats.get("cqi_sent", 0) >= 1
    assert net.enb.stats.get("cqi_rx", 0) >= 1
    reported = net.enb.sched.ues[next(iter(net.enb.sched.ues))].cqi
    assert 1 <= reported <= 15
    assert reported >= 10, reported  # clean channel -> high CQI


def test_si_acquisition_before_attach():
    """SIB1 and SIB2 on SI-RNTI are decoded before the first PRACH; the RA
    parameters and RLM timers come from SIB2."""
    net = Link(ue_kw=dict(acquire_si=True))
    ue = net.ue
    ue.n310 = 999  # must be overwritten by SIB2
    prach_before_si = False
    for _ in range(150):
        net.step()
        if ue.rrc_state != UeStack.RRC_IDLE and not ue._si_ready():
            prach_before_si = True
        if net.registered():
            break
    assert not prach_before_si
    assert ue.sib1 is not None and ue.sib2 is not None
    assert ue.sib1["cell_access_related_info"]["cell_id"] == (0x19B << 8) | 7
    assert ue.n310 == 4 and ue.t310_ms == 200
    assert sib2_rach_params(ue.sib2)["nof_preambles"] == 52
    assert ue.nas.state == ue.nas.REGISTERED


def test_ul_closed_loop_power_control():
    """A UE 15 dB low is ramped up by accumulated TPC in DCI0 until the UL
    SNR sits near the target, with data still passing."""
    rng = np.random.default_rng(9)
    net = Link()
    net.enb.ul_inactivity_timeout = 10_000
    net.run(120, net.registered)
    assert net.ue.nas.state == net.ue.nas.REGISTERED
    ue = net.ue
    ref_pow = None
    ue.ul_gain_db = -15.0
    ue.send_ip_packet(b"\x77" * 60)
    gains = []
    for _ in range(200):
        dl = net.enb.run_tti(net.ul)
        ul = ue.run_tti(dl)
        ue.send_ip_packet(b"\x77" * 8)
        if ul is not None:
            p = float(torch.mean(ul.abs() ** 2))
            if p > 0:
                if ref_pow is None:
                    ref_pow = p / 10 ** (ue.ul_gain_db / 10)
                n0 = ref_pow * 10 ** (-25.0 / 10)
                noise = (rng.standard_normal(ul.shape) + 1j * rng.standard_normal(ul.shape)
                         ).astype(np.complex64) * np.sqrt(n0 / 2)
                ul = ul + torch.from_numpy(noise.astype(np.complex64))
        net.ul = ul
        gains.append(ue.ul_gain_db)
    assert ue.ul_gain_db > -12.0, gains[-5:]
    assert max(gains) <= 20.0
    assert net.enb.stats["ul_crc_ok"] > 20


def test_timing_advance_maintenance():
    """The UE's UL drifts 6 samples late; the eNB's Timing Advance Command
    brings the residual back inside the dead zone."""
    net = Link()
    net.enb.ul_inactivity_timeout = 10_000
    net.run(120, net.registered)
    assert net.ue.nas.state == net.ue.nas.REGISTERED
    ue = net.ue
    ta0 = ue.ta_samples
    ok0 = net.enb.stats["ul_crc_ok"]
    drift = 6
    ue.send_ip_packet(b"\x11" * 40)
    for _ in range(120):
        net.step(ul_hook=lambda x: None if x is None else torch.roll(x, drift))
        ue.send_ip_packet(b"\x11" * 8)
        if ue.stats.get("ta_cmd", 0) >= 1 and ue.ta_samples - ta0 >= drift - 1:
            break
    assert net.enb.stats.get("ta_cmd_tx", 0) >= 1
    assert ue.stats.get("ta_cmd", 0) >= 1
    assert abs((ue.ta_samples - ta0) - drift) <= 2, ue.ta_samples
    assert net.enb.stats["ul_crc_ok"] > ok0


def test_idle_paging_service_request_over_the_air():
    """Inactivity → release → ECM-IDLE camping → DL packet → DDN → paging
    on P-RNTI → RA + NAS Service Request → the packet on the same IP."""
    net = Link(enb_kw=dict(sr_enabled=True), ue_kw=dict(sr_enabled=True))
    net.enb.ul_inactivity_timeout = 30
    ue = net.ue
    net.run(150, net.registered)
    assert ue.nas.state == ue.nas.REGISTERED
    ip0 = ue.ue_ip
    assert net.run(120, lambda: ue.idle_camped)
    assert ue.stats.get("released") == 1
    net.run(20)
    assert net.enb.stats["ue_released"] == 1
    assert ue.nas.state == ue.nas.REGISTERED
    net.spgw.sgi_tx(ip0, b"\xee" * 90)
    assert net.run(250, lambda: bool(ue.ip_rx))
    assert ue.stats.get("paged") == 1
    assert ue.ip_rx == [b"\xee" * 90]
    assert ue.ue_ip == ip0
    assert ue.rrc_state == UeStack.RRC_ACTIVE
