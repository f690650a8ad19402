"""The multi-antenna and periodic-CQI scenarios of `tests/test_tm34_stack.py`
and `tests/test_periodic_cqi_pucch.py` on the port's per-TTI stack
(`srsran_tpu_torch/apps/full_stack.py`, `device="cpu"`, the reference
tests' 15 PRB cells) with the reference tests' asserts: TM3 and TM4 with
RI/PMI feedback and two-codeword grants behind a rank-2 2x2 channel, and
periodic CQI on PUCCH format 2 tracking a degrading channel.  The samples
between the ends are complex64 torch tensors.  The carrier-aggregation
scenarios are in `tests/test_torch_stack_ca.py`.
"""

import numpy as np
import pytest
import torch

from srsran_tpu_torch.apps.full_stack import EnbStack, UeStack
from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.stack import security as sec
from srsran_tpu_torch.stack.nas_ue import Usim

torch.set_num_threads(1)

CPU = "cpu"
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
# the reference test's well-conditioned 2x2 channel (rank 2)
H_RANK2 = torch.tensor([[1.0 + 0.1j, 0.2 - 0.6j], [-0.5 + 0.3j, 0.9 + 0.0j]], dtype=torch.complex64)


def core():
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    return Mme(hss, spgw), spgw


def registered(ue) -> bool:
    return ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED


@pytest.mark.parametrize("tm", [3, 4])
def test_tm34_attach_and_two_codeword_traffic(tm):
    cell = Cell(nof_prb=15, nof_ports=2, id=7)
    mme, spgw = core()
    enb = EnbStack(cell, mme, spgw, mcs=8, tm=tm, device=CPU)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), tm=tm, nrx=2, device=CPU)
    ul = [None]

    def step():
        dl = enb.run_tti(ul[0])  # (2, sf_len) port streams
        ul[0] = ue.run_tti(H_RANK2 @ dl)

    for _ in range(150):
        step()
        if registered(ue):
            break
    assert ue.nas.state == ue.nas.REGISTERED, "attach failed under 2x2 channel"
    pkts = [bytes([i]) * 200 for i in range(40)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for i in range(300):
        if i % 25 == 0:
            ue.send_ip_packet(b"\x11" * 20)
        step()
        if len(ue.ip_rx) >= len(pkts):
            break
    assert enb.stats.get("ri_rx", 0) >= 1, "RI report must reach the eNB"
    u = next(iter(enb.ues.values()))
    assert u.last_ri == 2, "well-conditioned channel must yield RI=2"
    assert u.crnti in enb.sched.two_cw
    if tm == 4:
        assert enb.stats.get("cqi_rx", 0) >= 1  # PMI rides the CQI report
    assert ue.ip_rx[: len(pkts)] == pkts
    assert enb.stats.get("dl_2cw_tx", 0) >= 1, "no DCI 2/2A grant went on air"
    assert ue.stats.get("dl_tbs_ok", 0) > 0


def _run(enb, ue, n, ul, scale=1.0, noise=0.0, rng=None):
    for _ in range(n):
        dl = enb.run_tti(ul) * float(np.float32(scale))
        if noise:
            z = (noise * (rng.standard_normal(tuple(dl.shape))
                          + 1j * rng.standard_normal(tuple(dl.shape)))).astype(np.complex64)
            dl = dl + torch.from_numpy(z)
        ul = ue.run_tti(dl)
    return ul


def test_periodic_cqi_on_pucch2_tracks_channel():
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    mme, spgw = core()
    # SR-driven UL grants: an idle UE gets no PUSCH, so CQI rides PUCCH 2
    enb = EnbStack(cell, mme, spgw, mcs=20, sr_enabled=True, device=CPU)
    enb.ul_inactivity_timeout = 100000
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), sr_enabled=True, device=CPU)
    ul = None
    for _ in range(200):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if registered(ue):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    crnti = ue.crnti
    rng = np.random.default_rng(3)

    ul = _run(enb, ue, 80, None)
    assert ue.stats.get("cqi_pucch_sent", 0) >= 5
    assert enb.stats.get("cqi_pucch_rx", 0) >= 5
    cqi_clean = enb.sched.ues[crnti].cqi
    assert cqi_clean >= 10
    spgw.sgi_tx(ue.ue_ip, bytes(1200))
    ul = _run(enb, ue, 12, ul)
    mcs_clean = max(h.mcs for h in enb.sched.ues[crnti].dl_harq)
    assert len(ue.ip_rx) >= 1
    ue.ip_rx.clear()

    rx_before = enb.stats.get("cqi_pucch_rx", 0)
    ul = _run(enb, ue, 80, ul, scale=0.3, noise=0.08, rng=rng)
    assert enb.stats.get("cqi_pucch_rx", 0) > rx_before
    cqi_bad = enb.sched.ues[crnti].cqi
    assert cqi_bad < cqi_clean
    spgw.sgi_tx(ue.ue_ip, bytes(1200))
    _run(enb, ue, 12, ul, scale=0.3, noise=0.08, rng=rng)
    mcs_bad = max((h.mcs for h in enb.sched.ues[crnti].dl_harq
                   if h.pdu is not None or h.pending_ack), default=None)
    if mcs_bad is None:
        mcs_bad = max(h.mcs for h in enb.sched.ues[crnti].dl_harq)
    assert mcs_bad < mcs_clean
