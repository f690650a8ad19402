"""The carrier-aggregation scenarios of `tests/test_carrier_aggregation.py`
(`TestCaE2e`, `TestUlCaE2e`) on the port's per-TTI stack
(`srsran_tpu_torch/apps/full_stack.py`, `device="cpu"`, the reference
tests' two 15 PRB carriers) with the reference tests' asserts: the SCell
configured and activated, DL traffic over both carriers with the per-CC
ACKs on PUCCH format 3, and UL traffic served across both carriers.  The
subframes between the ends are (2, sf_len) complex64 torch tensors.
"""

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


def core():
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    return Mme(hss, spgw), spgw


def ca_pair(**enb_kw):
    pcell = Cell(nof_prb=15, nof_ports=1, id=7)
    scell = Cell(nof_prb=15, nof_ports=1, id=8)
    mme, spgw = core()
    enb = EnbStack(pcell, mme, spgw, mcs=5, scell=scell, device=CPU, **enb_kw)
    ue = UeStack(pcell, Usim(IMSI, KEY, OPC), device=CPU)
    return enb, ue, spgw


def test_two_cc_attach_and_dl_traffic():
    enb, ue, spgw = ca_pair()
    ul = None
    for _ in range(160):
        dl = enb.run_tti(ul)
        assert dl.shape[0] == 2  # (n_cc, sf_len)
        ul = ue.run_tti(dl)
        if ue.scell_active:
            break
    assert ue.nas.state == ue.nas.REGISTERED
    assert ue.scell is not None and ue.scell.id == 8 and ue.scell.nof_prb == 15
    assert ue.scell_active
    assert enb.ues[ue.crnti].scell_state == 2
    pkts = [bytes([i]) * 80 for i in range(8)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for _ in range(60):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert sorted(ue.ip_rx) == sorted(pkts)
    assert ue.stats.get("scell_tbs_ok", 0) > 0
    # per-CC ACK bits on one PUCCH format-3 resource, real SCell feedback
    for i in range(16):
        spgw.sgi_tx(ue.ue_ip, bytes([0x30 + i]) * 80)
    for _ in range(120):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
    assert ue.stats.get("ca_ack_f3_sent", 0) > 0, (ue.stats, enb.stats)
    assert enb.stats.get("ca_ack_f3_rx", 0) > 0, enb.stats
    assert (enb.stats["ca_ack_f3_rx"] + enb.stats.get("ca_ack_pusch_rx", 0)
            >= ue.stats["ca_ack_f3_sent"])


def test_two_cc_ul_traffic():
    enb, ue, spgw = ca_pair(ul_ca=True)
    ul = None
    for _ in range(160):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if ue.scell_active:
            break
    assert ue.scell_active and ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([0x60 + i]) * 120 for i in range(10)]
    for p in pkts:
        ue.send_ip_packet(p)
    for _ in range(120):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(spgw.sgi_rx) >= len(pkts):
            break
    got = sorted(pl for _, pl in spgw.sgi_rx)
    assert got == sorted(pkts), f"got {len(got)}/{len(pkts)} UL packets"
    assert enb.stats.get("scell_ul_crc_ok", 0) >= 1, "SCell PUSCH never decoded"
    assert ue.stats.get("scell_pusch_tx", 0) >= 1
