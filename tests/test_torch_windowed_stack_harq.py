"""`tests/test_windowed_stack.py::test_windowed_sync_harq_retx_under_fade` on
the port's windowed control-plane stack over its device-resident loopback
(`WindowedDeviceLoopback`: whole windows through `window_channel` on the
device, here the CPU), at its cell (25 PRB, W = 12, MCS 10): synchronous DL
HARQ (pid = tti mod n_harq at both ends) under deep fades mid-traffic — CRC
failures, retransmissions on the pid's own TTI slots, softbuffers combined
across windows, and every packet delivered exactly once.

The channel's noise comes from a `torch.Generator`, so these runs are held
to the reference test's asserts, not sample by sample.
"""

import numpy as np
import torch

from srsran_tpu_torch.apps.windowed_stack import WindowedCtrlEnb, WindowedCtrlUe, WindowedDeviceLoopback
from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.stack import security as sec
from srsran_tpu_torch.stack.nas_ue import Usim

torch.set_num_threads(1)

CPU = "cpu"
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
W = 12


def network(mcs: int = 8):
    cell = Cell(nof_prb=25, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = WindowedCtrlEnb(cell, mme, spgw, mcs=mcs, ctrl_window=W, device=CPU)
    ue = WindowedCtrlUe(cell, Usim(IMSI, KEY, OPC), ctrl_window=W, device=CPU)
    return enb, ue, spgw


def registered(ue) -> bool:
    return ue.rrc_state == WindowedCtrlUe.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED


def test_windowed_sync_harq_retx_under_fade():
    enb, ue, spgw = network(mcs=10)
    link = WindowedDeviceLoopback(enb, ue, snr_db=30.0)
    for _ in range(1800):
        link.step()
        if registered(ue):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([i]) * 180 for i in range(48)]
    clean = link._noise
    for k in range(2000):
        if k % 25 == 0 and k // 25 < len(pkts) // 4:
            for p in pkts[4 * (k // 25): 4 * (k // 25) + 4]:
                spgw.sgi_tx(ue.ue_ip, p)
        # deep fades across the traffic (the rlf.c-style burst impairment,
        # here on the device link)
        link._noise = np.float32(10 ** (-2.0 / 20.0)) if (k // 30) % 4 == 1 and k < 500 else clean
        link.step()
        if len(ue.ip_rx) >= len(pkts) and k > 600:
            break
    assert enb.stats.get("dl_nack", 0) > 0, enb.stats  # the fade really bit
    assert sorted(ue.ip_rx) == sorted(pkts), (len(ue.ip_rx), enb.stats.get("dl_nack"))
