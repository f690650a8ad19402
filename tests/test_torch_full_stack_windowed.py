"""The scenarios of `tests/test_full_stack_windowed.py` on the port: the
per-TTI stack (`srsran_tpu_torch/apps/full_stack.py`, `device="cpu"`, the
reference tests' 15 PRB cell) with `windowed_phy=True, phy_window=4` on
both ends, so that every data PDSCH/PUSCH subframe after the attach rides
the windowed plane (`apps/windowed_plane.py`).  The reference tests'
asserts: the attach, DL and UL IP traffic through the windows, a DL HARQ
outage recovered through the device softbuffers, TM2 on a 2-port cell and
TM3/TM4 two-codeword traffic on the MIMO plane.  The samples between the
ends are complex64 torch tensors; the outage's noise is the reference
test's numpy draw added as a tensor.
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
W = 4
# the reference test's well-conditioned 2x2 channel (rank 2)
H_RANK2 = torch.tensor([[1.0 + 0.1j, 0.2 - 0.6j], [-0.5 + 0.3j, 0.9 + 0.0j]], dtype=torch.complex64)


def make_link(tm=1, nof_ports=1, nrx=1, mcs=5):
    cell = Cell(nof_prb=15, nof_ports=nof_ports, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=mcs, tm=tm, windowed_phy=True, phy_window=W, device=CPU)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), tm=tm, nrx=nrx, windowed_phy=True, phy_window=W,
                 device=CPU)
    return cell, enb, ue, mme, spgw


def registered(ue) -> bool:
    return ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED


def run(enb, ue, ul, n, stop=None, dl_hook=None):
    """n TTIs (or until `stop()`); returns the last UL subframe."""
    for _ in range(n):
        dl = enb.run_tti(ul)
        if dl_hook is not None:
            dl = dl_hook(dl)
        ul = ue.run_tti(dl)
        if stop is not None and stop():
            break
    return ul


@pytest.fixture(scope="module")
def attached():
    cell, enb, ue, mme, spgw = make_link()
    run(enb, ue, None, 150, lambda: registered(ue) and enb.rrc_state == EnbStack.RRC_ACTIVE)
    return cell, enb, ue, mme, spgw


def test_attach_completes_windowed(attached):
    _cell, enb, ue, mme, _spgw = attached
    assert enb.stats["prach_detected"] == 1
    assert ue.nas.state == ue.nas.REGISTERED
    assert IMSI in mme.attached_imsis
    assert ue.cipher_alg == 2 and ue.integ_alg == 2


def test_downlink_ip_traffic_rides_windows(attached):
    _cell, enb, ue, _mme, spgw = attached
    pkts = [bytes([i]) * 60 for i in range(4)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    win_before = ue._win_dl.stats["ttis"]
    run(enb, ue, None, 60, lambda: len(ue.ip_rx) >= len(pkts))
    assert ue.ip_rx[: len(pkts)] == pkts
    assert ue._win_dl.stats["ttis"] > win_before
    assert ue._win_dl.stats["windows"] >= 1
    ue.ip_rx.clear()


def test_uplink_ip_traffic_rides_windows(attached):
    _cell, enb, ue, _mme, spgw = attached
    pkts = [bytes([0x40 + i]) * 50 for i in range(3)]
    for p in pkts:
        ue.send_ip_packet(p)
    win_before = enb._win_ul.stats["ttis"]
    run(enb, ue, None, 80, lambda: len(spgw.sgi_rx) >= len(pkts))
    got = [pl for _, pl in spgw.sgi_rx]
    assert got[: len(pkts)] == pkts
    assert enb._win_ul.stats["ttis"] > win_before
    assert enb._win_ul.stats["windows"] >= 1
    spgw.sgi_rx.clear()


def test_windowed_dl_harq_recovers_outage():
    """Noise on the DL for 30 TTIs makes windowed decodes fail; the
    retransmissions combine through the plane's device softbuffers."""
    _cell, enb, ue, _mme, spgw = make_link()
    ul = run(enb, ue, None, 150, lambda: registered(ue))
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([0x70 + i]) * 80 for i in range(6)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    rng = np.random.default_rng(5)

    def noisy(dl):
        z = 1.2 * (rng.standard_normal(tuple(dl.shape)) + 1j * rng.standard_normal(tuple(dl.shape)))
        return dl + torch.from_numpy(z.astype(np.complex64))

    ul = run(enb, ue, ul, 30, dl_hook=noisy)
    run(enb, ue, ul, 100, lambda: len(ue.ip_rx) >= len(pkts))
    assert ue.ip_rx[: len(pkts)] == pkts
    assert ue._win_dl.stats["crc_ko"] > 0


def test_windowed_tm2_two_port():
    _cell, enb, ue, _mme, spgw = make_link(tm=2, nof_ports=2)
    ul = run(enb, ue, None, 150, lambda: registered(ue))
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([9]) * 40, bytes([8]) * 40]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    run(enb, ue, ul, 60, lambda: len(ue.ip_rx) >= len(pkts))
    assert ue.ip_rx[: len(pkts)] == pkts
    assert ue._win_dl.stats["ttis"] > 0


@pytest.mark.parametrize("tm", [3, 4])
def test_windowed_tm34_two_codeword_traffic(tm):
    _cell, enb, ue, _mme, spgw = make_link(tm=tm, nof_ports=2, nrx=2, mcs=8)
    channel = H_RANK2.__matmul__
    ul = run(enb, ue, None, 150, lambda: registered(ue), dl_hook=channel)
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([i]) * 200 for i in range(40)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    run(enb, ue, ul, 300, lambda: len(ue.ip_rx) >= len(pkts), dl_hook=channel)
    assert ue.ip_rx[: len(pkts)] == pkts
    assert ue._win_dl.mimo and ue._win_dl.stats["ttis"] > 0
