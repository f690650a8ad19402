"""The port's windowed control-plane stack
(`srsran_tpu_torch/apps/windowed_stack.py`) on the CPU, with the asserts of
`tests/test_windowed_stack.py` at its cell (25 PRB, W = 12, MCS 8):

- the attach over the host-row link (the eNB's DL rows to the UE, the UE's
  UL rows to the eNB, complex64 tensors), IP both ways, the HARQ stats and
  the windowed discipline (`test_windowed_attach`,
  `test_windowed_ip_both_ways`, `test_windowed_harq_stats`);
- the device-resident loopback (`WindowedDeviceLoopback`: whole windows
  through `window_channel` at 30 dB, here on the CPU), attach and IP
  (`test_windowed_device_loopback`);
- the constructors take the card by default and raise without one; a
  window under 12, a 2-port cell and `tdd_cfg` are refused (the reference
  asserts where the port raises ValueError);
- the UL-HARQ repair the windowed eNB inherits: a released UE's windowed
  softbuffers (`("win", block)` at their retransmission TTIs) go with its
  grants, another UE's stay.

The synchronous HARQ under a fade, the lockstep against the reference and
`chip_smoke.py` phase 31's run are in `test_torch_windowed_stack_*.py`.
"""

import pytest
import torch

from srsran_tpu.apps import windowed_stack as r_ws
from srsran_tpu.phy.common import Cell as RCell
from srsran_tpu.phy.tdd import TddConfig
from srsran_tpu_torch.apps.windowed_stack import WindowedCtrlEnb, WindowedCtrlUe, WindowedDeviceLoopback
from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch.pusch import UlGrant
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


@pytest.fixture(scope="module")
def stacks():
    enb, ue, spgw = network()
    ul = None
    for _ in range(1800):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if registered(ue):
            break
    return enb, ue, spgw, ul


def test_windowed_attach(stacks):
    _enb, ue, _spgw, _ul = stacks
    assert ue.rrc_state == WindowedCtrlUe.RRC_ACTIVE
    assert ue.nas.state == ue.nas.REGISTERED
    assert ue.ue_ip is not None


def test_windowed_ip_both_ways(stacks):
    enb, ue, spgw, ul = stacks
    n0 = len(ue.ip_rx)
    for i in range(24):
        spgw.sgi_tx(ue.ue_ip, bytes([i]) * 200)
    spgw.sgi_rx.clear()
    for i in range(8):
        ue.send_ip_packet(bytes([0x45, i]) * 60)
    for _ in range(1200):
        dl = enb.run_tti(ul)
        assert isinstance(dl, torch.Tensor) and dl.dtype == torch.complex64 and dl.device.type == CPU
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) - n0 >= 24 and len(spgw.sgi_rx) >= 8:
            break
    assert len(ue.ip_rx) - n0 >= 24, (len(ue.ip_rx) - n0, enb.stats, ue.stats)
    assert len(spgw.sgi_rx) >= 8, (len(spgw.sgi_rx), enb.stats, ue.stats)
    assert spgw.sgi_rx[0][1] == bytes([0x45, 0]) * 60


def test_windowed_harq_stats(stacks):
    enb, ue, _spgw, _ul = stacks
    assert enb.stats.get("dl_ack", 0) >= 4
    assert enb.stats.get("ul_crc_ok", 0) >= 10
    assert ue.stats["dl_tbs_ok"] >= 5
    assert ue.stats["ctrl_windows"] > 10


def test_windowed_device_loopback():
    """Attach and IP with the baseband never leaving the device: the host
    carries only payload bits and the control reads."""
    enb, ue, spgw = network()
    link = WindowedDeviceLoopback(enb, ue, snr_db=30.0)
    for _ in range(1800):
        link.step()
        if registered(ue):
            break
    assert ue.nas.state == ue.nas.REGISTERED, (ue.rrc_state, enb.stats)
    spgw.sgi_rx.clear()
    for i in range(12):
        spgw.sgi_tx(ue.ue_ip, bytes([i]) * 200)
    for i in range(4):
        ue.send_ip_packet(bytes([0x46, i]) * 60)
    n0 = len(ue.ip_rx)
    for _ in range(900):
        link.step()
        if len(ue.ip_rx) - n0 >= 12 and len(spgw.sgi_rx) >= 4:
            break
    assert len(ue.ip_rx) - n0 >= 12, (len(ue.ip_rx) - n0, enb.stats)
    assert len(spgw.sgi_rx) >= 4, (len(spgw.sgi_rx), enb.stats, ue.stats)


def test_constructors_take_the_card_and_refuse_what_the_reference_refuses():
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    spgw = Spgw()
    mme = Mme(Hss(), spgw)
    usim = Usim(IMSI, KEY, OPC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowedCtrlEnb(cell, mme, spgw, ctrl_window=W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowedCtrlUe(cell, usim, ctrl_window=W)
    two_port = Cell(nof_prb=6, nof_ports=2, id=1)
    tdd = TddConfig(1, 7)
    for kw in (dict(cell=two_port), dict(ctrl_window=8), dict(tdd_cfg=tdd)):
        args = dict(dict(cell=cell, ctrl_window=W), **kw)
        with pytest.raises(ValueError):
            WindowedCtrlEnb(args.pop("cell"), mme, spgw, device=CPU, **args)
        r_args = dict(dict(cell=RCell(nof_prb=6, nof_ports=two_port.nof_ports if "cell" in kw else 1, id=1),
                           ctrl_window=W), **{k: v for k, v in kw.items() if k != "cell"})
        with pytest.raises(AssertionError):
            r_ws.WindowedCtrlEnb(r_args.pop("cell"), None, None, **r_args)
    for kw in (dict(cell=two_port), dict(ctrl_window=8)):
        args = dict(dict(cell=cell, ctrl_window=W), **kw)
        with pytest.raises(ValueError):
            WindowedCtrlUe(args.pop("cell"), usim, device=CPU, **args)


def test_released_ue_leaves_no_windowed_softbuffer_behind():
    """`_ul_poll` takes `_ul_harq[u]` by TTI without checking the RNTI: a
    released UE's `("win", block)` softbuffer must go with its grant (the
    repair of the per-TTI eNB, inherited), another UE's must stay."""
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    spgw = Spgw()
    enb = WindowedCtrlEnb(cell, Mme(Hss(), spgw), spgw, ctrl_window=W, device=CPU)
    a, b = enb._new_ue(rapid=5), enb._new_ue(rapid=6)
    for t, ue in ((70, a), (71, b)):
        grant = UlGrant(prb_start=1, nof_prb=4, mod=Mod.QPSK, tbs=256, rnti=ue.crnti)
        enb.pending_ul[t] = (ue.crnti, grant)
        enb._ul_harq[t] = (("win", torch.zeros(16, 3, 6148)), 1)
    enb._release_ue(a, notify_mme=False)
    assert 70 not in enb.pending_ul and 70 not in enb._ul_harq
    assert enb.pending_ul[71][0] == b.crnti and enb._ul_harq[71][0][0] == "win"
