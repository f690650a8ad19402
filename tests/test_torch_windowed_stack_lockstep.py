"""The port's windowed control-plane stack
(`srsran_tpu_torch/apps/windowed_stack.py`) in lockstep with the reference's
(`srsran_tpu/apps/windowed_stack.py`) on the CPU, over the host-row link (no
channel, no noise) at the reference test's cell: 25 PRB, W = 12, MCS 8.

Both networks have the HSS's RAND state fixed.  The reference's realisation
polls are pinned to TTI counts (`RTT_HIDE` = 0 for this test only), which
is the port's contract: a window realises `RD` TTIs after its dispatch.  In
every TTI the DL and UL samples agree within 2e-6 of their largest
magnitude, and both ends' stats, RRC states and the UE's NAS state are
equal; at the end the IP and every packet are identical.  The port's rows
are device tensors, which its engines take as device-resident ingest (the
reference quantises its host rows to int16 first): the bar is on the
samples and the decisions, not on the control REs.
"""

import numpy as np
import torch

from srsran_tpu.apps import windowed_stack as r_ws
from srsran_tpu.epc import Hss as RHss, Mme as RMme, Spgw as RSpgw, Subscriber as RSubscriber
from srsran_tpu.phy.common import Cell as RCell
from srsran_tpu.stack.nas_ue import Usim as RUsim
from srsran_tpu_torch.apps import windowed_stack as t_ws
from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.stack import security as sec
from srsran_tpu_torch.stack.nas_ue import Usim

torch.set_num_threads(1)

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
W = 12
RAND_STATE = 0x5EED00C0FFEE
SAMPLE_RTOL = 2e-6  # of the subframe's largest magnitude
MAX_TTIS = 1200
DL_PKTS = [bytes([i]) * 200 for i in range(24)]
UL_PKTS = [bytes([0x45, i]) * 60 for i in range(8)]


def network(ws, cell_cls, hss_cls, spgw_cls, mme_cls, sub_cls, usim_cls, **dev):
    cell = cell_cls(nof_prb=25, nof_ports=1, id=7)
    hss = hss_cls()
    hss._rand_state = RAND_STATE
    hss.add_subscriber(sub_cls("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = spgw_cls()
    mme = mme_cls(hss, spgw)
    enb = ws.WindowedCtrlEnb(cell, mme, spgw, mcs=8, ctrl_window=W, **dev)
    ue = ws.WindowedCtrlUe(cell, usim_cls(IMSI, KEY, OPC), ctrl_window=W, **dev)
    return enb, ue, mme, spgw


def close(got, ref, what: str):
    assert (got is None) == (ref is None), what
    if ref is None:
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu", what
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.complex64, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= SAMPLE_RTOL * scale, f"{what}: {err} of {scale}"


def record(enb, ue) -> dict:
    return dict(enb=dict(enb.stats), ue=dict(ue.stats), enb_rrc=int(enb.rrc_state),
                ue_rrc=int(ue.rrc_state), nas=int(ue.nas.state))


def test_lockstep_windowed_stack_against_the_reference(monkeypatch):
    monkeypatch.setattr(r_ws, "RTT_HIDE", 0.0)
    r_enb, r_ue, r_mme, r_spgw = network(r_ws, RCell, RHss, RSpgw, RMme, RSubscriber, RUsim)
    t_enb, t_ue, t_mme, t_spgw = network(t_ws, Cell, Hss, Spgw, Mme, Subscriber, Usim, device="cpu")
    r_ul = t_ul = None
    reg_tti = None
    for tti in range(MAX_TTIS):
        r_dl = r_enb.run_tti(r_ul)
        t_dl = t_enb.run_tti(t_ul)
        close(t_dl, r_dl, f"DL samples of TTI {tti}")
        r_ul = r_ue.run_tti(r_dl)
        t_ul = t_ue.run_tti(t_dl)
        close(t_ul, r_ul, f"UL samples of TTI {tti}")
        assert record(t_enb, t_ue) == record(r_enb, r_ue), f"TTI {tti}"
        if reg_tti is None and r_ue.rrc_state == r_ue.RRC_ACTIVE and r_ue.nas.state == r_ue.nas.REGISTERED:
            reg_tti = tti
            for spgw, ue in ((r_spgw, r_ue), (t_spgw, t_ue)):
                for p in DL_PKTS:
                    spgw.sgi_tx(ue.ue_ip, p)
                for p in UL_PKTS:
                    ue.send_ip_packet(p)
        if reg_tti is not None and len(r_ue.ip_rx) >= len(DL_PKTS) and len(r_spgw.sgi_rx) >= len(UL_PKTS):
            break
    assert reg_tti is not None, "no attach"
    for ue, spgw, mme in ((r_ue, r_spgw, r_mme), (t_ue, t_spgw, t_mme)):
        assert ue.ip_rx == DL_PKTS
        assert [p for _ip, p in spgw.sgi_rx] == UL_PKTS
        assert IMSI in mme.attached_imsis
    assert t_ue.ue_ip == r_ue.ue_ip
    assert t_spgw.sgi_rx == r_spgw.sgi_rx
    assert t_ue.stats["ctrl_windows"] > 10 and t_enb.stats["dl_ack"] > 0
