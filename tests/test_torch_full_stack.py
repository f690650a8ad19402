"""The port's per-TTI LTE stack (`srsran_tpu_torch/apps/full_stack.py`)
against the reference's on the CPU, at 15 PRB.

- A lockstep attach: the reference's and the port's stacks (the HSS's
  RAND state fixed on both) run `chip_smoke.StackRun` side by side — the
  attach with SRS and SR on, then DL and UL IP packets.  In every TTI the
  DL and UL samples agree within 2e-6 of their largest magnitude, and
  both ends' stats, RRC states and the UE's NAS state are equal; the IP,
  IMSIs and packets at the end are identical.
- Crossed pairs: the reference's eNB with the port's UE and the port's
  eNB with the reference's UE attach and carry a packet each way.
- The constructors take the card by default (and raise without one);
  TDD and the kernel TUN raise NotImplementedError.
- The drivers of `chip_smoke.py` phases 29 (two UEs through EPA fading
  with AWGN) and 30 (the dynamic and windowed data planes) at 15 PRB.
- Two faults of the reference's eNB that the port repairs (ROADMAP Queue
  3): a released UE's, or a displaced retransmission's, UL HARQ
  softbuffer must not stay behind for a later grant at its TTI.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from srsran_tpu.apps import full_stack as r_fs
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.tdd import TddConfig
from srsran_tpu.stack.nas_ue import Usim
from srsran_tpu.stack.security import compute_opc
from srsran_tpu_torch.apps import full_stack as t_fs

torch.set_num_threads(1)

CPU = "cpu"
PRB = 15
SAMPLE_RTOL = 2e-6  # of the subframe's largest magnitude
KW = dict(srs_enabled=True, sr_enabled=True)
REF = SimpleNamespace(EnbStack=r_fs.EnbStack, UeStack=r_fs.UeStack, Cell=Cell, Hss=Hss, Mme=Mme,
                      Spgw=Spgw, Subscriber=Subscriber, Usim=Usim, compute_opc=compute_opc)
PORT = chip_smoke.port_stack_modules()


def close(got: torch.Tensor, ref, what: str):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= SAMPLE_RTOL * scale, f"{what}: {err} of {scale}"


def test_lockstep_attach_against_the_reference():
    r = chip_smoke.stack_pair(REF, PRB, enb_kw=KW, ue_kw=[KW])
    t = chip_smoke.stack_pair(PORT, PRB, enb_kw=KW, ue_kw=[KW], device=CPU)
    rr = chip_smoke.StackRun(r.enb, r.ues[0], r.mme, r.spgw)
    tr = chip_smoke.StackRun(t.enb, t.ues[0], t.mme, t.spgw)
    n_ul = 0
    while rr.tti < chip_smoke.STACK["max_attach"] + chip_smoke.STACK["max_traffic"]:
        dl_r, ul_r = rr.step()
        dl_t, ul_t = tr.step()
        tti = rr.tti - 1
        assert isinstance(dl_t, torch.Tensor) and dl_t.device.type == CPU
        close(dl_t, dl_r, f"DL samples of TTI {tti}")
        assert (ul_t is None) == (ul_r is None), f"UL of TTI {tti}"
        if ul_r is not None:
            close(ul_t, ul_r, f"UL samples of TTI {tti}")
            n_ul += 1
        assert tr.records[-1] == rr.records[-1], f"TTI {tti}"
        if rr.delivered() and tr.delivered():
            break
    rr.check_traffic("reference")
    tr.check_traffic("port")
    assert tr.result() == rr.result()
    assert rr.reg_tti is not None and n_ul > 10
    # SRS and SR were exercised on the way
    assert tr.records[-1]["enb"].get("srs_meas", 0) > 0
    assert tr.records[-1]["ue"].get("sr_sent", 0) > 0


@pytest.mark.parametrize("port_end", ["ue", "enb"])
def test_crossed_pair_attaches_and_carries_traffic(port_end):
    """The reference's eNB with the port's UE, and the port's eNB with the
    reference's UE: the samples cross between the packages."""
    to_port = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    to_ref = lambda x: x.numpy()  # noqa: E731
    enb_m, ue_m = (REF, PORT) if port_end == "ue" else (PORT, REF)
    e = chip_smoke.stack_pair(enb_m, PRB, **({"device": CPU} if enb_m is PORT else {}))
    u = chip_smoke.stack_pair(ue_m, PRB, **({"device": CPU} if ue_m is PORT else {}))
    # one network, the UE of the other package's pair
    ue = u.ues[0]
    links = (to_port, to_ref) if port_end == "ue" else (to_ref, to_port)
    run = chip_smoke.StackRun(e.enb, ue, e.mme, e.spgw, dl=(1, 300), ul=(1, 300),
                              link_dl=links[0], link_ul=links[1]).run()
    run.check_traffic(f"port {port_end}")
    assert e.enb.stats["prach_detected"] == 1


def test_constructors_take_the_card_by_default():
    cell = PORT.Cell(nof_prb=6, nof_ports=1, id=1)
    spgw = PORT.Spgw()
    mme = PORT.Mme(PORT.Hss(), spgw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fs.EnbStack(cell, mme, spgw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fs.UeStack(cell, PORT.Usim("001010123456789", bytes(16), bytes(16)))
    ue = t_fs.UeStack(cell, PORT.Usim("001010123456789", bytes(16), bytes(16)), device=CPU)
    assert ue.device == torch.device(CPU)


def test_tdd_and_the_tun_are_not_ported():
    cell = PORT.Cell(nof_prb=6, nof_ports=1, id=1)
    spgw = PORT.Spgw()
    mme = PORT.Mme(PORT.Hss(), spgw)
    usim = PORT.Usim("001010123456789", bytes(16), bytes(16))
    tdd = TddConfig(1, 7)
    with pytest.raises(NotImplementedError, match="Slice 10"):
        t_fs.EnbStack(cell, mme, spgw, tdd_cfg=tdd, device=CPU)
    with pytest.raises(NotImplementedError, match="Slice 10"):
        t_fs.UeStack(cell, usim, tdd_cfg=tdd, device=CPU)
    with pytest.raises(NotImplementedError, match="io/"):
        t_fs.UeStack(cell, usim, device=CPU).attach_tun()


def test_stack_link_driver_two_ues_through_fading():
    """`chip_smoke.py` phase 29's driver at 15 PRB: two UEs through EPA
    fading with AWGN attach and carry every packet (its gates)."""
    rec = chip_smoke.stack_link_run(CPU, PRB)
    s = rec["stack"]
    assert s.enb.stats["prach_detected"] == 2
    assert all(chip_smoke.stack_registered(u) for u in s.ues)
    assert rec["dl_bits"] > 0 and rec["ul_bits"] > 0
    assert {"attach", "dl", "ul"} <= set(rec["phase"])
    assert all(len(v) == len(rec["phase"]) for v in rec["ue_ms"])


def test_stack_planes_driver_dynamic_and_windowed():
    """`chip_smoke.py` phase 30's driver at 15 PRB: one attach with
    `dynamic_phy=True` and one with `windowed_phy=True` (W = 4), both
    ends on their plane."""
    runs = chip_smoke.stack_planes_run(CPU, PRB)
    assert sorted(runs) == ["dynamic", "windowed"]
    for mode, (run, plane, _secs) in runs.items():
        assert run.ue.ip_rx == run.dl_pkts, mode
        assert plane[0]["ttis"] > 0 and plane[1]["ttis"] > 0, mode
    assert runs["windowed"][0].enb.harq_delay == runs["windowed"][0].ue.harq_delay == 8


def _with_pending_retx(m, **dev):
    """An eNB of package m with a UE context whose UL retransmission (and
    its HARQ softbuffer) is pending at TTI 12."""
    cell = m.Cell(nof_prb=6, nof_ports=1, id=1)
    spgw = m.Spgw()
    enb = m.EnbStack(cell, m.Mme(m.Hss(), spgw), spgw, **dev)
    ue = enb._new_ue(rapid=5)
    fs = r_fs if m is REF else t_fs
    grant = fs.UlGrant(prb_start=1, nof_prb=4, mod=fs.ul_mcs_to_mod(5), tbs=256, rnti=ue.crnti)
    enb.pending_ul[12] = (ue.crnti, grant)
    enb._ul_harq[12] = ([None], 1)
    return enb, ue


def test_released_ue_leaves_no_ul_softbuffer_behind():
    """The reference keeps a released UE's UL HARQ softbuffer at its
    retransmission TTI, where a later grant of another size would combine
    into it; the port drops it with the grant."""
    ref, ue_r = _with_pending_retx(REF)
    ref._release_ue(ue_r, notify_mme=False)
    assert 12 not in ref.pending_ul and 12 in ref._ul_harq  # the reference's fault
    port, ue_t = _with_pending_retx(PORT, device=CPU)
    port._release_ue(ue_t, notify_mme=False)
    assert 12 not in port.pending_ul and 12 not in port._ul_harq


def test_msg3_reservation_drops_a_displaced_softbuffer():
    """A RAR reserves its Msg3 occasion over a pending retransmission: the
    port's eNB drops the retransmission's softbuffer with it."""
    port, _ue = _with_pending_retx(PORT, device=CPU)
    port.tti = 8
    port.pending_rars.append((17, 0, port._next_crnti))
    port._sched_dl(8, 8)
    assert port.pending_ul[12][0] == port._next_crnti  # Msg3 took TTI 8 + 4
    assert 12 not in port._ul_harq
