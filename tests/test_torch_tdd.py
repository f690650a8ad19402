"""TDD (frame structure 2) on the port against the JAX reference, on the CPU.

- The cases of `tests/test_tdd.py` `TestTddPhy` and `TestAckMultiplexing`
  on the port's modules: sync positions, silent UL subframes, DwPTS and D
  subframe PDSCH end to end, the skipped UL decode, the frame-type cell
  search, `UeSync` on a TDD stream, the multiplexed ACKs, and both
  full-stack attaches at 15 PRB (configurations 1 and 2).
- `enb_dl_subframe(tdd=)` against the reference's for every subframe type
  (D, S with PSS, D with SSS and PBCH, U): grid within 1e-6, samples within
  2e-6 (absolute; unit-power OFDM).
- `pdsch_encode_np`, `pdsch_decode` and `ue_dl_decode_subframe(tdd=)` on a
  DwPTS subframe and on a D subframe: the coded grid within 1e-6, TB bits,
  CRC verdicts, DCIs, CFI identical; softbuffers within 2e-6 of their
  largest magnitude; the measurements within 1e-4 relative.
- Lockstep attaches at 15 PRB under `TddConfig(1, 4)` and `TddConfig(2,
  4)` with SR on: in every TTI both ends' samples within 2e-6 of their largest magnitude and stats,
  RRC and NAS states equal; the same IP and packets at the end.
- The two faults of the reference's TDD stack that the port repairs, each
  run on both packages, identical up to the TTI on which the repair first
  acts: with SRS and SR on, one UE attaches (the reference's is released);
  two UEs under `TddConfig(2, 4)`, with and without SRs, both stay attached
  (the reference releases UE 0).
Inputs are numpy arrays made from a seed and given to both packages.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
import srsran_tpu.phy.phch.pdsch as r_pdsch
from srsran_tpu.apps import full_stack as r_fs
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy import tdd as r_tdd
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.enb.enb_dl import DlSched as RDlSched, enb_dl_subframe as r_enb_dl
from srsran_tpu.phy.phch.dci import Dci1A as RDci1A
from srsran_tpu.phy.phch.ra import riv_encode
from srsran_tpu.phy.ue.ue_dl import ue_dl_decode_subframe as r_decode
from srsran_tpu.stack.nas_ue import Usim
from srsran_tpu.stack.security import compute_opc
import srsran_tpu_torch.phy.phch.pdsch as t_pdsch
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.phy import tdd
from srsran_tpu_torch.phy.enb.enb_dl import DlSched, enb_dl_subframe
from srsran_tpu_torch.phy.phch.dci import Dci1A
from srsran_tpu_torch.phy.phch.pdsch import DlGrant
from srsran_tpu_torch.phy.phch.pucch import (
    ACK, DTX, NACK, tdd_channel_selection, tdd_channel_selection_decode)
from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe
from srsran_tpu_torch.phy.ue.ue_sync import UeSync, cell_search

torch.set_num_threads(1)

CPU = "cpu"
GRID_ATOL = 1e-6
SAMPLE_ATOL = 2e-6
SB_REL = 2e-6  # softbuffers, of their largest magnitude
MEAS_RTOL = 1e-4
PORT = chip_smoke.port_stack_modules()
REF = SimpleNamespace(EnbStack=r_fs.EnbStack, UeStack=r_fs.UeStack, Cell=Cell, Hss=Hss, Mme=Mme,
                      Spgw=Spgw, Subscriber=Subscriber, Usim=Usim, compute_opc=compute_opc,
                      TddConfig=r_tdd.TddConfig)
PCELL = from_reference(Cell(nof_prb=25, nof_ports=1, id=123))
IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OP = bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d")


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


# --- tests/test_tdd.py TestTddPhy on the port -----------------------------------


def test_sync_positions():
    cfg = tdd.TddConfig(1, 4)
    g1, _ = enb_dl_subframe(PCELL, 1, DlSched(cfi=1), tdd=cfg, device=CPU)
    c0 = (PCELL.nof_prb // 2) * 12 - 36 + 6 * (PCELL.nof_prb % 2)
    # PSS on symbol 2 of sf 1 (TS 36.211 §6.11.1.2)
    assert np.abs(g1[0, 2, c0 + 5: c0 + 67]).min() > 0
    g0, _ = enb_dl_subframe(PCELL, 0, DlSched(cfi=1), tdd=cfg, device=CPU)
    # SSS on the last symbol of sf 0 (§6.11.2.2); the FDD positions empty
    assert np.abs(g0[0, -1, c0 + 5: c0 + 67]).min() > 0
    assert np.abs(g0[0, PCELL.nsymb_per_slot - 1]).max() == 0


def test_uplink_subframe_is_silent():
    _, samples = enb_dl_subframe(PCELL, 2, DlSched(), tdd=tdd.TddConfig(1, 4), device=CPU)
    assert samples.device.type == CPU and float(samples.abs().max()) == 0


def dl_sched(cell, mcs: int, l_crb: int, dwpts: bool, seed: int, dai: int = 0, cfi: int = 1):
    """A 1A grant at TDD size for 0x4601 and its TB: (DlSched, grant, tb)."""
    rng = np.random.default_rng(seed)
    tbs = dl_tbs(mcs, l_crb, dwpts=dwpts)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    grant = DlGrant(prb=tuple(range(l_crb)), mod=dl_mcs_to_mod(mcs), tbs=tbs, rnti=0x4601)
    dci = Dci1A(riv=riv_encode(cell.nof_prb, 0, l_crb), mcs=mcs, dai=dai)
    return DlSched(cfi=cfi, dcis=[(dci.pack(cell.nof_prb, tdd=True), 0x4601, 4, 0)],
                  grants=[(grant, tb)]), grant, tb


@pytest.mark.parametrize("ss_config", [3, 4, 8])
def test_special_subframe_pdsch_e2e(ss_config):
    """The eNB renders a DwPTS PDSCH in sf 1; the UE decodes it."""
    cfg = tdd.TddConfig(1, ss_config)
    assert dl_tbs(9, 25, dwpts=True) < dl_tbs(9, 25)  # the 0.75 rule bites
    sched, _grant, tb = dl_sched(PCELL, 9, 25, True, 7)
    _, samples = enb_dl_subframe(PCELL, 1, sched, tdd=cfg, device=CPU)
    res = ue_dl_decode_subframe(PCELL, samples, 1, 0x4601, known_cfi=1, tdd=cfg, device=CPU)
    assert res.tbs and res.tbs[0][1]
    np.testing.assert_array_equal(res.tbs[0][0], tb)


def test_ul_subframe_decode_skipped():
    z = np.zeros((1, PCELL.sf_len), np.complex64)
    res = ue_dl_decode_subframe(PCELL, z, 2, 0x4601, tdd=tdd.TddConfig(1, 4), device=CPU)
    assert res.tbs == [] and res.dcis == []


def test_normal_dl_subframe_tdd_e2e():
    cfg = tdd.TddConfig(2, 4)
    sched, _grant, tb = dl_sched(PCELL, 12, 25, False, 3, dai=1)
    _, samples = enb_dl_subframe(PCELL, 4, sched, tdd=cfg, device=CPU)
    res = ue_dl_decode_subframe(PCELL, samples, 4, 0x4601, known_cfi=1, tdd=cfg, device=CPU)
    assert res.tbs and res.tbs[0][1]
    np.testing.assert_array_equal(res.tbs[0][0], tb)


def test_cell_search_detects_frame_type():
    """A TDD frame is found as TDD with the right PCI, an FDD frame as FDD."""
    cell = from_reference(Cell(nof_prb=6, nof_ports=1, id=151))
    rng = np.random.default_rng(5)

    def frames(tdd_cfg, n_sf=20):
        x = torch.cat([enb_dl_subframe(cell, i % 10, DlSched(cfi=1), tdd=tdd_cfg, device=CPU)[1][0]
                       for i in range(n_sf)]).numpy()
        return awgn(rng, x, 0.02)

    res = cell_search(frames(tdd.TddConfig(1, 4)), 6, device=CPU)
    assert res is not None and res.frame_type == "tdd"
    assert res.cell_id == 151 and res.sf_idx in (0, 5)
    res_fdd = cell_search(frames(None), 6, device=CPU)
    assert res_fdd is not None and res_fdd.frame_type == "fdd" and res_fdd.cell_id == 151


def test_ue_sync_tracks_tdd_stream():
    """FIND → TRACK on a TDD stream: a PDSCH placed in sf 4 decodes at the
    delivered sf 4."""
    cell = from_reference(Cell(nof_prb=6, nof_ports=1, id=151))
    cfg = tdd.TddConfig(1, 4)
    sched4, _grant, tb = dl_sched(cell, 7, 6, False, 11, cfi=2)
    x = torch.cat([enb_dl_subframe(cell, i % 10, sched4 if i % 10 == 4 else DlSched(cfi=2),
                                   tdd=cfg, device=CPU)[1][0] for i in range(30)])
    sync = UeSync(nof_prb=6, device=CPU)
    sync.push(x)
    got = 0
    while (out := sync.pop_subframe()) is not None:
        sf, idx = out
        if idx == 4 and sync.state == UeSync.TRACK:
            res = ue_dl_decode_subframe(cell, sf[None, :], 4, 0x4601, known_cfi=2, tdd=cfg,
                                        device=CPU)
            got += bool(res.tbs and res.tbs[0][1] and np.array_equal(res.tbs[0][0], tb))
    assert sync.frame_type == "tdd" and got >= 1


def tdd_stack(cfg, mcs=5):
    """The port's EPC, `EnbStack` and `UeStack` on tests/test_tdd.py's 15 PRB
    cell under `cfg`."""
    cell = PORT.Cell(nof_prb=15, nof_ports=1, id=7)
    hss = PORT.Hss()
    opc = PORT.compute_opc(KEY, OP)
    hss.add_subscriber(PORT.Subscriber("ue1", IMSI, KEY, opc, amf=b"\x80\x00", sqn=0))
    spgw = PORT.Spgw()
    mme = PORT.Mme(hss, spgw)
    enb = PORT.EnbStack(cell, mme, spgw, mcs=mcs, tdd_cfg=cfg, device=CPU)
    ue = PORT.UeStack(cell, PORT.Usim(IMSI, KEY, opc), tdd_cfg=cfg, device=CPU)
    return enb, ue, spgw


def test_full_stack_tdd_attach_and_traffic():
    """Attach and IP both ways over a configuration-1 cell: PRACH on sf 2,
    DL data on D subframes, PUSCH on U subframes only."""
    cfg = tdd.TddConfig(1, 4)
    enb, ue, spgw = tdd_stack(cfg)
    ul = None
    for _ in range(200):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        # a UE never transmits on a non-UL subframe
        if ul is not None and float(ul.abs().max()) > 0:
            assert tdd.sf_type(cfg, ue.tti - 1) == tdd.SfType.U
        if chip_smoke.stack_registered(ue):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    assert enb.stats["prach_detected"] == 1 and ue.stats["rar"] == 1
    pkts = [bytes([i]) * 48 for i in range(3)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
        ue.send_ip_packet(bytes([0x80 ^ p[0]]) * 40)
    for _ in range(80):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= 3 and len(spgw.sgi_rx) >= 3:
            break
    assert ue.ip_rx[:3] == pkts and len(spgw.sgi_rx) >= 3


# --- tests/test_tdd.py TestAckMultiplexing on the port ---------------------------


def test_no_false_acks():
    """Over every reachable state pattern a decoded ACK implies a sent ACK."""
    for m in (2, 3, 4):
        for states in itertools.product((ACK, NACK, DTX), repeat=m):
            if all(s == DTX for s in states):
                continue
            res, (b0, b1) = tdd_channel_selection(list(states))
            mask = tdd_channel_selection_decode(res, b0, b1, m)
            for i, s in enumerate(states):
                if mask[i]:
                    assert s == ACK, (m, states, res, (b0, b1), mask)


def test_all_ack_roundtrip():
    for m in (2, 3, 4):
        res, (b0, b1) = tdd_channel_selection([ACK] * m)
        assert tdd_channel_selection_decode(res, b0, b1, m) == (True,) * m


def test_selected_resource_known_without_dtx():
    for m in (2, 3, 4):
        for states in itertools.product((ACK, NACK), repeat=m):
            res, _ = tdd_channel_selection(list(states))
            assert 0 <= res < m


def test_e2e_tdd_cfg2_traffic_multiplexed():
    """Configuration 2 (M = 4 association sets): attach, then DL traffic
    with multiplexed ACKs driving the scheduler."""
    enb, ue, spgw = tdd_stack(tdd.TddConfig(2, 4))
    ul = None
    for _ in range(250):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if chip_smoke.stack_registered(ue):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([i]) * 64 for i in range(4)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for _ in range(120):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert sorted(ue.ip_rx) == sorted(pkts)
    assert enb.stats.get("dl_ack", 0) > 0


# --- against the reference ------------------------------------------------------


def both_dl_scheds(cell, sf_idx: int, cfg, mcs: int, seed: int):
    """The same TDD schedule for both packages: a 1A grant with its TB where
    the subframe carries PDSCH, PHICH, and nothing on a U subframe."""
    rng = np.random.default_rng(seed)
    sftype = tdd.sf_type(cfg, sf_idx)
    r, t = RDlSched(cfi=2), DlSched(cfi=2)
    if sftype == tdd.SfType.U:
        return r, t
    l_crb = cell.nof_prb - 2
    tbs = dl_tbs(mcs, l_crb, dwpts=sftype == tdd.SfType.S)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    dci = RDci1A(riv=riv_encode(cell.nof_prb, 1, l_crb), mcs=mcs, dai=2).pack(cell.nof_prb, tdd=True)
    rg = r_pdsch.DlGrant(prb=tuple(range(1, 1 + l_crb)), mod=dl_mcs_to_mod(mcs), tbs=tbs, rnti=0x4601)
    r.dcis.append((dci, 0x4601, 4, 0))
    r.grants.append((rg, tb))
    r.phich.append((0, 2, True))
    t.dcis.append((np.array(dci, np.uint8), 0x4601, 4, 0))
    t.grants.append((from_reference(rg), tb))
    t.phich.append((0, 2, True))
    return r, t


# (UL/DL config, special-subframe config, subframe): D with SSS and PBCH,
# S with the PSS (DwPTS of 3, 6, 10 and 11 symbols), U, plain D, the second
# half-frame's S and SSS
TDD_SUBFRAMES = [(1, 4, 0), (1, 4, 1), (1, 4, 2), (1, 4, 4), (1, 4, 5), (1, 4, 6), (2, 0, 1),
                 (2, 7, 6), (0, 9, 1), (6, 3, 3), (1, 8, 1)]


@pytest.mark.parametrize("sf_config,ss_config,sf_idx", TDD_SUBFRAMES)
def test_enb_dl_subframe_tdd_against_reference(sf_config, ss_config, sf_idx):
    cell = Cell(nof_prb=15, nof_ports=1, id=123)
    rcfg = r_tdd.TddConfig(sf_config, ss_config)
    r_sched, t_sched = both_dl_scheds(cell, sf_idx, rcfg, 11, sf_idx)
    from srsran_tpu.phy.phch.pbch import Mib as RMib

    mib = RMib(nof_prb=15)
    r_grid, r_samples = r_enb_dl(cell, sf_idx, r_sched, mib=mib, sfn=3, tdd=rcfg)
    g_grid, g_samples = enb_dl_subframe(from_reference(cell), sf_idx, t_sched, mib=from_reference(mib),
                                        sfn=3, tdd=from_reference(rcfg), device=CPU)
    np.testing.assert_allclose(g_grid, r_grid, rtol=0, atol=GRID_ATOL)
    np.testing.assert_allclose(g_samples.numpy(), np.asarray(r_samples), rtol=0, atol=SAMPLE_ATOL)
    if tdd.sf_type(from_reference(rcfg), sf_idx) == tdd.SfType.S:
        assert np.abs(g_grid[:, tdd.nof_dw(from_reference(rcfg)):]).max() == 0


@pytest.mark.parametrize("sf_config,ss_config,sf_idx", [(1, 4, 1), (2, 7, 6), (1, 4, 4), (1, 4, 5)])
def test_pdsch_tdd_encode_and_decode_against_reference(sf_config, ss_config, sf_idx):
    """`pdsch_encode_np(tdd=, last_symbol=)` and `pdsch_decode(tdd=,
    last_symbol=)` on a DwPTS and on D subframes (a noisy channel estimate of
    ones): the grid, bits, CRC and softbuffers as the reference's."""
    import jax.numpy as jnp

    cell = Cell(nof_prb=25, nof_ports=1, id=41)
    rcfg = r_tdd.TddConfig(sf_config, ss_config)
    dwpts = r_tdd.sf_type(rcfg, sf_idx) == r_tdd.SfType.S
    last = r_tdd.nof_dw(rcfg) if dwpts else None
    rng = np.random.default_rng(sf_idx)
    tbs = dl_tbs(16, 25, dwpts=dwpts)
    rg = r_pdsch.DlGrant(prb=tuple(range(25)), mod=dl_mcs_to_mod(16), tbs=tbs, rnti=0x4601)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    r_grid = r_pdsch.pdsch_encode_np(cell, sf_idx, 2, rg, tb, tdd=True, last_symbol=last)
    g_grid = t_pdsch.pdsch_encode_np(from_reference(cell), sf_idx, 2, from_reference(rg), tb,
                                     tdd=True, last_symbol=last)
    np.testing.assert_allclose(g_grid, r_grid, rtol=0, atol=GRID_ATOL)
    rx = awgn(rng, r_grid, 0.15)
    ce = np.ones((1, 1) + rx.shape[1:], np.complex64)
    ref = r_pdsch.pdsch_decode(jnp.asarray(rx), jnp.asarray(ce), 0.045, cell, sf_idx, 2, rg, 5,
                               tdd=True, last_symbol=last)
    got = t_pdsch.pdsch_decode(torch.from_numpy(rx), torch.from_numpy(ce), 0.045,
                               from_reference(cell), sf_idx, 2, from_reference(rg), 5,
                               tdd=True, last_symbol=last)
    assert got[1] == bool(ref[1]) and got[1]
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    for g, r in zip(got[2], ref[2]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=SB_REL * float(np.abs(r).max()))


@pytest.mark.parametrize("sf_config,ss_config,sf_idx", [(1, 4, 1), (1, 7, 6), (1, 4, 4), (2, 4, 8)])
def test_ue_dl_decode_subframe_tdd_against_reference(sf_config, ss_config, sf_idx):
    """A DwPTS and D subframes rendered by the reference's eNB, noisy, through
    both UEs: CFI, DCIs, bits, CRC, the DCI used and its CCE identical."""
    cell = Cell(nof_prb=15, nof_ports=1, id=123)
    rcfg = r_tdd.TddConfig(sf_config, ss_config)
    r_sched, _ = both_dl_scheds(cell, sf_idx, rcfg, 9, 100 + sf_idx)
    _, samples = r_enb_dl(cell, sf_idx, r_sched, tdd=rcfg)
    rx = awgn(np.random.default_rng(sf_idx), np.asarray(samples), 0.02)
    ref = r_decode(cell, rx, sf_idx, 0x4601, tdd=rcfg, phich=(0, 2))
    got = ue_dl_decode_subframe(from_reference(cell), rx, sf_idx, 0x4601, tdd=from_reference(rcfg),
                                phich=(0, 2), device=CPU)
    assert got.cfi == ref.cfi == 2 and got.phich_ack == ref.phich_ack
    assert [(np.array(b).tolist(), a, c) for b, a, c in got.dcis] == \
        [(np.asarray(b).tolist(), a, c) for b, a, c in ref.dcis]
    assert (got.dci_format, got.cce_used) == (ref.dci_format, ref.cce_used) == ("1A", 0)
    assert [ok for _, ok in got.tbs] == [bool(ok) for _, ok in ref.tbs] == [True]
    np.testing.assert_array_equal(got.tbs[0][0], np.asarray(ref.tbs[0][0]))
    for k in ("rsrp", "noise"):
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k), rtol=MEAS_RTOL)


@pytest.mark.parametrize("sf_config", [1, 2])
def test_lockstep_tdd_attach_against_the_reference(sf_config):
    """The reference's and the port's stacks under `TddConfig(1, 4)` and
    `TddConfig(2, 4)` (M = 4: channel-selection ACKs) at 15 PRB, SR on,
    side by side through `chip_smoke.StackRun`."""
    kw = dict(sr_enabled=True)
    rcfg = r_tdd.TddConfig(sf_config, 4)
    r = chip_smoke.stack_pair(REF, 15, enb_kw=dict(kw, tdd_cfg=rcfg), ue_kw=[dict(kw, tdd_cfg=rcfg)])
    tcfg = from_reference(rcfg)
    t = chip_smoke.stack_pair(PORT, 15, enb_kw=dict(kw, tdd_cfg=tcfg), ue_kw=[dict(kw, tdd_cfg=tcfg)],
                              device=CPU)
    traffic = dict(dl=chip_smoke.STACK_TDD["dl"], ul=chip_smoke.STACK_TDD["ul"])
    rr = chip_smoke.StackRun(r.enb, r.ues[0], r.mme, r.spgw, **traffic)
    tr = chip_smoke.StackRun(t.enb, t.ues[0], t.mme, t.spgw, **traffic)
    n_ul = 0
    while rr.tti < chip_smoke.STACK["max_attach"] + chip_smoke.STACK["max_traffic"]:
        dl_r, ul_r = rr.step()
        dl_t, ul_t = tr.step()
        tti = rr.tti - 1
        ref = np.asarray(dl_r)
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(dl_t.numpy() - ref).max()) <= SAMPLE_ATOL * scale, f"DL of TTI {tti}"
        assert (ul_t is None) == (ul_r is None), f"UL of TTI {tti}"
        if ul_r is not None:
            ref = np.asarray(ul_r)
            scale = max(float(np.abs(ref).max()), 1e-30)
            assert float(np.abs(ul_t.numpy() - ref).max()) <= SAMPLE_ATOL * scale, f"UL of TTI {tti}"
            if float(np.abs(ref).max()) > 0:
                assert tdd.sf_type(tcfg, tti) == tdd.SfType.U
                n_ul += 1
        assert tr.records[-1] == rr.records[-1], f"TTI {tti}"
        if rr.delivered() and tr.delivered():
            break
    rr.check_traffic("reference")
    tr.check_traffic("port")
    assert tr.result() == rr.result() and n_ul > 5
    assert tr.records[-1]["enb"]["prach_detected"] == 1 and tr.records[-1]["ue"]["sr_sent"] > 0


# --- the stored TDD attach (chip_smoke.py phase 35) ---------------------------------


def test_tdd_stack_fixture_is_current():
    """The stored TDD attach was made with the script's constants of today
    (`tools/make_torch_fixture.py` `main_stack_tdd`, ~35 s) and stays small."""
    import json

    fx = json.loads(chip_smoke.FIXTURE_STACK_TDD.read_text())
    T = chip_smoke.STACK_TDD
    assert chip_smoke.FIXTURE_STACK_TDD.stat().st_size < 2**16
    assert fx["nof_prb"] == 100 and fx["enb_kw"] == fx["ue_kw"] == T["kw"]
    assert fx["tdd"] == list(T["tdd"]) and fx["traffic"] == [list(T["dl"]), list(T["ul"])]
    assert fx["stack"] == json.loads(json.dumps(chip_smoke.STACK))
    assert fx["result"]["ttis"] == len(fx["records"]) and fx["result"]["reg_tti"] is not None


def test_port_runs_tdd_stack_fixture_like_reference():
    """Phase 35's checks on the CPU: the port's stack gives the reference's
    stats, RRC and NAS states in every TTI of the stored TDD attach, its IP,
    IMSIs and packets."""
    import json

    fx = json.loads(chip_smoke.FIXTURE_STACK_TDD.read_text())
    run = chip_smoke.stored_stack_run(PORT, fx, device=CPU).run(len(fx["records"]))
    assert chip_smoke.check_stack_fixture(fx, run) == len(fx["records"])
    run.check_traffic("stored TDD attach")


def test_stack_link_run_tdd():
    """`chip_smoke.py` phase 36's `stack_link_run` at 15 PRB: one UE under
    `TddConfig(2, 4)` through EPA fading with AWGN attaches (PRACH on
    subframe 2) and carries every packet, with the TDD gates (no UE energy
    outside U subframes, the eNB silent in U and past the DwPTS, DL HARQ
    ACKs)."""
    T = chip_smoke.STACK_LINK_TDD
    rec = chip_smoke.stack_link_run(CPU, 15, tdd=T["tdd"], n_ues=T["n_ues"])
    s = rec["stack"]
    assert rec["prach_sf"] == [2] and s.enb.stats["dl_ack"] > 0
    assert all(chip_smoke.stack_registered(u) for u in s.ues)
    assert rec["dl_bits"] > 0 and rec["ul_bits"] > 0
    kinds = {tdd.sf_type(s.enb.tdd, sf) for sf in rec["sf"]}
    assert kinds == {tdd.SfType.D, tdd.SfType.S, tdd.SfType.U}


# --- the two TDD faults of the reference, repaired in the port ----------------------

# the eNB TTI that decodes the UE's PUSCH of TTI 23 (subframe 3, the SRS
# subframe): the first on which the port's repair acts
SRS_SR_REPAIR_TTI = 24
# two UEs under `TddConfig(2, 4)` at 15 PRB through phase 36's link: the
# setting the fault was found in (no SRs; the first TTI whose stats differ
# is UE 0's RRC release, which the reference sends and the port, having
# heard UE 0's PUCCH, does not) and phase 36's run (a) (SRs; the port first
# reads UE 0's channel-selection ACKs where the reference reads DTX)
TWO_UE_RUNS = {"no SRs": (dict(tdd=(2, 4), n_ues=2, kw={}), 95),
               "SRs": (next(T for T in chip_smoke.STACK_LINK_TDD["runs"] if T["tag"] == "a"), 118)}


def test_tdd_srs_and_sr_attach_repaired_against_the_reference():
    """`TddConfig(1, 4)`, 15 PRB, one UE, SRS and SR on.  Both packages in
    lockstep within the file's bars up to TTI 24.  There the eNB decodes the
    UE's PUSCH of subframe 3, the SRS subframe: the UE, not yet RRC_ACTIVE,
    sent it at full length, and the shortened decode fails its CRC; in
    configuration 1 every retransmission falls on subframe 3 again.  The
    port decodes it again at full length.  From there the port registers
    and carries every packet, and the reference's eNB passes no PUSCH after
    Msg3: the UE is never registered and is released."""
    kw = dict(srs_enabled=True, sr_enabled=True)
    rcfg = r_tdd.TddConfig(1, 4)
    r = chip_smoke.stack_pair(REF, 15, enb_kw=dict(kw, tdd_cfg=rcfg), ue_kw=[dict(kw, tdd_cfg=rcfg)])
    tcfg = from_reference(rcfg)
    t = chip_smoke.stack_pair(PORT, 15, enb_kw=dict(kw, tdd_cfg=tcfg), ue_kw=[dict(kw, tdd_cfg=tcfg)],
                              device=CPU)
    traffic = dict(dl=chip_smoke.STACK_TDD["dl"], ul=chip_smoke.STACK_TDD["ul"])
    rr = chip_smoke.StackRun(r.enb, r.ues[0], r.mme, r.spgw, **traffic)
    tr = chip_smoke.StackRun(t.enb, t.ues[0], t.mme, t.spgw, **traffic)
    while rr.tti < SRS_SR_REPAIR_TTI:
        dl_r, ul_r = rr.step()
        dl_t, ul_t = tr.step()
        tti = rr.tti - 1
        for got, ref, what in ((dl_t, dl_r, "DL"), (ul_t, ul_r, "UL")):
            assert (got is None) == (ref is None), f"{what} of TTI {tti}"
            if ref is not None:
                ref = np.asarray(ref)
                scale = max(float(np.abs(ref).max()), 1e-30)
                assert float(np.abs(got.numpy() - ref).max()) <= SAMPLE_ATOL * scale, f"{what} of TTI {tti}"
        assert tr.records[-1] == rr.records[-1], f"TTI {tti}"
    assert tr.records[-1]["enb"].get("srs_meas", 0) > 0 and tr.records[-1]["ue"].get("sr_sent", 0) > 0
    rr.step()
    tr.step()
    assert rr.records[-1]["enb"]["ul_crc_ko"] == tr.records[-1]["enb"]["ul_crc_ko"] + 1
    assert tr.records[-1]["enb"]["ul_crc_ok"] == rr.records[-1]["enb"]["ul_crc_ok"] + 1
    tr.run()
    tr.check_traffic("port")
    assert tr.records[-1]["enb"]["ue_released"] == 0 and tr.records[-1]["enb"]["srs_meas"] > 0
    rr.run(70)
    assert rr.reg_tti is None and rr.records[-1]["enb"]["ue_released"] == 1
    assert rr.records[-1]["enb"]["ul_crc_ok"] == 1 and not rr.delivered()  # Msg3 alone


class _Released(Exception):
    pass


class _Tensors:
    """A reference stack whose `run_tti` takes and gives tensors, as the
    port's does; everything else is the reference stack's own."""

    def __init__(self, stack):
        self._stack = stack

    def __getattr__(self, name):
        return getattr(self._stack, name)

    def run_tti(self, x):
        y = self._stack.run_tti(None if x is None else x.numpy())
        return None if y is None else torch.from_numpy(np.array(y))


def tensors(stack) -> _Tensors:
    """`stack` behind `_Tensors`, with its class's RRC states."""
    states = {k: v for k, v in vars(type(stack)).items() if k.startswith("RRC_")}
    return type(type(stack).__name__, (_Tensors,), states)(stack)


def link_records(ref: bool, T: dict, recs=None) -> tuple[list, SimpleNamespace]:
    """Phase 36's link at 15 PRB in the run `T` on the reference's stacks
    (`ref`) or the port's: the eNB's and the UEs' stats after each TTI,
    appended to `recs`.  Stops at the eNB's first release of a UE, and
    names the UEs it released."""
    recs, run = [] if recs is None else recs, SimpleNamespace(stack=None, owner={}, contexts=set(), released=[])
    pair = chip_smoke.stack_pair

    def to_ref(kw: dict) -> dict:
        cfg = kw.get("tdd_cfg")
        return kw if cfg is None else dict(kw, tdd_cfg=r_tdd.TddConfig(cfg.sf_config, cfg.ss_config))

    def keep(m, nof_prb, n_ues=1, enb_kw=None, ue_kw=(), **dev_kw):
        if ref:
            s = pair(REF, nof_prb, n_ues, to_ref(enb_kw), [to_ref(k) for k in ue_kw])
            s.enb, s.ues = tensors(s.enb), [tensors(u) for u in s.ues]
        else:
            s = pair(m, nof_prb, n_ues, enb_kw, ue_kw, **dev_kw)
        run.stack = s
        return s

    def on_step(_tti, _phase):
        s = run.stack
        recs.append((dict(s.enb.stats), [dict(u.stats) for u in s.ues]))
        run.owner.update({u.crnti: i for i, u in enumerate(s.ues) if u.crnti is not None})
        if s.enb.stats["ue_released"]:
            run.released = sorted(run.owner[c] for c in run.contexts - set(s.enb.ues))
            raise _Released
        run.contexts = set(s.enb.ues)

    chip_smoke.stack_pair = keep
    try:
        run.rec = chip_smoke.stack_link_run(CPU, 15, tdd=T["tdd"], n_ues=T["n_ues"], kw=T["kw"],
                                            on_step=on_step)
    except _Released:
        pass
    finally:
        chip_smoke.stack_pair = pair
    return recs, run


@pytest.mark.parametrize("setting", list(TWO_UE_RUNS))
def test_two_tdd_ues_stay_attached_against_the_reference(setting):
    """Two UEs under `TddConfig(2, 4)` at 15 PRB through
    `chip_smoke.stack_link_run` on both packages, with and without SRs:
    both ends' stats equal TTI by TTI up to the TTI of `TWO_UE_RUNS`.  UE
    0's uplink is faded 11 dB under UE 1's, and both UEs' format-1 PUCCHs
    share the band-edge PRB, whose energy is the DTX metric's denominator:
    the reference reads UE 0's ACKs (and SRs) as DTX, hears nothing of UE 0
    for 40 TTIs and releases it.  The port judges each PUCCH against the
    energy the other UE's resources leave, counts a detected PUCCH as UL
    activity, keeps both UEs (none released) and carries every packet, with
    the TDD gates: ACKs from each UE, no ACK sent on PUCCH read as DTX, and
    no ACK or SR read where its UE sent none."""
    T, n = TWO_UE_RUNS[setting]
    ref, r_run = link_records(True, T)
    got, t_run = link_records(False, T)
    assert got[:n] == ref[:n] and got[n] != ref[n]
    assert ref[-1][0]["ue_released"] == 1 and len(ref) < len(got)
    assert r_run.released == [0]
    assert got[-1][0]["ue_released"] == 0
    assert all(u.get("sr_sent", 0) > 0 for u in got[-1][1]) == bool(T["kw"])
    assert all(chip_smoke.stack_registered(u) for u in t_run.stack.ues)
    assert min(t_run.rec["dl_acks"]) > 0
    assert all(c["ack_dtx"] == c["false_alarm"] == 0 for c in t_run.rec["pucch"])


def test_no_sounding_in_a_d_subframe_against_the_reference():
    """SRS and SR on under `TddConfig(2, 4)`, one UE, 15 PRB, through
    `chip_smoke.stack_link_run` on both packages.  The SRS subframe 3 is a
    D subframe in configuration 2: the reference's UE sounds in it once
    RRC_ACTIVE, and the link's TDD gate (no UE energy outside U subframes)
    stops the run; both ends' stats equal the port's up to there.  The
    port sounds only where subframe 3 is U, so here never: its UE
    registers and carries every packet, with no SRS measured."""
    T = dict(tdd=(2, 4), n_ues=1, kw=dict(srs_enabled=True, sr_enabled=True))
    ref = []
    with pytest.raises(RuntimeError, match=r"UE 0 sent in TTI \d+ \(D\)"):
        link_records(True, T, ref)
    got, t_run = link_records(False, T)
    assert len(ref) > 0 and got[:len(ref)] == ref
    assert got[-1][0]["ue_released"] == 0 and got[-1][0].get("srs_meas", 0) == 0
    assert chip_smoke.stack_registered(t_run.stack.ues[0])
