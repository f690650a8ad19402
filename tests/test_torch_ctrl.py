"""The port's windowed control plane (`srsran_tpu_torch/pipeline_ctrl.py`)
against the JAX reference's on the CPU, mirroring `tests/test_windowed_ctrl.py`:
W = 8 subframes of a 25 PRB cell (id 7) at CFI 2 rendered by the reference's
host transmitters (`enb_dl_subframe`, `ue_ul_encode`), W = 2 windows of the
100 PRB cell 301 at CFI 1-3, and a W = 4 window of a 2-port cell (transmit
diversity).

Tolerances: the control layout and the overlay's RE indices identical, the
overlay's values within 1e-6; the front ends' control REs, band edges, PRB
powers, RSRP and noise within 2e-5 of the largest magnitude (the FFT and the
channel estimate sum in another order than XLA); the hypotheses' LLRs, the
Viterbi's bits of every hypothesis, the found DCI lists, the PHICH and PUCCH
decisions and the TBs identical; PHICH metrics within 1e-4 and PUCCH metrics
within 1e-3.  The control loopbacks of `chip_smoke.py` (phases 19 and 20) run
here at 25 PRB and W = 4 with their own checks.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import srsran_tpu.pipeline_ctrl as r_pc
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
from srsran_tpu.phy.phch.dci import Dci0, Dci1A
from srsran_tpu.phy.phch.pbch import Mib
from srsran_tpu.phy.phch.pdcch import nof_cce, search_space_candidates
from srsran_tpu.phy.phch.pdsch import DlGrant
from srsran_tpu.phy.phch.pucch import PucchConfig, _f1_covers, pucch_f1_prb, pucch_format1_decode
from srsran_tpu.phy.phch.pusch import UlGrant
from srsran_tpu.phy.phch.ra import (dl_mcs_to_mod, dl_tbs, riv_encode, tbs_lookup, ul_mcs_to_itbs,
                                    ul_mcs_to_mod)
from srsran_tpu.phy.ue.ue_ul import ue_ul_encode
import srsran_tpu_torch.pipeline_ctrl as t_pc
import srsran_tpu_torch.pipeline_window as t_pw
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)

W = 8
RNTI = 0x46
CELL = Cell(nof_prb=25, nof_ports=1, id=7)
PCELL = from_reference(CELL)
CFI = 2
RTOL = 2e-5

_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def same_found(got, ref):
    """Two found lists per TTI: the same (rnti, fmt, bits, level, CCE) in
    the same order."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [(x[0], x[1], x[3], x[4]) for x in g] == [(x[0], x[1], x[3], x[4]) for x in r]
        for x, y in zip(g, r):
            np.testing.assert_array_equal(x[2], y[2])


def dl_window(cell, cfi, sfs, rng, mcs=8, mib=None):
    """Host-rendered subframes (the reference's `enb_dl_subframe`), each with
    a 1A DL grant and a DCI 0 for RNTI and one PHICH: (samples (W, 1, L),
    grants, payloads, scheds)."""
    grants, payloads, scheds, samples = [], [], [], []
    n_prb = cell.nof_prb
    for t, sf in enumerate(sfs):
        tbs = dl_tbs(mcs, n_prb)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        dci = Dci1A(riv=riv_encode(n_prb, 0, n_prb), mcs=mcs, ndi=t & 1, rv=0, harq_pid=t % 8)
        dci0 = Dci0(riv=riv_encode(n_prb, 1, 5), mcs=5, ndi=0, tpc=1)
        grant = DlGrant(prb=tuple(range(n_prb)), mod=dl_mcs_to_mod(mcs), tbs=tbs, rnti=RNTI,
                        tx_scheme="diversity" if cell.nof_ports == 2 else "port0")
        n = nof_cce(cell, sf, cfi)
        c4 = search_space_candidates(RNTI, sf, n)[4][0]
        c2 = next(c for c in search_space_candidates(RNTI, sf, n)[2] if c + 2 <= c4 or c >= c4 + 4)
        sched = DlSched(cfi=cfi, phich=[(0, 1, t & 1)])
        sched.dcis.append((dci.pack(n_prb), RNTI, 4, c4))
        sched.dcis.append((dci0.pack(n_prb), RNTI, 2, c2))
        sched.grants.append((grant, tb))
        _, s = enb_dl_subframe(cell, sf, sched, mib=mib, sfn=t // 10)
        grants.append(grant)
        payloads.append(tb)
        scheds.append(sched)
        samples.append(np.asarray(s).sum(axis=0))  # every port through a unit channel
    return np.stack(samples)[:, None], grants, payloads, scheds


def run_dl(cell, cfi, w, sfs, seed, amp=0.0):
    """The reference's and the port's UE front ends on one window."""
    rng = np.random.default_rng(seed)
    samples, grants, payloads, scheds = dl_window(cell, cfi, sfs, rng)
    if amp:
        samples = (samples + amp * (rng.standard_normal(samples.shape)
                                    + 1j * rng.standard_normal(samples.shape))).astype(np.complex64)
    scheme = "diversity" if cell.nof_ports == 2 else "port0"
    ref_fe = r_pc.WindowedUeFrontEnd(cell, cfi=cfi, w=w, scheme=scheme, ingest="float32")
    ref_pf = ref_fe.dispatch(samples, sfs)
    pcell = from_reference(cell)
    fe = t_pc.WindowedUeFrontEnd(pcell, cfi=cfi, w=w, scheme=scheme, ingest="float32", device="cpu")
    pf = fe.dispatch(samples, sfs)
    searches = [[(RNTI, "1A", Dci1A.nof_bits(cell.nof_prb), True)]] * w
    return SimpleNamespace(cell=cell, pcell=pcell, sfs=sfs, samples=samples, grants=grants, payloads=payloads,
                           scheds=scheds, ref_fe=ref_fe, ref_pf=ref_pf, ref=ref_fe.realize(ref_pf), fe=fe,
                           pf=pf, got=fe.realize(pf), searches=searches)


@pytest.fixture(scope="module")
def dl():
    return run_dl(CELL, CFI, W, [(t + 1) % 10 for t in range(W)], seed=1, amp=0.05)


def test_ctrl_layout():
    for cell in (CELL, Cell(nof_prb=100, id=301), Cell(nof_prb=6, id=1), Cell(nof_prb=50, id=17, nof_ports=2),
                 Cell(nof_prb=25, id=7, phich_length=1)):
        pcell = from_reference(cell)
        for cfi in (1, 2, 3):
            if cell.phich_length == 1 and cfi < 3:
                continue
            ref, got = r_pc.ctrl_layout(cell, cfi), t_pc.ctrl_layout(pcell, cfi)
            np.testing.assert_array_equal(got.idx, ref.idx)
            assert got.idx.dtype == ref.idx.dtype
            assert (got.pcfich, got.phich, got.pdcch, got.n_cce) == (ref.pcfich, ref.phich, ref.pdcch, ref.n_cce)
    lay = t_pc.ctrl_layout(from_reference(Cell(nof_prb=100, id=301)), 2)
    assert (lay.n_cce, lay.idx.size) == (52, 1972)


def test_ue_frontend_realize(dl):
    (ctrl, rsrp, noise), (r_ctrl, r_rsrp, r_noise) = dl.got, dl.ref
    close(ctrl, r_ctrl)
    close(rsrp, r_rsrp)
    close(noise, r_noise)
    assert np.all(rsrp > 0)


def test_blind_search_hypotheses_and_viterbi_bits(dl):
    """On the reference's control REs: the same hypotheses (metadata and
    LLRs), the same Viterbi bits for every one of them, the same bucket."""
    r_ctrl = dl.ref[0]
    w_r, pend_r = r_pc.blind_search_dispatch(r_ctrl, dl.ref_fe.layout, CELL, dl.sfs, dl.searches)
    w_t, pend_t = t_pc.blind_search_dispatch(r_ctrl, dl.fe.layout, PCELL, dl.sfs, dl.searches, device="cpu")
    assert w_r == w_t == W and len(pend_r) == len(pend_t) == 1
    for (d_r, ent_r, bits_r), (d_t, ent_t, bits_t) in zip(pend_r, pend_t):
        assert d_r == d_t == Dci1A.nof_bits(25) + 16
        assert [e[0] for e in ent_t] == [e[0] for e in ent_r]
        np.testing.assert_array_equal(np.stack([e[1] for e in ent_t]), np.stack([e[1] for e in ent_r]))
        assert bits_t.shape == tuple(bits_r.shape) and bits_t.device == torch.device("cpu")
        np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_r))
    same_found(t_pc.blind_search_collect((w_t, pend_t)), r_pc.blind_search_collect((w_r, pend_r)))


def test_found_lists_phich_and_data(dl):
    """The port end to end: its found lists equal the reference's, both find
    the 1A and the DCI 0 of every TTI, the PHICH decisions and metrics
    agree, and the data pass from the stored front end gives back every TB."""
    found = t_pc.window_blind_search(dl.got[0], dl.fe.layout, PCELL, dl.sfs, dl.searches, device="cpu")
    ref_found = r_pc.window_blind_search(dl.ref[0], dl.ref_fe.layout, CELL, dl.sfs, dl.searches)
    same_found(found, ref_found)
    for t in range(W):
        assert sorted(int(b[0]) for _r, _f, b, _l, _c in found[t]) == [0, 1], found[t]
        for sl in dl.fe.layout.phich:
            a_t, m_t = t_pc.phich_decode_np(dl.got[0][t, sl], PCELL, dl.sfs[t], 1)
            a_r, m_r = r_pc.phich_decode_np(dl.ref[0][t, sl], CELL, dl.sfs[t], 1)
            assert a_t == a_r and abs(m_t - m_r) < 1e-4
        assert t_pc.phich_decode_np(dl.got[0][t, dl.fe.layout.phich[0]], PCELL, dl.sfs[t], 1)[0] == bool(t & 1)
    res = dl.fe.results(dl.fe.dispatch_data(dl.pf, [from_reference(g) for g in dl.grants]))
    ref_res = dl.ref_fe.results(dl.ref_fe.dispatch_data(dl.ref_pf, dl.grants))
    for (tb, ok, n), (r_tb, r_ok, r_n), want in zip(res, ref_res, dl.payloads):
        assert ok and r_ok and n == r_n
        np.testing.assert_array_equal(tb, r_tb)
        np.testing.assert_array_equal(tb, want)


def test_data_pass_equals_the_engine_on_the_samples(dl):
    grants = [from_reference(g) for g in dl.grants]
    via_fe = dl.fe.results(dl.fe.dispatch_data(dl.pf, grants))
    direct = dl.fe.inner.results(dl.fe.inner.dispatch_window(dl.samples, dl.sfs, grants))
    for (a, ok_a, n_a), (b, ok_b, n_b) in zip(via_fe, direct):
        np.testing.assert_array_equal(a, b)
        assert (ok_a, n_a) == (ok_b, n_b)


@pytest.mark.parametrize("cfi", [1, 2, 3])
def test_full_width_window(cfi):
    """W = 2 at 100 PRB, cell 301: realize within 2e-5, found lists
    identical, TBs back."""
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    r = run_dl(cell, cfi, 2, [0, 7], seed=10 + cfi, amp=0.03)
    for got, ref in zip(r.got, r.ref):
        close(got, ref)
    found = t_pc.window_blind_search(r.got[0], r.fe.layout, r.pcell, r.sfs, r.searches, device="cpu")
    same_found(found, r_pc.window_blind_search(r.ref[0], r.ref_fe.layout, cell, r.sfs, r.searches))
    assert all(len(f) == 2 for f in found)
    res = r.fe.results(r.fe.dispatch_data(r.pf, [from_reference(g) for g in r.grants]))
    for (tb, ok, _n), want in zip(res, r.payloads):
        assert ok and np.array_equal(tb, want)


def test_two_port_window():
    """A 2-port cell: the control REs SFBC-combined (`predecode_diversity2`)
    within 2e-5 of the reference's, found lists identical, the
    transmit-diversity TBs back."""
    cell = Cell(nof_prb=25, nof_ports=2, id=7)
    r = run_dl(cell, CFI, 4, [1, 2, 6, 9], seed=5, amp=0.03)
    assert r.fe.inner.nof_ports == 2
    for got, ref in zip(r.got, r.ref):
        close(got, ref)
    found = t_pc.window_blind_search(r.got[0], r.fe.layout, r.pcell, r.sfs, r.searches, device="cpu")
    same_found(found, r_pc.window_blind_search(r.ref[0], r.ref_fe.layout, cell, r.sfs, r.searches))
    assert all(len(f) == 2 for f in found)
    res = r.fe.results(r.fe.dispatch_data(r.pf, [from_reference(g) for g in r.grants]))
    for (tb, ok, _n), want in zip(res, r.payloads):
        assert ok and np.array_equal(tb, want)


@pytest.mark.parametrize("sfn", [0, 1, 6, 1023])
def test_enb_ctrl_overlay(dl, sfn):
    """Indices identical and values within 1e-6 on every TTI of the window;
    on subframe 0 with the MIB of frame sfn too (its PBCH REs in place of
    the pad column)."""
    mib = Mib(nof_prb=25, phich_resources=1)
    for t, sched in enumerate(dl.scheds):
        sf = dl.sfs[t] if t else 0
        ref = r_pc.enb_ctrl_overlay(CELL, CFI, sf, sched, mib=mib, sfn=sfn)
        got = t_pc.enb_ctrl_overlay(PCELL, CFI, sf, from_reference(sched), mib=from_reference(mib), sfn=sfn)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[0].dtype == ref[0].dtype and got[1].dtype == ref[1].dtype == np.complex64
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
        s = CELL.nsymb_per_sf * CELL.nof_re_per_symbol
        assert (got[0] == s).sum() == (0 if sf == 0 else 240)


def test_windowed_enb_render_matches_host_render(dl):
    """The port's generator (template "full" and the control overlay) renders
    the reference host's subframes, and its own front end finds the DCIs."""
    gen = t_pw.WindowedEnbDl(PCELL, cfi=CFI, w=W, template="full", device="cpu")
    ov = [t_pc.enb_ctrl_overlay(PCELL, CFI, sf, from_reference(sc)) for sf, sc in zip(dl.sfs, dl.scheds)]
    out = gen.dispatch_window(dl.payloads, dl.sfs, [from_reference(g) for g in dl.grants],
                              overlay=(np.stack([o[0] for o in ov]), np.stack([o[1] for o in ov])))
    host = np.stack([np.asarray(enb_dl_subframe(CELL, sf, sc)[1])[0] for sf, sc in zip(dl.sfs, dl.scheds)])
    np.testing.assert_allclose(gen.samples(out), host, rtol=0, atol=2e-3)
    pf = dl.fe.dispatch(out[:, None], dl.sfs)
    found = t_pc.window_blind_search(dl.fe.realize(pf)[0], dl.fe.layout, PCELL, dl.sfs, dl.searches,
                                     device="cpu")
    assert all(len(f) == 2 for f in found)


def test_pucch_decodes_on_the_host():
    """Format 2 (`pucch_format2_decode_np`) and the format-1 batch against
    the reference's, bits identical and metrics within 1e-3."""
    from srsran_tpu.phy.phch.pucch import pucch_format1_encode_np, pucch_format2_encode_np

    rng = np.random.default_rng(3)
    for nbits in (4, 10, 13):
        bits = rng.integers(0, 2, nbits).astype(np.uint8)
        for n_pucch, sf in ((3, 4), (11, 9)):
            cfg = PucchConfig(n_pucch=n_pucch)
            g = pucch_format2_encode_np(CELL, cfg, sf, bits)
            noisy = (g + 0.05 * (rng.standard_normal(g.shape) + 1j * rng.standard_normal(g.shape))
                     ).astype(np.complex64)
            b_r, m_r = r_pc.pucch_format2_decode_np(noisy, CELL, cfg, sf, nbits)
            b_t, m_t = t_pc.pucch_format2_decode_np(noisy, PCELL, from_reference(cfg), sf, nbits)
            np.testing.assert_array_equal(b_t, b_r)
            np.testing.assert_array_equal(b_t, bits)
            assert abs(m_t - m_r) < 1e-3
    for nbits in (0, 1, 2):
        grids, sfs = [], []
        for i in range(12):
            g = pucch_format1_encode_np(CELL, PucchConfig(n_pucch=3), i % 10,
                                        rng.integers(0, 2, nbits).astype(np.uint8))
            grids.append((g + 0.05 * (rng.standard_normal(g.shape) + 1j * rng.standard_normal(g.shape))
                          ).astype(np.complex64))
            sfs.append(i % 10)
        b_r, m_r = r_pc.pucch_format1_decode_batch(np.stack(grids), CELL, 3, sfs, nbits)
        b_t, m_t = t_pc.pucch_format1_decode_batch(np.stack(grids), PCELL, 3, sfs, nbits)
        np.testing.assert_array_equal(b_t, b_r)
        np.testing.assert_allclose(m_t, m_r, rtol=0, atol=1e-3)
        for sf in range(10):
            for a, b in zip(t_pc._f1_refs(PCELL, 3, 2, sf), r_pc._f1_refs(CELL, 3, 2, sf)):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ul():
    rng = np.random.default_rng(4)
    grant = UlGrant(prb_start=4, nof_prb=16, mod=ul_mcs_to_mod(5), tbs=tbs_lookup(ul_mcs_to_itbs(5), 16),
                    rnti=RNTI)
    sfs, rows, tbs, acks = [], [], [], []
    for t in range(W):
        sf = (t + 2) % 10
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        ack = [t & 1, (t >> 1) & 1]
        rows.append(ue_ul_encode(CELL, sf, pusch=(grant, tb), pucch1=(PucchConfig(n_pucch=2), ack),
                                 pucch2=(PucchConfig(n_pucch=40), rng.integers(0, 2, 8).astype(np.uint8))))
        sfs.append(sf)
        tbs.append(tb)
        acks.append(ack)
    samples = np.stack(rows)[:, None]
    samples = (samples + 0.03 * (rng.standard_normal(samples.shape) + 1j * rng.standard_normal(samples.shape))
               ).astype(np.complex64)
    ref_fe = r_pc.WindowedEnbUlFrontEnd(CELL, w=W, edge_prbs=4)
    ref_pf = ref_fe.dispatch(samples, sfs)
    fe = t_pc.WindowedEnbUlFrontEnd(PCELL, w=W, edge_prbs=4, device="cpu")
    pf = fe.dispatch(samples, sfs)
    return SimpleNamespace(grant=grant, sfs=sfs, samples=samples, tbs=tbs, acks=acks, ref_fe=ref_fe,
                           ref_pf=ref_pf, ref=ref_fe.realize_pucch(ref_pf), fe=fe, pf=pf,
                           got=fe.realize_pucch(pf))


def test_enb_ul_frontend_edges_and_power(ul):
    (edge, prb_pow), (r_edge, r_pow) = ul.got, ul.ref
    close(edge, r_edge)
    close(prb_pow, r_pow)
    assert np.all(prb_pow[:, 4:20].mean(axis=1) > 1e-5)


def test_enb_ul_frontend_pucch(ul):
    """The band-edge PRB grids equal the reference's within 2e-5 and decode
    to the same bits: format 1 per subframe and as one batch."""
    cfg = PucchConfig(n_pucch=2)
    grids = []
    for t in range(W):
        prbs = tuple(pucch_f1_prb(2, 2 * ul.sfs[t] + sl, 25, 2, covers=_f1_covers(CELL)) for sl in range(2))
        g_t = ul.fe.pucch_prb_grid(ul.got[0], t, prbs)
        g_r = ul.ref_fe.pucch_prb_grid(ul.ref[0], t, prbs)
        close(g_t, g_r)
        b_r, m_r = pucch_format1_decode(g_r, CELL, cfg, ul.sfs[t], 2)
        b_t, m_t = pucch_format1_decode(g_t, CELL, cfg, ul.sfs[t], 2)
        assert b_t.tolist() == np.asarray(b_r).tolist() == ul.acks[t]
        assert abs(float(m_t) - float(m_r)) < 1e-3 and m_t > 0.25
        grids.append(g_t)
    bits, metric = t_pc.pucch_format1_decode_batch(np.stack(grids), PCELL, 2, ul.sfs, 2)
    assert bits.tolist() == ul.acks and np.all(metric > 0.25)


def test_enb_ul_frontend_data(ul):
    """`dispatch_data` from the stored grids: the reference's TBs, and the
    same results as the inner engine's own pass over the samples."""
    pg = from_reference(ul.grant)
    res = ul.fe.results(ul.fe.dispatch_data(ul.pf, [pg] * W))
    ref_res = ul.ref_fe.results(ul.ref_fe.dispatch_data(ul.ref_pf, [ul.grant] * W))
    direct = ul.fe.inner.results(ul.fe.inner.dispatch_window(ul.samples, ul.sfs, [pg] * W))
    for (tb, ok, n), (r_tb, r_ok, r_n), (d_tb, d_ok, d_n), want in zip(res, ref_res, direct, ul.tbs):
        assert ok and r_ok and (n, ok) == (r_n, r_ok) == (d_n, d_ok)
        np.testing.assert_array_equal(tb, r_tb)
        np.testing.assert_array_equal(tb, d_tb)
        np.testing.assert_array_equal(tb, want)


def test_chip_smoke_dl_control_loopback():
    """Phase 19's window (four RNTIs, a 1A and a DCI 0 per TTI, PHICH, the
    MIB on subframe 0) through the port's generator, `window_channel` and
    front end, at 25 PRB and W = 4, with the phase's own checks."""
    cell = from_reference(Cell(nof_prb=25, nof_ports=1, id=301))
    gen, fe = SMOKE.ctrl_engines("dl", cell, 4, device="cpu")
    win = SMOKE.ctrl_dl_window(cell, SMOKE.CTRL_CFI, 4, np.random.default_rng(19))
    h, amp = SMOKE.LOOP_CHANNELS["enb_dl"]
    s, spans = SMOKE.run_steps(SMOKE.ctrl_dl_steps(cell, win, gen, fe, h, amp), "cpu")
    info = SMOKE.check_ctrl_dl("dl", cell, win, fe, s)
    assert info["mibs"] == 1 and set(spans) == {"generate", "front end", "blind search host", "viterbi",
                                                "collect", "data", "results"}


def test_chip_smoke_ul_control_loopback():
    cell = from_reference(Cell(nof_prb=25, nof_ports=1, id=301))
    gen, fe = SMOKE.ctrl_engines("ul", cell, 4, device="cpu")
    win = SMOKE.ctrl_ul_window(cell, 4, np.random.default_rng(20))
    h, amp = SMOKE.LOOP_CHANNELS["ue_ul"]
    s, _spans = SMOKE.run_steps(SMOKE.ctrl_ul_steps(cell, win, gen, fe, h, amp), "cpu")
    info = SMOKE.check_ctrl_ul("ul", cell, win, s)
    assert info["min_ack_metric"] > 0.25


@pytest.mark.parametrize("cls", ["WindowedUeFrontEnd", "WindowedEnbUlFrontEnd"])
def test_front_ends_take_the_card_by_default(cls):
    cell = from_reference(Cell(nof_prb=6, nof_ports=1, id=1))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(t_pc, cls)(cell, w=2)
    fe = getattr(t_pc, cls)(cell, w=2, device="cpu")
    assert fe.device == fe.inner.device == torch.device("cpu")
    with pytest.raises(ValueError, match="window takes"):
        fe.dispatch(np.zeros((1, 1, cell.sf_len), np.complex64), [0])


def test_blind_search_takes_the_card_by_default(dl):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pc.window_blind_search(dl.got[0], dl.fe.layout, PCELL, dl.sfs, dl.searches)
    _w, pend = t_pc.blind_search_dispatch(dl.got[0], dl.fe.layout, PCELL, dl.sfs, dl.searches, device="cpu")
    d, entries, bits = pend[0]
    assert bits.device == torch.device("cpu") and bits.shape == (t_pw._pow2_bucket(len(entries)), d)
