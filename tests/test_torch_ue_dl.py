"""The port's DL facades against the JAX reference on the CPU:
`enb_dl_subframe`, `dlsch_decode`, `pdsch_decode`, `pdsch_decode2`,
`ue_dl_decode_subframe` (with and without `dynamic=`) and the golden
vectors (real eNodeB captures, `tests/test_golden_vectors.py`) through the
port.  Inputs are numpy arrays made from a seed and given to both.

Tolerances: `enb_dl_subframe`'s grid within 1e-6 and its samples within
2e-6 (absolute).  Decodes: TB bits (where the CRC passes), CRC verdicts,
DCIs (bits, aggregation level, CCE), `dci_format`, `cce_used`, CFI, rank,
PMI and `phich_ack` identical; softbuffers within 2e-6 of their largest
magnitude, 2e-5 behind the MMSE solves of cdd, spatialmux and spatialmux4
(their predecoders already differ by up to 2e-5 relative,
`tests/test_torch_mimo.py`); rsrp, noise, snr_db and `sb_snr` within 1e-4 relative; the
equalized PDSCH symbols within 2e-5 of their largest magnitude, compared
where the reference's are finite (the reference divides by |h|²+noise,
which can be zero; the port gives 0 there).
"""

import os

import numpy as np
import pytest
import torch

import srsran_tpu.phy.phch.pdsch as r_pdsch
import srsran_tpu.phy.phch.sch as r_sch
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
from srsran_tpu.phy.phch.dci import Dci0, Dci1, Dci1A, Dci2
from srsran_tpu.phy.phch.pbch import Mib
from srsran_tpu.phy.phch.pdcch import nof_cce, search_space_candidates
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode
from srsran_tpu.phy.ue.ue_dl import ue_dl_decode_subframe as r_decode
import srsran_tpu_torch.phy.enb.enb_dl as t_enb_dl
import srsran_tpu_torch.phy.phch.pdsch as t_pdsch
import srsran_tpu_torch.phy.phch.sch as t_sch
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe as t_decode

torch.set_num_threads(1)

CPU = "cpu"
VEC = os.path.join(os.path.dirname(__file__), "vectors")


def t(x):
    return torch.from_numpy(np.array(x))


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def both_rendered(cell, sf_idx, sched, mib=None, sfn=0):
    """(reference grid, samples) and the port's, from one schedule."""
    ref = enb_dl_subframe(cell, sf_idx, sched, mib=mib, sfn=sfn)
    got = t_enb_dl.enb_dl_subframe(from_reference(cell), sf_idx, from_reference(sched),
                                   mib=None if mib is None else from_reference(mib), sfn=sfn,
                                   device=CPU)
    return ref, got


def agg_cce(rnti, sf_idx, n, agg, skip=()):
    """A candidate of `rnti` at `agg` that does not overlap the CCE ranges in skip."""
    for st in search_space_candidates(rnti, sf_idx, n)[agg]:
        if all(st + agg <= a or st >= a + l for a, l in skip):
            return st
    raise AssertionError("no free candidate")


ENB_CASES = [  # (nof_prb, nof_ports, sf_idx, sfn, second grant)
    (15, 1, 0, 5, None),
    (25, 1, 5, 0, None),
    (25, 2, 0, 2, "cdd"),
    (25, 2, 3, 0, "spatialmux"),
]


@pytest.mark.parametrize("nof_prb,nof_ports,sf_idx,sfn,mimo", ENB_CASES)
def test_enb_dl_subframe(nof_prb, nof_ports, sf_idx, sfn, mimo):
    cell = Cell(nof_prb=nof_prb, nof_ports=nof_ports, id=123)
    rng = np.random.default_rng(nof_prb + sf_idx)
    cfi = 2
    n = nof_cce(cell, sf_idx, cfi)
    sched = DlSched(cfi=cfi, phich=[(0, 1, 1), (0, 6, 0)])
    ra, rb = 0x46, 0x4B
    c0 = agg_cce(ra, sf_idx, n, 4)
    c1 = agg_cce(rb, sf_idx, n, 2, skip=[(c0, 4)])
    if mimo is None:
        prb = tuple(range(2, nof_prb - 1))
        grant = r_pdsch.DlGrant(prb=prb, mod=dl_mcs_to_mod(12), tbs=dl_tbs(12, len(prb)), rnti=ra,
                                tx_scheme="diversity" if nof_ports == 2 else "port0")
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        dci = Dci1A(riv=riv_encode(nof_prb, 2, len(prb)), mcs=12).pack(nof_prb)
    else:
        prb = tuple(range(nof_prb))
        grant = r_pdsch.DlGrant2(prb=prb, mod1=dl_mcs_to_mod(10), tbs1=dl_tbs(10, nof_prb),
                                 mod2=dl_mcs_to_mod(14), tbs2=dl_tbs(14, nof_prb), rnti=ra,
                                 pmi=0 if mimo == "cdd" else 1, tx_scheme=mimo)
        tb = tuple(rng.integers(0, 2, s).astype(np.uint8) for s in (grant.tbs1, grant.tbs2))
        dci = Dci2(rbg_bitmap=Dci1.bitmap_for_prbs(prb, nof_prb), mcs1=10, mcs2=14,
                   fmt="2a" if mimo == "cdd" else "2").pack(nof_prb, nof_ports=2)
    sched.dcis += [(dci, ra, 4, c0), (Dci0(riv=riv_encode(nof_prb, 0, 4), mcs=5).pack(nof_prb), rb, 2, c1)]
    sched.grants.append((grant, tb))
    (r_grid, r_samples), (g_grid, g_samples) = both_rendered(cell, sf_idx, sched,
                                                             mib=Mib(nof_prb=nof_prb), sfn=sfn)
    assert g_grid.dtype == np.complex64 and g_samples.dtype == torch.complex64
    np.testing.assert_allclose(g_grid, r_grid, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_samples.numpy(), np.asarray(r_samples), rtol=0, atol=2e-6)


def test_enb_dl_subframe_refuses_tdd():
    with pytest.raises(NotImplementedError, match="Slice 10"):
        t_enb_dl.enb_dl_subframe(from_reference(Cell(nof_prb=6)), 0, t_enb_dl.DlSched(),
                                 tdd=object(), device=CPU)


# --- dlsch_decode / pdsch_decode / pdsch_decode2 -------------------------------


def same_decode(got, ref, sb_rel=2e-6):
    """(tb, ok, softbuffers) of both packages."""
    (gt, gok, gsb), (rt, rok, rsb) = got, ref
    assert gok == bool(rok) and isinstance(gok, bool)
    if rok:
        np.testing.assert_array_equal(gt, np.asarray(rt))
    assert len(gsb) == len(rsb)
    for g, r in zip(gsb, rsb):
        close(g.numpy(), np.asarray(r), sb_rel)


@pytest.mark.parametrize("tbs,qm", [(1544, 2), (14112, 4), (75376, 6)])
def test_dlsch_decode_and_harq_combine(tbs, qm):
    """One TB of 1, 3 and 13 codeblocks (a filler group included) from
    noisy codeword LLRs (±2 under noise of deviation 1.8): rv 0 fails
    alone, rv 2 combined with its softbuffers passes."""
    rng = np.random.default_rng(tbs)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    g = qm * (-(-int(tbs * 1.3) // qm))
    llr = {}
    for rv in (0, 2):
        coding = r_sch.TbCoding(tbs=tbs, g=g, qm=qm, rv=rv)
        bits = r_sch.dlsch_encode_np(tb, coding).astype(np.float32)
        llr[rv] = ((2 * bits - 1) * 2.0 + rng.standard_normal(g) * 1.8).astype(np.float32)
    c0, c2 = (r_sch.TbCoding(tbs=tbs, g=g, qm=qm, rv=rv) for rv in (0, 2))
    r0 = r_sch.dlsch_decode(llr[0], c0, 5)
    g0 = t_sch.dlsch_decode(t(llr[0]), from_reference(c0), 5)
    same_decode(g0, r0)
    r2 = r_sch.dlsch_decode(llr[2], c2, 5, softbuffers=r0[2])
    g2 = t_sch.dlsch_decode(t(llr[2]), from_reference(c2), 5, softbuffers=g0[2])
    same_decode(g2, r2)
    assert not g0[1] and g2[1] and (g2[0] == tb).all()


def tx_grid(cell, sf_idx, cfi, grant, tbs_bits):
    if isinstance(grant, r_pdsch.DlGrant2):
        return r_pdsch.pdsch_encode2_np(cell, sf_idx, cfi, grant, *tbs_bits)
    return r_pdsch.pdsch_encode_np(cell, sf_idx, cfi, grant, tbs_bits)


def mimo_rx(rng, tx_grid_ports, nrx, amp):
    """(rx grid (nrx, nsymb, nre), ce (nrx, nports, nsymb, nre)) behind a
    random well-conditioned flat channel, the channel known exactly."""
    nports = tx_grid_ports.shape[0]
    h = ((rng.standard_normal((nrx, nports)) + 1j * rng.standard_normal((nrx, nports)))
         / np.sqrt(2) + np.eye(nrx, nports)).astype(np.complex64)
    rx = awgn(rng, np.einsum("rp,psk->rsk", h, tx_grid_ports), amp)
    ce = np.broadcast_to(h[:, :, None, None], (nrx, nports) + tx_grid_ports.shape[1:])
    return rx, np.ascontiguousarray(ce).astype(np.complex64)


PDSCH_CASES = [  # (scheme, nof_ports, nrx, mcs, codewords)
    ("port0", 1, 1, 16, 1), ("port0", 1, 2, 22, 1), ("diversity", 2, 2, 12, 1),
    ("diversity4", 4, 2, 9, 1), ("cdd", 2, 2, 10, 1), ("spatialmux", 2, 2, 11, 1),
    ("cdd", 2, 2, 10, 2), ("spatialmux", 2, 2, 14, 2), ("spatialmux4", 4, 4, 9, 2),
]


@pytest.mark.parametrize("scheme,nof_ports,nrx,mcs,ncw", PDSCH_CASES)
def test_pdsch_decode_every_scheme(scheme, nof_ports, nrx, mcs, ncw):
    cell = Cell(nof_prb=25, nof_ports=nof_ports, id=77)
    rng = np.random.default_rng(mcs + 10 * ncw + nrx)
    sf_idx, cfi, prb = 4, 2, tuple(range(1, 24))
    if ncw == 1:
        nl = 2 if scheme in ("spatialmux", "cdd") else 1
        grant = r_pdsch.DlGrant(prb=prb, mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, len(prb)), rv=0,
                                rnti=0x1234, tx_scheme=scheme, nof_layers=nl, pmi=1)
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    else:
        nl = 4 if scheme == "spatialmux4" else 2
        grant = r_pdsch.DlGrant2(prb=prb, mod1=dl_mcs_to_mod(mcs), tbs1=dl_tbs(mcs, len(prb)),
                                 mod2=dl_mcs_to_mod(mcs + 2), tbs2=dl_tbs(mcs + 2, len(prb)),
                                 rnti=0x1234, pmi=1, tx_scheme=scheme, nof_layers=nl)
        tb = tuple(rng.integers(0, 2, s).astype(np.uint8) for s in (grant.tbs1, grant.tbs2))
    rx, ce = mimo_rx(rng, tx_grid(cell, sf_idx, cfi, grant, tb), nrx, 0.02)
    noise = 8e-4
    sb_rel = 2e-5 if scheme in ("cdd", "spatialmux", "spatialmux4") else 2e-6
    pcell, pgrant = from_reference(cell), from_reference(grant)
    if ncw == 1:
        ref = r_pdsch.pdsch_decode(rx, ce, noise, cell, sf_idx, cfi, grant, 5)
        got = t_pdsch.pdsch_decode(t(rx), t(ce), noise, pcell, sf_idx, cfi, pgrant, 5)
        same_decode(got, ref, sb_rel)
        assert got[1] and (got[0] == tb).all()
    else:
        ref = r_pdsch.pdsch_decode2(rx, ce, noise, cell, sf_idx, cfi, grant, 5)
        got = t_pdsch.pdsch_decode2(t(rx), t(ce), noise, pcell, sf_idx, cfi, pgrant, 5)
        for g, r, sent in zip(got, ref, tb):
            same_decode(g, r, sb_rel)
            assert g[1] and (g[0] == sent).all()


AMP_HARQ = 0.45


def test_pdsch_decode_harq_rv0_rv2():
    """rv 0 alone fails at low SNR; rv 2 with the stored softbuffers passes."""
    cell = Cell(nof_prb=15, nof_ports=1, id=5)
    rng = np.random.default_rng(21)
    prb = tuple(range(15))
    tbs = dl_tbs(16, 15)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    sbs_r = sbs_t = None
    for rv in (0, 2):
        grant = r_pdsch.DlGrant(prb=prb, mod=dl_mcs_to_mod(16), tbs=tbs, rv=rv)
        tx = tx_grid(cell, 3, 1, grant, tb)
        rx, ce = awgn(rng, tx, AMP_HARQ), np.ones((1,) + tx.shape, np.complex64)
        ref = r_pdsch.pdsch_decode(rx, ce, 0.15, cell, 3, 1, grant, 5, softbuffers=sbs_r)
        got = t_pdsch.pdsch_decode(t(rx), t(ce), 0.15, from_reference(cell), 3, 1,
                                   from_reference(grant), 5, softbuffers=sbs_t)
        same_decode(got, ref)
        assert got[1] == (rv == 2)
        sbs_r, sbs_t = ref[2], got[2]


# --- ue_dl_decode_subframe -----------------------------------------------------


def same_result(got, ref):
    assert got.cfi == ref.cfi
    assert [(a, c) for _, a, c in got.dcis] == [(a, c) for _, a, c in ref.dcis]
    for (gb, _, _), (rb, _, _) in zip(got.dcis, ref.dcis):
        np.testing.assert_array_equal(gb, np.asarray(rb))
    assert (got.dci_format, got.cce_used, got.rank, got.pmi, got.phich_ack) == (
        ref.dci_format, ref.cce_used, ref.rank, ref.pmi, ref.phich_ack)
    assert type(got.dci_used).__name__ == type(ref.dci_used).__name__
    if ref.dci_used is not None:
        assert vars(got.dci_used) == vars(ref.dci_used)
    assert [ok for _, ok in got.tbs] == [bool(ok) for _, ok in ref.tbs]
    for (gt, ok), (rt, _) in zip(got.tbs, ref.tbs):
        if ok:
            np.testing.assert_array_equal(gt, np.asarray(rt))
    for f in ("rsrp", "noise", "snr_db"):
        assert abs(getattr(got, f) - getattr(ref, f)) <= 1e-4 * abs(getattr(ref, f)), f
    assert (got.sb_snr is None) == (ref.sb_snr is None)
    if ref.sb_snr is not None:
        np.testing.assert_allclose(got.sb_snr, ref.sb_snr, rtol=1e-4)
    assert (got.pdsch_symbols is None) == (ref.pdsch_symbols is None)
    if ref.pdsch_symbols is not None:
        r = np.asarray(ref.pdsch_symbols)
        fin = np.isfinite(r)
        assert np.isfinite(got.pdsch_symbols).all()
        close(got.pdsch_symbols[fin], r[fin], 2e-5)


def make_frame(cell, rnti, mcs, cfi=2, seed=0, sfn=0):
    """tests/test_ue_enb.py's frame: 10 subframes, a full-band 1A grant each."""
    rng = np.random.default_rng(seed)
    out, tbs = [], []
    mib = Mib(nof_prb=cell.nof_prb)
    for sf_idx in range(10):
        l_crb = cell.nof_prb
        dci = Dci1A(riv=riv_encode(cell.nof_prb, 0, l_crb), mcs=mcs, harq_pid=0, ndi=1, rv=0)
        grant = r_pdsch.DlGrant(prb=tuple(range(l_crb)), mod=dl_mcs_to_mod(mcs),
                                tbs=dl_tbs(mcs, l_crb), rnti=rnti)
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        tbs.append(tb)
        cands = search_space_candidates(rnti, sf_idx, nof_cce(cell, sf_idx, cfi))
        agg = 4 if 4 in cands and cands[4] else max(cands)
        sched = DlSched(cfi=cfi, dcis=[(dci.pack(cell.nof_prb), rnti, agg, cands[agg][0])],
                        grants=[(grant, tb)])
        out.append(enb_dl_subframe(cell, sf_idx, sched, mib=mib, sfn=sfn)[1][0])
    return np.concatenate(out), tbs


def test_ue_dl_frame_15prb():
    """tests/test_ue_enb.py::test_full_ue_decode_frame: 15 PRB, MCS 9, h =
    0.9·e^{0.3j}, noise 0.01, the CFI from the PCFICH, a PHICH watched."""
    cell = Cell(nof_prb=15, nof_ports=1, id=84)
    rnti = 0x5A
    stream, tbs = make_frame(cell, rnti, 9, seed=3)
    rx = awgn(np.random.default_rng(1), stream * np.complex64(0.9 * np.exp(0.3j)), 0.01)
    pcell = from_reference(cell)
    for sf_idx in range(10):
        sf = rx[sf_idx * cell.sf_len : (sf_idx + 1) * cell.sf_len][None]
        ref = r_decode(cell, sf, sf_idx, rnti, phich=(0, 2))
        got = t_decode(pcell, sf, sf_idx, rnti, phich=(0, 2), device=CPU)
        same_result(got, ref)
        assert got.tbs[0][1] and (got.tbs[0][0] == tbs[sf_idx]).all()


def _mimo_channel(rng, tx, nrx=2, amp=0.02):
    """tests/test_tm34_ota.py's random full-rank flat channel + AWGN."""
    h = (rng.standard_normal((nrx, 2)) + 1j * rng.standard_normal((nrx, 2))
         ).astype(np.complex64) / np.sqrt(2)
    u, s, vh = np.linalg.svd(h)
    h = (u * np.maximum(s, 0.5 * s.max())) @ vh
    rx = np.einsum("rp,pt->rt", h, tx)
    rx += amp * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


@pytest.mark.parametrize("tm,fmt", [(3, "2a"), (4, "2")])
def test_ue_dl_tm34(tm, fmt):
    """tests/test_tm34_ota.py::test_tm34_over_the_air, with HARQ dicts."""
    rng = np.random.default_rng(42 + tm)
    cell = Cell(nof_prb=25, nof_ports=2, id=123)
    rnti, sf_idx, prb = 0x4B, 3, tuple(range(25))
    grant = r_pdsch.DlGrant2(prb=prb, mod1=dl_mcs_to_mod(10), tbs1=dl_tbs(10, 25),
                             mod2=dl_mcs_to_mod(12), tbs2=dl_tbs(12, 25), pmi=0 if tm == 3 else 1,
                             rnti=rnti, tx_scheme="cdd" if tm == 3 else "spatialmux")
    tb = tuple(rng.integers(0, 2, s).astype(np.uint8) for s in (grant.tbs1, grant.tbs2))
    dci = Dci2(rbg_bitmap=Dci1.bitmap_for_prbs(prb, 25), mcs1=10, mcs2=12, harq_pid=1, fmt=fmt)
    sched = DlSched(cfi=2, dcis=[(dci.pack(25, nof_ports=2), rnti, 4, 0)], grants=[(grant, tb)])
    rx = _mimo_channel(rng, np.asarray(enb_dl_subframe(cell, sf_idx, sched)[1]))
    hr, ht = {}, {}
    ref = r_decode(cell, rx, sf_idx, rnti, nrx=2, known_cfi=2, tm=tm, harq_softbuffers=hr)
    got = t_decode(from_reference(cell), rx, sf_idx, rnti, nrx=2, known_cfi=2, tm=tm,
                   harq_softbuffers=ht, device=CPU)
    same_result(got, ref)
    assert got.dci_format == fmt and all(ok for _, ok in got.tbs) and got.rank in (1, 2)
    assert ht.keys() == hr.keys()


def test_ue_dl_tm1_format1_and_mrc():
    """tests/test_tm34_ota.py's format-1 search (non-contiguous RBGs, tm 1)
    and the control MRC over 2 rx with antenna 0 faded."""
    rng = np.random.default_rng(9)
    rnti = 0x4B
    cell = Cell(nof_prb=25, nof_ports=1, id=77)
    prbs = tuple(list(range(0, 4)) + list(range(12, 16)) + list(range(20, 24)))
    grant = r_pdsch.DlGrant(prb=prbs, mod=dl_mcs_to_mod(8), tbs=dl_tbs(8, len(prbs)), rnti=rnti)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    d1 = Dci1(rbg_bitmap=Dci1.bitmap_for_prbs(prbs, 25), mcs=8, harq_pid=2)
    sched = DlSched(cfi=2, dcis=[(d1.pack(25), rnti, 4, 0)], grants=[(grant, tb)])
    tx = np.asarray(enb_dl_subframe(cell, 4, sched)[1])
    rx = awgn(rng, tx[:1], 0.02)
    ref = r_decode(cell, rx, 4, rnti, known_cfi=2, tm=1)
    got = t_decode(from_reference(cell), rx, 4, rnti, known_cfi=2, tm=1, device=CPU)
    same_result(got, ref)
    assert got.dci_format == "1" and got.tbs[0][1]

    cell = Cell(nof_prb=15, nof_ports=1, id=31)
    grant = r_pdsch.DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(6), tbs=dl_tbs(6, 15), rnti=rnti)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    dci = Dci1A(riv=riv_encode(15, 0, 15), mcs=6, harq_pid=0)
    sched = DlSched(cfi=2, dcis=[(dci.pack(15), rnti, 4, 0)], grants=[(grant, tb)])
    tx = np.asarray(enb_dl_subframe(cell, 2, sched)[1])
    h = np.array([[0.05 + 0.05j], [1.0 + 0.0j]], np.complex64)
    rx = awgn(rng, np.einsum("rp,pt->rt", h, tx[:1]), 0.03)
    ref = r_decode(cell, rx, 2, rnti, nrx=2, known_cfi=2)
    got = t_decode(from_reference(cell), rx, 2, rnti, nrx=2, known_cfi=2, device=CPU)
    same_result(got, ref)
    assert got.tbs[0][1] and (got.tbs[0][0] == tb).all()


AMP_NDI = 0.3


def test_ue_dl_harq_ndi_and_zero_input():
    """HARQ across two calls (rv 0 fails at low SNR, rv 2 combines); a new
    NDI drops the stored softbuffer; an all-zero subframe (no channel, no
    noise) gives finite results and no DCI."""
    cell = Cell(nof_prb=15, nof_ports=1, id=40)
    pcell = from_reference(cell)
    rng = np.random.default_rng(5)
    rnti, mcs = 0x46, 16
    tbs = dl_tbs(mcs, 15)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    hr, ht = {}, {}
    # rv 0 fails and is stored; a new NDI fails alone (the stored buffer of
    # the old one is dropped, not combined); its rv 2 combines and passes
    for sf_idx, rv, ndi, want in ((1, 0, 0, False), (2, 0, 1, False), (3, 2, 1, True)):
        grant = r_pdsch.DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(mcs), tbs=tbs, rv=rv,
                                rnti=rnti)
        dci = Dci1A(riv=riv_encode(15, 0, 15), mcs=mcs, harq_pid=3, ndi=ndi, rv=rv)
        sched = DlSched(cfi=3, dcis=[(dci.pack(15), rnti, 8, 0)], grants=[(grant, tb)])
        rx = awgn(rng, np.asarray(enb_dl_subframe(cell, sf_idx, sched)[1]), AMP_NDI)
        ref = r_decode(cell, rx, sf_idx, rnti, harq_softbuffers=hr)
        got = t_decode(pcell, rx, sf_idx, rnti, harq_softbuffers=ht, device=CPU)
        same_result(got, ref)
        assert [ok for _, ok in got.tbs] == [want]
        assert ht.keys() == hr.keys()
        for k in hr:
            assert ht[k][0] == hr[k][0]
            for g, r in zip(ht[k][1], hr[k][1]):
                close(g.numpy(), np.asarray(r), 2e-6)
    zero = np.zeros((1, cell.sf_len), np.complex64)
    ref = r_decode(cell, zero, 1, rnti, known_cfi=1)
    got = t_decode(pcell, zero, 1, rnti, known_cfi=1, device=CPU)
    assert got.dcis == [] and ref.dcis == [] and got.tbs == []


def test_ue_dl_dynamic_equals_static():
    """`dynamic=` with the port's DynamicUeDl gives the TBs of the call
    without it (15 PRB frame, subframes 0-4)."""
    from srsran_tpu_torch.pipeline_dynamic import DynamicUeDl

    cell = Cell(nof_prb=15, nof_ports=1, id=84)
    pcell = from_reference(cell)
    stream, tbs = make_frame(cell, 0x5A, 9, seed=3)
    rx = awgn(np.random.default_rng(1), stream, 0.01)
    dyn = DynamicUeDl(pcell, cfi=2, max_iterations=5, device=CPU)
    for sf_idx in range(5):
        sf = rx[sf_idx * cell.sf_len : (sf_idx + 1) * cell.sf_len][None]
        a = t_decode(pcell, sf, sf_idx, 0x5A, device=CPU)
        b = t_decode(pcell, sf, sf_idx, 0x5A, dynamic=dyn, device=CPU)
        assert [ok for _, ok in b.tbs] == [ok for _, ok in a.tbs] == [True]
        np.testing.assert_array_equal(b.tbs[0][0], a.tbs[0][0])
        np.testing.assert_array_equal(b.tbs[0][0], tbs[sf_idx])
        assert (b.dci_format, b.cce_used) == (a.dci_format, a.cce_used)
    assert dyn.stats["ttis"] == 5


def test_ue_dl_refuses_what_is_not_ported():
    cell = from_reference(Cell(nof_prb=6))
    zero = np.zeros((1, cell.sf_len), np.complex64)
    with pytest.raises(NotImplementedError, match="Slice 10"):
        t_decode(cell, zero, 0, 0x46, tdd=object(), device=CPU)


def test_ue_dl_deferred_queues_on_a_windowed_plane():
    """`deferred=` with the port's WindowedUeDlPlane: each grant's PDSCH is
    queued (deferred result, no TBs, the DCI and CCE kept), and the window
    realized REALIZE_DELAY TTIs after its dispatch gives the TBs of the
    static call (15 PRB frame, subframes 0-3, W = 4)."""
    from srsran_tpu_torch.apps.windowed_plane import REALIZE_DELAY, WindowedUeDlPlane

    cell = Cell(nof_prb=15, nof_ports=1, id=84)
    pcell = from_reference(cell)
    stream, tbs = make_frame(cell, 0x5A, 9, seed=3)
    rx = awgn(np.random.default_rng(1), stream, 0.01)
    plane = WindowedUeDlPlane(pcell, cfi=2, w=4, device=CPU)
    for sf_idx in range(4):
        sf = torch.from_numpy(rx[sf_idx * cell.sf_len : (sf_idx + 1) * cell.sf_len][None])
        plane.current_tti = sf_idx
        a = t_decode(pcell, sf, sf_idx, 0x5A, device=CPU)
        b = t_decode(pcell, sf, sf_idx, 0x5A, deferred=plane, device=CPU)
        assert b.deferred and b.tbs == [] and not a.deferred
        assert (b.dci_format, b.cce_used) == (a.dci_format, a.cce_used)
        plane.flush(sf_idx)
    assert plane.poll(3 + REALIZE_DELAY - 1) == []
    events = plane.poll(3 + REALIZE_DELAY)
    assert [ev["tti"] for ev in events] == [0, 1, 2, 3]
    for ev in events:
        (tb, ok), = ev["tbs"]
        assert ok
        np.testing.assert_array_equal(tb, tbs[ev["tti"]])


# --- the golden vectors through the port ---------------------------------------


def _load(name):
    return np.fromfile(os.path.join(VEC, name), np.complex64)


MIB_PAYLOAD = np.array(
    [0, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.uint8)


def test_golden_pbch_file_mib():
    """signal.1.92M.dat: the MIB at 2 ports, SFN offset 0, sfn 28, 50 PRB."""
    from srsran_tpu_torch.phy.common import Cell as TCell
    from srsran_tpu_torch.phy.ue.ue_sync import mib_search

    mib, nports, sfn_off = mib_search(_load("signal.1.92M.dat"), TCell(nof_prb=6, id=150),
                                      sf0_start=0, device=CPU)
    assert (nports, sfn_off, mib.nof_prb, mib.sfn) == (2, 0, 50, 28)
    np.testing.assert_array_equal(mib.pack(), MIB_PAYLOAD)


def test_golden_cell_search():
    """signal.1.92M.amar.dat: PCI 1 at subframe 0, psr > 10."""
    from srsran_tpu_torch.phy.ue.ue_sync import cell_search

    res = cell_search(_load("signal.1.92M.amar.dat"), 6, device=CPU)
    assert res is not None and res.cell_id == 1 and res.sf_idx == 0 and res.psr > 10


def test_golden_pcfich_cfi():
    """CFI 3 in every subframe of the amar capture, with the correlation
    margin of the reference's test."""
    from srsran_tpu_torch.phy.chest.chest_dl import chest_dl
    from srsran_tpu_torch.phy.common import Cell as TCell
    from srsran_tpu_torch.phy.ofdm import OfdmConfig as TOfdm, ofdm_rx_sf as t_ofdm_rx
    from srsran_tpu_torch.phy.phch.pcfich import pcfich_decode, pcfich_re_indices

    x = t(_load("signal.1.92M.amar.dat"))
    cell = TCell(nof_prb=6, nof_ports=1, id=1)
    idx = torch.from_numpy(pcfich_re_indices(cell).astype(np.int64))
    for sf in range(10):
        grid = t_ofdm_rx(TOfdm.from_cell(cell, normalize=True), x[sf * 1920 : (sf + 1) * 1920][None])
        ch = chest_dl(grid, cell, sf, nof_ports=1)
        ce = ch["ce"][0, 0].reshape(-1)[idx]
        eq = grid[0].reshape(-1)[idx] * torch.conj(ce) / (ce.abs() ** 2 + ch["noise"].reshape(-1)[0])
        cfi, corr = pcfich_decode(eq, cell, sf)
        c = corr.numpy()
        assert int(cfi) == 3 and c[2] > 2 * abs(c[0]) and c[2] > 2 * abs(c[1])


def test_golden_sib_decode():
    """The SI-RNTI SIBs of the amar capture: subframe 5 (144 bits, 604004…)
    and subframe 2 (256 bits, 00800c…), as the reference decodes them."""
    x = _load("signal.1.92M.amar.dat")
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    decoded = {}
    for sf in range(10):
        sf_x = x[sf * 1920 : (sf + 1) * 1920][None]
        got = t_decode(from_reference(cell), sf_x, sf, 0xFFFF, known_cfi=3, device=CPU)
        if sf in (2, 5):
            same_result(got, r_decode(cell, sf_x, sf, 0xFFFF, known_cfi=3))
        for tb, ok in got.tbs:
            if ok:
                decoded[sf] = np.packbits(tb).tobytes()
    assert sorted(decoded) == [2, 5]
    assert len(decoded[5]) * 8 == 144 and decoded[5].hex().startswith("604004")
    assert len(decoded[2]) * 8 == 256 and decoded[2].hex().startswith("00800c")
