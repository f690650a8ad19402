"""The port's control channels against the JAX reference on the CPU: the
tail-biting convolutional code and its Viterbi decoder, the convolutional
rate match, the REG interleaver, the DCI formats, PCFICH, PHICH, PDCCH, PBCH,
the Reed-Muller UCI codes, PUCCH formats 1-3 and UCI on PUSCH.

The same numpy inputs, made from a seed, go through the reference function
and its counterpart.  Tolerances: host tables, encoded bits, DCI fields and
every decoded bit are identical; the Viterbi's bits are identical for
noiseless, noisy and pure-noise rows; decode metrics within 1e-4 (PCFICH,
PHICH, Reed-Muller) or 1e-3 (PUCCH); PUCCH grids and rendered uplink
samples within 2e-6 absolute; a de-rate-matched LLR array within 1e-6
(repetitions may sum in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.common as r_common
import srsran_tpu.phy.crc as r_crc
import srsran_tpu.phy.fec.conv as r_conv
import srsran_tpu.phy.fec.rate_match as r_rm
import srsran_tpu.phy.phch.dci as r_dci
import srsran_tpu.phy.phch.pbch as r_pbch
import srsran_tpu.phy.phch.pcfich as r_pcfich
import srsran_tpu.phy.phch.pdcch as r_pdcch
import srsran_tpu.phy.phch.phich as r_phich
import srsran_tpu.phy.phch.pucch as r_pucch
import srsran_tpu.phy.phch.pusch as r_pusch
import srsran_tpu.phy.phch.ra as r_ra
import srsran_tpu.phy.phch.uci as r_uci
import srsran_tpu.phy.ue.ue_ul as r_ue_ul
import srsran_tpu_torch.phy.crc as t_crc
import srsran_tpu_torch.phy.fec.conv as t_conv
import srsran_tpu_torch.phy.fec.rate_match as t_rm
import srsran_tpu_torch.phy.phch.dci as t_dci
import srsran_tpu_torch.phy.phch.pbch as t_pbch
import srsran_tpu_torch.phy.phch.pcfich as t_pcfich
import srsran_tpu_torch.phy.phch.pdcch as t_pdcch
import srsran_tpu_torch.phy.phch.phich as t_phich
import srsran_tpu_torch.phy.phch.pucch as t_pucch
import srsran_tpu_torch.phy.phch.pusch as t_pusch
import srsran_tpu_torch.phy.phch.uci as t_uci
import srsran_tpu_torch.phy.ue.ue_ul as t_ue_ul
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)

GRID_ATOL = 2e-6


def cells(**kw):
    """(reference Cell, the port's Cell) of one configuration."""
    ref = r_common.Cell(**dict(kw, cp=r_common.CP(kw.get("cp", 0))))
    return ref, from_reference(ref)


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def t(x):
    return torch.from_numpy(np.array(x))


# --- convolutional code and Viterbi ---------------------------------------------


def test_conv_tables_and_encoder():
    for a, b in zip(t_conv._tables(), r_conv._tables()):
        np.testing.assert_array_equal(a, b)
    assert t_conv.POLYS == r_conv.POLYS
    rng = np.random.default_rng(0)
    for d in (40, 44, 52, 61, 80):
        bits = rng.integers(0, 2, d).astype(np.uint8)
        np.testing.assert_array_equal(t_conv.convcoder_encode_np(bits),
                                      r_conv.convcoder_encode_np(bits))


@pytest.mark.parametrize("d", [44, 40])
@pytest.mark.parametrize("kind", ["noiseless", "awgn", "noise"])
def test_viterbi_bits_identical(d, kind):
    """Rows from the encoder (clean or at a few SNRs) and rows of pure noise:
    the hard bits equal the reference's, ties and all."""
    rng = np.random.default_rng(d + len(kind))
    rows = []
    for _ in range(48):
        cw = r_conv.convcoder_encode_np(rng.integers(0, 2, d).astype(np.uint8))
        llr = (2.0 * cw.astype(np.float32) - 1.0) * 3.0
        if kind == "awgn":
            llr = llr + rng.standard_normal(llr.shape).astype(np.float32) * rng.uniform(0.5, 3.0)
        elif kind == "noise":
            llr = rng.standard_normal(llr.shape).astype(np.float32) * 2.0
        rows.append(llr)
    # integer-valued rows tie often: the first-candidate rule decides them
    rows.append(rng.integers(-2, 3, (3, d)).astype(np.float32))
    batch = np.stack(rows).astype(np.float32)
    ref = np.asarray(r_conv.viterbi_decode(jnp.asarray(batch), d))
    got = t_conv.viterbi_decode(torch.from_numpy(batch), d)
    assert got.dtype == torch.uint8 and got.shape == (batch.shape[0], d)
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "noiseless":
        msgs = [row for row in batch[:48]]
        assert all(np.array_equal(r_conv.convcoder_encode_np(b), (m > 0).astype(np.uint8))
                   for b, m in zip(got.numpy()[:48], msgs))


def test_viterbi_rejects_a_wrong_shape():
    with pytest.raises(ValueError):
        t_conv.viterbi_decode(torch.zeros(4, 3, 40), 44)


def test_crc_compute_np():
    rng = np.random.default_rng(1)
    for poly in (r_common.LTE_CRC16, r_common.LTE_CRC8, r_common.LTE_CRC24A):
        for n in (1, 24, 28, 57):
            bits = rng.integers(0, 2, n).astype(np.uint8)
            got = t_crc.crc_compute_np(bits, poly)
            np.testing.assert_array_equal(got, r_crc.crc_compute_np(bits, poly))
            assert got.dtype == np.uint8


# --- convolutional rate matching -------------------------------------------------


@pytest.mark.parametrize("d", [40, 44, 61, 70])
def test_conv_rate_match(d):
    rng = np.random.default_rng(d)
    assert np.array_equal(t_rm.RM_PERM_CC, np.asarray(r_rm.RM_PERM_CC))
    for e in (72, 144, 120, 288, 576, 1920):
        np.testing.assert_array_equal(t_rm.conv_rm_indices(d, e), r_rm.conv_rm_indices(d, e))
        coded = rng.integers(0, 2, (3, d)).astype(np.uint8)
        np.testing.assert_array_equal(t_rm.conv_rate_match_tx(coded, e),
                                      np.asarray(r_rm.conv_rate_match_tx(coded, e)))
        llr = rng.standard_normal((5, e)).astype(np.float32)
        ref = np.asarray(r_rm.conv_rate_match_rx(jnp.asarray(llr), d))
        got = t_rm.conv_rate_match_rx(torch.from_numpy(llr), d).numpy()
        assert got.shape == ref.shape == (5, 3, d)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t_rm.conv_rate_match_rx_np(llr, d),
                                      r_rm.conv_rate_match_rx_np(llr, d))
        np.testing.assert_array_equal(t_rm.conv_rate_match_rx_batch_np(llr, d),
                                      r_rm.conv_rate_match_rx_batch_np(llr, d))
        np.testing.assert_allclose(t_rm.conv_rate_match_rx_batch_np(llr, d),
                                   t_rm.conv_rate_match_rx_np(llr, d), rtol=0, atol=1e-5)


# --- DCI formats -----------------------------------------------------------------


def _dci_cases(nof_prb, rng):
    riv = r_ra.riv_encode(nof_prb, 1, nof_prb - 2)
    nrbg = r_dci.Dci1.nof_rbg(nof_prb)
    bm = int(rng.integers(1, 2 ** nrbg))
    r = lambda n: int(rng.integers(0, n))  # noqa: E731
    return [
        ("Dci1A", dict(riv=riv, mcs=r(32), harq_pid=r(8), ndi=1, rv=r(4), tpc=r(4)), {}, {}),
        ("Dci1A", dict(riv=riv, mcs=r(32), harq_pid=r(16), ndi=0, rv=r(4), tpc=r(4), dai=r(4)),
         dict(tdd=True), dict(tdd=True)),
        ("Dci0", dict(riv=riv, mcs=r(32), ndi=1, tpc=r(4), dmrs_cshift=r(8), cqi_request=True),
         {}, {}),
        ("Dci0", dict(riv=riv, mcs=r(32), ndi=0, tpc=r(4), dmrs_cshift=r(8), dai=r(4)),
         dict(tdd=True), dict(tdd=True)),
        ("Dci1B", dict(riv=riv, mcs=r(32), harq_pid=r(8), ndi=1, rv=r(4), tpc=r(4), tpmi=r(4),
                       pmi_confirm=1), dict(nof_ports=2), dict(nof_ports=2)),
        ("Dci1B", dict(riv=riv, mcs=r(32), harq_pid=r(8), ndi=1, rv=r(4), tpc=r(4), tpmi=r(16)),
         dict(nof_ports=4), dict(nof_ports=4)),
        ("Dci1D", dict(riv=riv, mcs=r(32), harq_pid=r(8), ndi=1, rv=r(4), tpc=r(4), tpmi=r(4),
                       power_offset=1), dict(nof_ports=2), dict(nof_ports=2)),
        ("Dci1", dict(rbg_bitmap=bm, mcs=r(32), harq_pid=r(8), ndi=1, rv=r(4), tpc=r(4)), {}, {}),
        ("Dci1C", dict(riv=r(1 << r_dci.riv_nbits(nof_prb // 4 or 1)) if nof_prb >= 50 else 5,
                       tbs_idx=r(32)), {}, {}),
        ("Dci2", dict(rbg_bitmap=bm, tpc=r(4), harq_pid=r(8), swap_flag=1, mcs1=r(32), ndi1=1,
                      rv1=r(4), mcs2=r(32), ndi2=0, rv2=r(4), precoding_info=1, fmt="2"),
         dict(nof_ports=2), dict(fmt="2", nof_ports=2)),
        ("Dci2", dict(rbg_bitmap=bm, tpc=r(4), harq_pid=r(8), swap_flag=0, mcs1=r(32), ndi1=0,
                      rv1=r(4), mcs2=r(32), ndi2=1, rv2=r(4), precoding_info=0, fmt="2a"),
         dict(nof_ports=2), dict(fmt="2a", nof_ports=2)),
    ]


@pytest.mark.parametrize("nof_prb", [6, 25, 50, 100])
def test_dci_pack_unpack(nof_prb):
    rng = np.random.default_rng(nof_prb)
    assert t_dci.riv_nbits(nof_prb) == r_dci.riv_nbits(nof_prb)
    for name, fields, pack_kw, unpack_kw in _dci_cases(nof_prb, rng):
        ref_cls, port_cls = getattr(r_dci, name), getattr(t_dci, name)
        ref_bits = np.asarray(ref_cls(**fields).pack(nof_prb, **pack_kw))
        got_bits = port_cls(**fields).pack(nof_prb, **pack_kw)
        np.testing.assert_array_equal(got_bits, ref_bits, err_msg=name)
        assert got_bits.dtype == ref_bits.dtype
        back_ref = ref_cls.unpack(ref_bits, nof_prb, **unpack_kw)
        back = port_cls.unpack(got_bits, nof_prb, **unpack_kw)
        assert dataclasses.asdict(back) == dataclasses.asdict(back_ref), name
        if hasattr(ref_cls, "nof_bits") and name != "Dci2":
            kw = {k: v for k, v in pack_kw.items()}
            assert port_cls.nof_bits(nof_prb, **kw) == ref_cls.nof_bits(nof_prb, **kw)
    for fmt in ("2", "2a", "2b"):
        for ports in (2, 4):
            assert (t_dci.Dci2.nof_bits(nof_prb, fmt, ports)
                    == r_dci.Dci2.nof_bits(nof_prb, fmt, ports))
    assert t_dci.Dci1.nof_rbg(nof_prb) == r_dci.Dci1.nof_rbg(nof_prb)
    prbs = tuple(range(0, nof_prb, 3))
    assert t_dci.Dci1.bitmap_for_prbs(prbs, nof_prb) == r_dci.Dci1.bitmap_for_prbs(prbs, nof_prb)


# --- PCFICH / PHICH ----------------------------------------------------------------

CTRL_CELLS = [dict(nof_prb=6, id=0), dict(nof_prb=25, id=7), dict(nof_prb=100, id=301),
              dict(nof_prb=50, id=17, nof_ports=2), dict(nof_prb=15, id=11, cp=1)]


@pytest.mark.parametrize("kw", CTRL_CELLS)
def test_pcfich(kw):
    ref, port = cells(**kw)
    rng = np.random.default_rng(kw["id"])
    np.testing.assert_array_equal(t_pcfich.pcfich_re_indices(port),
                                  r_pcfich.pcfich_re_indices(ref))
    for cfi in (1, 2, 3):
        np.testing.assert_array_equal(t_pcfich.cfi_codeword(cfi), r_pcfich.cfi_codeword(cfi))
        for sf in (0, 4, 9):
            assert t_pcfich.pcfich_cinit(sf, port.id) == r_pcfich.pcfich_cinit(sf, ref.id)
            shape = (max(port.nof_ports, 1), port.nsymb_per_sf, port.nof_re_per_symbol)
            g_ref = r_pcfich.pcfich_put_np(np.zeros(shape, np.complex64), ref, sf, cfi)
            g_got = t_pcfich.pcfich_put_np(np.zeros(shape, np.complex64), port, sf, cfi)
            np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=1e-7)
            sym = awgn(rng, g_ref[0, 0, r_pcfich.pcfich_re_indices(ref)], 0.3)
            c_ref, corr_ref = r_pcfich.pcfich_decode(jnp.asarray(sym), ref, sf)
            c_got, corr_got = t_pcfich.pcfich_decode(t(sym), port, sf)
            assert int(c_got) == int(c_ref)
            np.testing.assert_allclose(corr_got.numpy(), np.asarray(corr_ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", CTRL_CELLS)
def test_phich(kw):
    ref, port = cells(**kw)
    rng = np.random.default_rng(kw["id"] + 1)
    nsf = r_phich.phich_nsf(ref)
    assert t_phich.phich_nsf(port) == nsf and t_phich.phich_len(port) == r_phich.phich_len(ref)
    assert t_phich.nof_phich_sequences(port) == r_phich.nof_phich_sequences(ref)
    for ng in (None, 1 / 6, 1.0, 2.0):
        assert t_phich.nof_phich_groups(port, ng) == r_phich.nof_phich_groups(ref, ng)
    for n_seq in range(2 * nsf):
        np.testing.assert_array_equal(t_phich.phich_sequence(n_seq, nsf),
                                      r_phich.phich_sequence(n_seq, nsf))
        for ack in (0, 1):
            np.testing.assert_array_equal(t_phich.phich_encode(ack, n_seq, nsf),
                                          r_phich.phich_encode(ack, n_seq, nsf))
    shape = (max(port.nof_ports, 1), port.nsymb_per_sf, port.nof_re_per_symbol)
    for group in range(r_phich.nof_phich_groups(ref)):
        np.testing.assert_array_equal(t_phich.phich_re_indices(port, group),
                                      r_phich.phich_re_indices(ref, group))
        sf = (3 * group + 1) % 10
        g_ref, g_got = np.zeros(shape, np.complex64), np.zeros(shape, np.complex64)
        for n_seq, ack in ((0, group & 1), (nsf + 1, 1 - (group & 1))):
            r_phich.phich_put_np(g_ref, ref, sf, group, n_seq, ack)
            t_phich.phich_put_np(g_got, port, sf, group, n_seq, ack)
        np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=1e-7)
        sym = awgn(rng, g_ref[0].reshape(-1)[r_phich.phich_re_indices(ref, group)], 0.2)
        for n_seq in (0, nsf + 1, 1):
            a_ref, m_ref = r_phich.phich_decode(jnp.asarray(sym), ref, sf, n_seq)
            a_got, m_got = t_phich.phich_decode(t(sym), port, sf, n_seq)
            assert int(a_got) == int(a_ref)
            assert abs(float(m_got) - float(m_ref)) < 1e-4


# --- PDCCH ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", CTRL_CELLS)
def test_pdcch_tables(kw):
    ref, port = cells(**kw)
    for cfi in (1, 2, 3):
        np.testing.assert_array_equal(t_pdcch.pdcch_re_indices(port, 0, cfi),
                                      r_pdcch.pdcch_re_indices(ref, 0, cfi))
        assert t_pdcch.nof_cce(port, 0, cfi) == r_pdcch.nof_cce(ref, 0, cfi)
    for rnti in (0x46, 0x1234, 0xFFFF):
        for sf in range(10):
            for n in (2, 21, 52, 87):
                for ue in (True, False):
                    assert (t_pdcch.search_space_candidates(rnti, sf, n, ue)
                            == r_pdcch.search_space_candidates(rnti, sf, n, ue))
                    assert (t_pdcch._blind_candidates(rnti, sf, n, ue)
                            == r_pdcch._blind_candidates(rnti, sf, n, ue))
        np.testing.assert_array_equal(t_pdcch._blind_signs(rnti, 3, port.id, 720),
                                      r_pdcch._blind_signs(rnti, 3, ref.id, 720))
    assert t_pdcch.pdcch_cinit(0, 7, port.id) == r_pdcch.pdcch_cinit(0, 7, ref.id)


@pytest.mark.parametrize("kw", [dict(nof_prb=25, id=7), dict(nof_prb=100, id=301),
                                dict(nof_prb=50, id=17, nof_ports=2)])
def test_pdcch_encode_and_blind_search(kw):
    """Two DCIs (a 1A and a DCI 0 of the same size) and noise: the port's
    blind search finds what the reference finds, candidate for candidate."""
    ref, port = cells(**kw)
    rng = np.random.default_rng(kw["id"])
    nof_prb, cfi, rnti = kw["nof_prb"], 2, 0x4601
    shape = (max(port.nof_ports, 1), port.nsymb_per_sf, port.nof_re_per_symbol)
    for sf in (0, 5, 8):
        n = r_pdcch.nof_cce(ref, sf, cfi)
        cands = r_pdcch.search_space_candidates(rnti, sf, n)
        d1a = r_dci.Dci1A(riv=r_ra.riv_encode(nof_prb, 0, nof_prb // 2), mcs=int(rng.integers(29)),
                          harq_pid=int(rng.integers(8)), ndi=1)
        bits = np.asarray(d1a.pack(nof_prb))
        d0 = r_dci.Dci0(riv=r_ra.riv_encode(nof_prb, 1, 4), mcs=5, ndi=1, tpc=1)
        bits0 = np.asarray(d0.pack(nof_prb))
        for agg in (1, 2, 4, 8):
            np.testing.assert_array_equal(t_pdcch.dci_encode_np(bits, rnti, agg),
                                          r_pdcch.dci_encode_np(bits, rnti, agg))
        g_ref, g_got = np.zeros(shape, np.complex64), np.zeros(shape, np.complex64)
        cce4 = cands[4][0]
        cce2 = next(c for c in cands[2] if c + 2 <= cce4 or c >= cce4 + 4)
        for g, mod, cc in ((g_ref, r_pdcch, ref), (g_got, t_pdcch, port)):
            mod.pdcch_put_np(g, cc, sf, cfi, bits, rnti, 4, cce4)
            mod.pdcch_put_np(g, cc, sf, cfi, bits0, rnti, 2, cce2)
        np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=1e-7)
        idx = r_pdcch.pdcch_re_indices(ref, sf, cfi)[: n * 36]
        sym = awgn(rng, g_ref[0].reshape(-1)[idx], 0.15)
        f_ref = r_pdcch.pdcch_blind_search(jnp.asarray(sym), ref, sf, cfi, rnti, len(bits))
        f_got = t_pdcch.pdcch_blind_search(t(sym), port, sf, cfi, rnti, len(bits))
        assert len(f_got) == len(f_ref) >= 2
        for (b_g, l_g, s_g), (b_r, l_r, s_r) in zip(f_got, f_ref):
            np.testing.assert_array_equal(b_g, b_r)
            assert (l_g, s_g) == (l_r, s_r)


# --- PBCH ----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(nof_prb=6, id=0), dict(nof_prb=100, id=301),
                                dict(nof_prb=50, id=17, nof_ports=2)])
def test_pbch(kw):
    ref, port = cells(**kw)
    rng = np.random.default_rng(kw["id"] + 2)
    np.testing.assert_array_equal(t_pbch.pbch_re_indices(port), r_pbch.pbch_re_indices(ref))
    for sfn in (0, 5, 127, 1023):
        mib_r = r_pbch.Mib(nof_prb=kw["nof_prb"], phich_length=sfn & 1, phich_resources=sfn % 4,
                           sfn=sfn)
        mib_t = from_reference(mib_r)
        np.testing.assert_array_equal(mib_t.pack(), mib_r.pack())
        assert dataclasses.asdict(t_pbch.Mib.unpack(mib_t.pack())) == dataclasses.asdict(
            r_pbch.Mib.unpack(mib_r.pack()))
        for ports in (1, 2, 4):
            np.testing.assert_array_equal(t_pbch.pbch_encode_np(mib_t, port, ports),
                                          r_pbch.pbch_encode_np(mib_r, ref, ports))
        ports = max(kw.get("nof_ports", 1), 1)
        sym = awgn(rng, r_pbch.pbch_encode_np(mib_r, ref, ports)[sfn % 4], 0.3)
        out_r = r_pbch.pbch_decode(jnp.asarray(sym), ref)
        out_t = t_pbch.pbch_decode(t(sym), port)
        np.testing.assert_array_equal(out_t[0], out_r[0])
        assert tuple(out_t[1:]) == tuple(out_r[1:]) == (ports, sfn % 4, True)
    noise = awgn(rng, np.zeros(240, np.complex64), 1.0)
    out_r, out_t = r_pbch.pbch_decode(jnp.asarray(noise), ref), t_pbch.pbch_decode(t(noise), port)
    np.testing.assert_array_equal(out_t[0], out_r[0])
    assert tuple(out_t[1:]) == tuple(out_r[1:])


# --- UCI codes and the CQI packers ----------------------------------------------------


@pytest.mark.parametrize("use20", [False, True])
def test_rm_codes(use20):
    rng = np.random.default_rng(int(use20))
    basis = r_uci.RM20_BASIS if use20 else r_uci.RM32_BASIS
    for o in (1, 2, 5, 11, 13) if use20 else (1, 3, 4, 8, 11):
        for e in ((20,) if use20 else (20, 32, 48, 64)):
            np.testing.assert_array_equal(t_uci._codebook(o, e, use20),
                                          r_uci._codebook(o, e, use20))
            rows = []
            for _ in range(6):
                bits = rng.integers(0, 2, o).astype(np.uint8)
                cw = t_uci.rm_encode(bits, e, basis)
                np.testing.assert_array_equal(cw, r_uci.rm_encode(bits, e, basis))
                rows.append((2.0 * cw - 1.0) * 2 + rng.standard_normal(e) * 1.5)
            rows.append(np.zeros(e))  # every codeword ties: the first wins
            rows.append(rng.integers(-1, 2, e))
            llr = np.stack(rows).astype(np.float32)
            for row in llr:
                b_r, m_r = r_uci.rm_decode(jnp.asarray(row), o, use20)
                b_t, m_t = t_uci.rm_decode(torch.from_numpy(row), o, use20)
                np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_r))
                assert abs(float(m_t) - float(m_r)) < 1e-4
            b_all, m_all = t_uci.rm_decode(torch.from_numpy(llr), o, use20)
            assert b_all.shape == (len(rows), o) and m_all.shape == (len(rows),)


def test_cqi_packers():
    for prb in (6, 15, 25, 50, 75, 100):
        assert t_uci.cqi_hl_subband_size(prb) == r_uci.cqi_hl_subband_size(prb)
        assert t_uci.cqi_hl_nof_subbands(prb) == r_uci.cqi_hl_nof_subbands(prb)
    rng = np.random.default_rng(3)
    for _ in range(20):
        wb, sb = int(rng.integers(16)), int(rng.integers(16))
        assert t_uci.cqi_diff_encode(sb, wb) == r_uci.cqi_diff_encode(sb, wb)
        diffs = list(rng.integers(0, 4, 13))
        bits = t_uci.cqi_hl_subband_pack(wb, diffs)
        np.testing.assert_array_equal(bits, r_uci.cqi_hl_subband_pack(wb, diffs))
        assert t_uci.cqi_hl_subband_unpack(bits, 13) == r_uci.cqi_hl_subband_unpack(bits, 13)
        lab, lb = int(rng.integers(32)), int(rng.integers(0, 6))
        lab &= (1 << lb) - 1
        bits = t_uci.cqi_ue_subband_pack(wb, sb & 3, lab, lb)
        np.testing.assert_array_equal(bits, r_uci.cqi_ue_subband_pack(wb, sb & 3, lab, lb))
        assert t_uci.cqi_ue_subband_unpack(bits, lb) == r_uci.cqi_ue_subband_unpack(bits, lb)
        for two in (False, True):
            bits = t_uci.cqi_f2_subband_pack(sb, lab & (3 if two else 1), two)
            np.testing.assert_array_equal(bits, r_uci.cqi_f2_subband_pack(sb, lab & (3 if two else 1), two))
            assert t_uci.cqi_f2_subband_unpack(bits, two) == r_uci.cqi_f2_subband_unpack(bits, two)


# --- PUCCH -------------------------------------------------------------------------------

PUCCH_CELLS = [dict(nof_prb=25, id=33), dict(nof_prb=100, id=301), dict(nof_prb=15, id=11, cp=1)]


@pytest.mark.parametrize("kw", PUCCH_CELLS)
def test_pucch_tables(kw):
    ref, port = cells(**kw)
    np.testing.assert_array_equal(t_pucch.ncs_cell(port), r_pucch.ncs_cell(ref))
    assert t_pucch._f1_syms(port) == r_pucch._f1_syms(ref)
    assert t_pucch._f2_syms(port) == r_pucch._f2_syms(ref)
    assert t_pucch._f1_covers(port) == r_pucch._f1_covers(ref)
    for name in ("W2", "W3", "W4", "_W5"):
        np.testing.assert_array_equal(getattr(t_pucch, name), getattr(r_pucch, name))
    for n_pucch in (0, 3, 17, 40):
        for ns in range(20):
            assert t_pucch.pucch_prb(n_pucch, ns, port.nof_prb) == r_pucch.pucch_prb(
                n_pucch, ns, ref.nof_prb)
            for ds in (1, 2, 3):
                assert (t_pucch.pucch_f1_prb(n_pucch, ns, port.nof_prb, ds, covers=2)
                        == r_pucch.pucch_f1_prb(n_pucch, ns, ref.nof_prb, ds, covers=2))
                cfg_t = t_pucch.PucchConfig(n_pucch=n_pucch, delta_shift=ds)
                cfg_r = r_pucch.PucchConfig(n_pucch=n_pucch, delta_shift=ds)
                for a, b in zip(t_pucch._f1_alpha_cover(port, cfg_t, ns),
                                r_pucch._f1_alpha_cover(ref, cfg_r, ns)):
                    np.testing.assert_array_equal(a, b)


def test_pucch_tdd_channel_selection():
    states = [r_pucch.ACK, r_pucch.NACK, r_pucch.DTX]
    assert (t_pucch.ACK, t_pucch.NACK, t_pucch.DTX) == tuple(states)
    for m in (2, 3, 4):
        assert t_pucch._cs_decode_table(m) == r_pucch._cs_decode_table(m)
        for combo in np.ndindex(*(3,) * m):
            st = [states[i] for i in combo]
            assert t_pucch.tdd_channel_selection(st) == r_pucch.tdd_channel_selection(st)
        for res in range(m):
            for b0 in (0, 1):
                for b1 in (0, 1):
                    assert (t_pucch.tdd_channel_selection_decode(res, b0, b1, m)
                            == r_pucch.tdd_channel_selection_decode(res, b0, b1, m))


@pytest.mark.parametrize("kw", PUCCH_CELLS)
@pytest.mark.parametrize("nbits", [0, 1, 2])
def test_pucch_format1(kw, nbits):
    ref, port = cells(**kw)
    rng = np.random.default_rng(nbits + kw["id"])
    for n_pucch, sf in ((0, 0), (5, 3), (23, 9)):
        cfg_r, cfg_t = r_pucch.PucchConfig(n_pucch=n_pucch), t_pucch.PucchConfig(n_pucch=n_pucch)
        bits = rng.integers(0, 2, nbits).astype(np.uint8)
        g_ref = r_pucch.pucch_format1_encode_np(ref, cfg_r, sf, bits)
        g_got = t_pucch.pucch_format1_encode_np(port, cfg_t, sf, bits)
        np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=GRID_ATOL)
        rx = awgn(rng, g_ref * np.complex64(0.7 * np.exp(1j * 0.4)), 0.1)
        b_r, m_r = r_pucch.pucch_format1_decode(rx, ref, cfg_r, sf, nbits)
        b_t, m_t = t_pucch.pucch_format1_decode(rx, port, cfg_t, sf, nbits)
        np.testing.assert_array_equal(np.asarray(b_t), np.asarray(b_r))
        np.testing.assert_array_equal(np.asarray(b_t), bits)
        assert abs(float(m_t) - float(m_r)) < 1e-3


@pytest.mark.parametrize("kw", PUCCH_CELLS)
@pytest.mark.parametrize("nbits", [4, 10, 13])
def test_pucch_format2(kw, nbits):
    ref, port = cells(**kw)
    rng = np.random.default_rng(nbits + kw["id"])
    for n_pucch, sf in ((0, 1), (7, 6)):
        cfg_r, cfg_t = r_pucch.PucchConfig(n_pucch=n_pucch), t_pucch.PucchConfig(n_pucch=n_pucch)
        bits = rng.integers(0, 2, nbits).astype(np.uint8)
        g_ref = r_pucch.pucch_format2_encode_np(ref, cfg_r, sf, bits)
        np.testing.assert_allclose(t_pucch.pucch_format2_encode_np(port, cfg_t, sf, bits), g_ref,
                                   rtol=0, atol=GRID_ATOL)
        rx = awgn(rng, g_ref * np.complex64(0.9 * np.exp(-1j * 1.2)), 0.08)
        b_r, m_r = r_pucch.pucch_format2_decode(jnp.asarray(rx), ref, cfg_r, sf, nbits)
        b_t, m_t = t_pucch.pucch_format2_decode(t(rx), port, cfg_t, sf, nbits)
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_r))
        assert abs(float(m_t) - float(m_r)) < 1e-3


@pytest.mark.parametrize("ack", [[0], [1], [0, 1], [1, 0], [1, 1]])
def test_pucch_format2ab(ack):
    ref, port = cells(nof_prb=25, id=13)
    rng = np.random.default_rng(sum(ack) + 4 * len(ack))
    cfg_r, cfg_t = r_pucch.PucchConfig(n_pucch=3), t_pucch.PucchConfig(n_pucch=3)
    cqi = rng.integers(0, 2, 6).astype(np.uint8)
    g_ref = r_pucch.pucch_format2ab_encode_np(ref, cfg_r, 2, cqi, ack)
    np.testing.assert_allclose(t_pucch.pucch_format2ab_encode_np(port, cfg_t, 2, cqi, ack), g_ref,
                               rtol=0, atol=GRID_ATOL)
    rx = awgn(rng, g_ref, 0.1)
    c_r, a_r, m_r = r_pucch.pucch_format2ab_decode(jnp.asarray(rx), ref, cfg_r, 2, 6, len(ack))
    c_t, a_t, m_t = t_pucch.pucch_format2ab_decode(t(rx), port, cfg_t, 2, 6, len(ack))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(np.asarray(a_t), np.asarray(a_r))
    np.testing.assert_array_equal(np.asarray(a_t), ack)
    assert abs(float(m_t) - float(m_r)) < 1e-3


@pytest.mark.parametrize("nbits", [1, 4, 11, 12, 21])
def test_pucch_format3(nbits):
    ref, port = cells(nof_prb=25, id=123)
    rng = np.random.default_rng(nbits)
    for n_pucch, sf, rnti in ((7, 3, 0x4601), (2, 8, 0x46)):
        cfg_r, cfg_t = r_pucch.PucchConfig(n_pucch=n_pucch), t_pucch.PucchConfig(n_pucch=n_pucch)
        bits = rng.integers(0, 2, nbits).astype(np.uint8)
        np.testing.assert_array_equal(t_pucch._f3_coded_bits(bits), r_pucch._f3_coded_bits(bits))
        g_ref = r_pucch.pucch_format3_encode_np(ref, cfg_r, sf, bits, rnti)
        np.testing.assert_allclose(t_pucch.pucch_format3_encode_np(port, cfg_t, sf, bits, rnti),
                                   g_ref, rtol=0, atol=GRID_ATOL)
        rx = awgn(rng, g_ref * np.complex64(0.7 * np.exp(1j * 0.4)), 0.1)
        b_r, m_r = r_pucch.pucch_format3_decode(jnp.asarray(rx), ref, cfg_r, sf, nbits, rnti)
        b_t, m_t = t_pucch.pucch_format3_decode(t(rx), port, cfg_t, sf, nbits, rnti)
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_r))
        np.testing.assert_array_equal(b_t.numpy(), bits)
        assert abs(float(m_t) - float(m_r)) < 1e-3


# --- UCI on PUSCH and the UE uplink facade ---------------------------------------------

UCI_CASES = [
    dict(ack=(1,)),
    dict(ack=(0, 1), ri=(1,)),
    dict(cqi_bits=(1, 0, 1, 1)),
    dict(cqi_bits=(1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0), ack=(1,), ri=(0,)),
    dict(cqi_bits=tuple(int(b) for b in np.binary_repr(0x2B5C7, 20)), ack=(1, 1),
         i_offset_cqi=9, i_offset_ack=8),
]


def _ul_grant(mcs, prb_start, nof_prb, rnti=0x4601):
    ref = r_pusch.UlGrant(prb_start=prb_start, nof_prb=nof_prb, mod=r_ra.ul_mcs_to_mod(mcs),
                          tbs=r_ra.tbs_lookup(r_ra.ul_mcs_to_itbs(mcs), nof_prb), rnti=rnti)
    return ref, from_reference(ref)


@pytest.mark.parametrize("case", range(len(UCI_CASES)))
@pytest.mark.parametrize("mcs", [5, 18])
def test_pusch_encode_with_uci(case, mcs):
    ref, port = cells(nof_prb=25, id=7)
    rng = np.random.default_rng(case + mcs)
    g_ref, g_port = _ul_grant(mcs, 2, 10)
    uci_r = r_pusch.UciCfg(**UCI_CASES[case])
    uci_t = from_reference(uci_r)
    assert dataclasses.asdict(uci_t) == dataclasses.asdict(uci_r)
    tb = rng.integers(0, 2, g_ref.tbs).astype(np.uint8)
    for sf in (0, 7):
        want = r_pusch.pusch_encode_np(ref, sf, g_ref, tb, uci=uci_r)
        got = t_pusch.pusch_encode_np(port, sf, g_port, tb, uci=uci_t)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=GRID_ATOL)


def test_ue_ul_encode_with_pucch_and_uci():
    ref, port = cells(nof_prb=25, id=7)
    rng = np.random.default_rng(9)
    g_ref, g_port = _ul_grant(10, 4, 12)
    tb = rng.integers(0, 2, g_ref.tbs).astype(np.uint8)
    c_r = lambda n: r_pucch.PucchConfig(n_pucch=n)  # noqa: E731
    c_t = lambda n: t_pucch.PucchConfig(n_pucch=n)  # noqa: E731
    cqi = rng.integers(0, 2, 8).astype(np.uint8)
    f3 = rng.integers(0, 2, 14).astype(np.uint8)
    uci_r = r_pusch.UciCfg(ack=(1,), cqi_bits=(1, 0, 0, 1))
    cases = [
        (dict(pusch=(g_ref, tb), uci=uci_r), dict(pusch=(g_port, tb), uci=from_reference(uci_r))),
        (dict(pucch1=(c_r(2), [1])), dict(pucch1=(c_t(2), [1]))),
        (dict(pucch1=(c_r(5), [0, 1]), pucch2=(c_r(30), cqi)),
         dict(pucch1=(c_t(5), [0, 1]), pucch2=(c_t(30), cqi))),
        (dict(pusch=(g_ref, tb), pucch3=(c_r(40), f3, 0x4601), ta_samples=3, cfo=0.01),
         dict(pusch=(g_port, tb), pucch3=(c_t(40), f3, 0x4601), ta_samples=3, cfo=0.01)),
    ]
    for sf in (1, 6):
        for kw_r, kw_t in cases:
            want = r_ue_ul.ue_ul_encode(ref, sf, **kw_r)
            got = t_ue_ul.ue_ul_encode(port, sf, **kw_t, device="cpu")
            assert got.dtype == torch.complex64 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRID_ATOL)
    # the SRS with a shortened PUSCH that carries UCI
    want = r_ue_ul.ue_ul_encode(ref, 3, pusch=(g_ref, tb), uci=uci_r, srs=(0, 4))
    got = t_ue_ul.ue_ul_encode(port, 3, pusch=(g_port, tb), uci=from_reference(uci_r), srs=(0, 4),
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRID_ATOL)
