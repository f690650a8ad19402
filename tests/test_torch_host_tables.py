"""The port's numpy copies of the reference's host tables are equal to the
reference bit for bit (srsran_tpu_torch never imports srsran_tpu, so it
keeps its own copies)."""

import dataclasses

import numpy as np
import pytest
import torch

import srsran_tpu.phy.chest.chest_dl as r_chest
import srsran_tpu.phy.chest.refsignal_dl as r_rs
import srsran_tpu.phy.common as r_common
import srsran_tpu.phy.crc as r_crc
import srsran_tpu.phy.fec.cbsegm as r_cbsegm
import srsran_tpu.phy.fec.rate_match as r_rm
import srsran_tpu.phy.fec.rate_match_dev as r_rmd
import srsran_tpu.phy.fec.turbo as r_turbo
import srsran_tpu.phy.modem as r_modem
import srsran_tpu.phy.ofdm as r_ofdm
import srsran_tpu.phy.phch.pdsch as r_pdsch
import srsran_tpu.phy.phch.ra as r_ra
import srsran_tpu.phy.phch.sch as r_sch
import srsran_tpu.phy.phch.tbs_data as r_tbs_data
import srsran_tpu.phy.scrambling as r_scr
import srsran_tpu.phy.sequence as r_seq
import srsran_tpu.phy.sync.pss as r_pss
import srsran_tpu.phy.sync.sss as r_sss
import srsran_tpu.phy.tdd as r_tdd
import srsran_tpu_torch.phy.chest.chest_dl as t_chest
import srsran_tpu_torch.phy.chest.refsignal_dl as t_rs
import srsran_tpu_torch.phy.common as t_common
import srsran_tpu_torch.phy.crc as t_crc
import srsran_tpu_torch.phy.fec.cbsegm as t_cbsegm
import srsran_tpu_torch.phy.fec.rate_match as t_rm
import srsran_tpu_torch.phy.fec.rate_match_dev as t_rmd
import srsran_tpu_torch.phy.fec.turbo as t_turbo
import srsran_tpu_torch.phy.modem as t_modem
import srsran_tpu_torch.phy.ofdm as t_ofdm
import srsran_tpu_torch.phy.phch.pdsch as t_pdsch
import srsran_tpu_torch.phy.phch.ra as t_ra
import srsran_tpu_torch.phy.phch.sch as t_sch
import srsran_tpu_torch.phy.phch.tbs_data as t_tbs_data
import srsran_tpu_torch.phy.scrambling as t_scr
import srsran_tpu_torch.phy.sequence as t_seq
import srsran_tpu_torch.phy.sync.pss as t_pss
import srsran_tpu_torch.phy.sync.sss as t_sss
import srsran_tpu_torch.phy.tdd as t_tdd
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)

CELLS = [dict(nof_prb=6, id=0), dict(nof_prb=25, id=7, nof_ports=2),
         dict(nof_prb=100, id=301), dict(nof_prb=50, id=503, nof_ports=4),
         dict(nof_prb=15, id=11, cp=1)]


def cells(**kw):
    """(reference Cell, the port's Cell) of one configuration."""
    ref = r_common.Cell(**dict(kw, cp=r_common.CP(kw.get("cp", 0))))
    return ref, from_reference(ref)


def test_common_numerology():
    for prb in (6, 15, 25, 50, 75, 100):
        for std in (True, False):
            n = r_common.symbol_sz(prb, std)
            assert t_common.slot_len(n) == r_common.slot_len(n)
            assert t_common.sf_len(n) == r_common.sf_len(n)
            assert t_common.srate(prb, std) == r_common.srate(prb, std)
    for name in ("NRE", "MAX_PRB", "CP_NORM_0_LEN", "CP_NORM_LEN", "CP_EXT_LEN",
                 "LTE_CRC24A", "LTE_CRC24B", "LTE_CRC16", "LTE_CRC8", "SIRNTI", "PRNTI",
                 "MRNTI"):
        assert getattr(t_common, name) == getattr(r_common, name), name
    for prb in range(1, 101):
        for std in (True, False):
            assert t_common.symbol_sz(prb, std) == r_common.symbol_sz(prb, std)
            n = r_common.symbol_sz(prb, std)
            assert t_common.cp_len_ext(n) == r_common.cp_len_ext(n)
            for l in range(7):
                assert t_common.cp_len_norm(l, n) == r_common.cp_len_norm(l, n)


@pytest.mark.parametrize("kw", CELLS)
def test_cell_properties(kw):
    ref, port = cells(**kw)
    for prop in ("symbol_sz", "nsymb_per_slot", "nsymb_per_sf", "nof_re_per_symbol", "sf_len",
                 "n_id_1", "n_id_2"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert int(port.cp) == int(ref.cp) and port.cp.nsymb == ref.cp.nsymb
    assert port.cp_lengths_slot() == ref.cp_lengths_slot()


@pytest.mark.parametrize("c_init", [0, 1, 301, 0x1234 << 14 | 2 << 9 | 301, (1 << 31) - 1])
def test_gold_sequence(c_init):
    for length in (1, 28, 29, 1600, 90000):
        np.testing.assert_array_equal(t_seq.gold_sequence(c_init, length),
                                      r_seq.gold_sequence(c_init, length))
    np.testing.assert_array_equal(t_seq.gold_sequence_signs(c_init, 777),
                                  r_seq.gold_sequence_signs(c_init, 777))


@pytest.mark.parametrize("kw", CELLS)
def test_crs_tables(kw):
    ref, port = cells(**kw)
    for p in range(4):
        for a, b in zip(t_rs.crs_positions(port, p), r_rs.crs_positions(ref, p)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        for sf in (0, 2, 5, 9):
            np.testing.assert_array_equal(t_rs.crs_sequence_port(port, sf, p),
                                          r_rs.crs_sequence_port(ref, sf, p))


@pytest.mark.parametrize("prb", [6, 25, 100])
def test_pdsch_re_indices(prb):
    for nports, cell_id in ((1, 0), (2, 7), (4, 301)):
        ref, port = cells(nof_prb=prb, id=cell_id, nof_ports=nports)
        for sf in (0, 2, 5):
            for cfi in (1, 2, 3):
                for alloc in (tuple(range(prb)), tuple(range(1, prb, 3))):
                    np.testing.assert_array_equal(
                        t_pdsch.pdsch_re_indices(port, sf, cfi, alloc),
                        r_pdsch.pdsch_re_indices(ref, sf, cfi, alloc))
    assert t_pdsch.pdsch_cinit(0x1234, 2, 301, 1) == r_pdsch.pdsch_cinit(0x1234, 2, 301, 1)


def test_cbsegm_and_qpp_all_188_sizes():
    assert t_cbsegm.CB_SIZES == r_cbsegm.CB_SIZES and len(t_cbsegm.CB_SIZES) == 188
    for k in t_cbsegm.CB_SIZES:
        np.testing.assert_array_equal(t_cbsegm.qpp_interleaver_np(k), r_cbsegm.qpp_interleaver_np(k))
        assert t_cbsegm.cb_size_index(k) == r_cbsegm.cb_size_index(k)
    for tbs in list(range(16, 6200, 97)) + [61664, 75376, 97896, 6208, 9024]:
        assert (dataclasses.astuple(t_cbsegm.cbsegm(tbs))
                == dataclasses.astuple(r_cbsegm.cbsegm(tbs))), tbs


@pytest.mark.parametrize("k", [40, 528, 3200, 5632, 6144])
def test_turbo_rm_indices(k):
    for rv in range(4):
        for e in (120, 3 * (k + 4) - 6, 3 * (k + 4) + 500, 8184):
            for f in (0, 8, 56):
                np.testing.assert_array_equal(t_rm.turbo_rm_indices(k, e, rv, f),
                                              r_rm.turbo_rm_indices(k, e, rv, f))


@pytest.mark.parametrize("k_max", [768, 6144])
def test_j0_variant_np_every_rv_and_filler(k_max):
    """The host de-rate-match table of a layout class: every rv, with and
    without filler bits, the smallest and the largest K of the buffer."""
    assert t_rmd.ncb_max(k_max) == r_rmd.ncb_max(k_max)
    for k in (40, 512, k_max - 64, k_max):
        for f in (0, 8, 56):
            for rv in range(4):
                got, nv = t_rmd.j0_variant_np(k, f, rv, k_max)
                ref, nv_ref = r_rmd.j0_variant_np(k, f, rv, k_max)
                assert nv == nv_ref == 3 * (k + 4) - 2 * f and got.dtype == ref.dtype
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k_max", [768, 6144])
def test_tx_table_np_every_rv_and_filler(k_max):
    """The TX rate-match table of a layout class, every rv, with and without
    filler bits: equal to the reference and the inverse of `j0_variant_np`
    (rank j0[p] of position p transmits p)."""
    for k in (40, 512, k_max - 64, k_max):
        for f in (0, 8, 56):
            for rv in range(4):
                got, nv = t_rmd.tx_table_np(k, f, rv, k_max)
                ref, nv_ref = r_rmd.tx_table_np(k, f, rv, k_max)
                assert nv == nv_ref and got.dtype == ref.dtype == np.int32
                np.testing.assert_array_equal(got, ref)
                j0, _ = t_rmd.j0_variant_np(k, f, rv, k_max)
                np.testing.assert_array_equal(j0[got], np.arange(nv))


def test_pss_and_sss_sequences():
    """Every PSS root, the (m0, m1) pair of every N_id_1 and its SSS for both
    subframes and every N_id_2."""
    for n_id_2 in range(3):
        got = t_pss.pss_freq_np(n_id_2)
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, r_pss.pss_freq_np(n_id_2))
    for a, b in zip(t_sss._base_sequences(), r_sss._base_sequences()):
        np.testing.assert_array_equal(a, b)
    for n_id_1 in range(168):
        assert t_sss._m0m1(n_id_1) == r_sss._m0m1(n_id_1)
        for n_id_2 in range(3):
            for sf in (0, 5):
                got = t_sss.sss_sequence_np(n_id_1, n_id_2, sf)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, r_sss.sss_sequence_np(n_id_1, n_id_2, sf))


@pytest.mark.parametrize("nof_prb,cell_id", [(6, 0), (25, 301), (100, 503)])
def test_pss_and_sss_grid_writers(nof_prb, cell_id):
    ref_cell, cell = cells(nof_prb=nof_prb, id=cell_id)
    for sf in (0, 5):
        grids = [np.zeros((14, 12 * nof_prb), np.complex64) for _ in range(2)]
        t_pss.put_pss_grid(grids[0], cell.n_id_2, nof_prb, 6)
        t_sss.put_sss_grid(grids[0], cell.n_id_1, cell.n_id_2, sf, nof_prb, 5)
        r_pss.put_pss_grid(grids[1], ref_cell.n_id_2, nof_prb, 6)
        r_sss.put_sss_grid(grids[1], ref_cell.n_id_1, ref_cell.n_id_2, sf, nof_prb, 5)
        np.testing.assert_array_equal(grids[0], grids[1])
        assert np.count_nonzero(grids[0]) == 124


def test_qpp_np_all_188_sizes():
    for k in t_cbsegm.CB_SIZES:
        per, inv = t_rmd.qpp_np(k, 6144)
        r_per, r_inv = r_rmd.qpp_np(k, 6144)
        assert per.dtype == r_per.dtype and inv.dtype == r_inv.dtype
        np.testing.assert_array_equal(per, r_per)
        np.testing.assert_array_equal(inv, r_inv)
        np.testing.assert_array_equal(per[inv[:k]], np.arange(k))


def test_crc_matrices():
    # the TB CRC (24A) also at the headline tbs, 61664
    for poly in (t_common.LTE_CRC24A, t_common.LTE_CRC24B, t_common.LTE_CRC16, t_common.LTE_CRC8):
        assert t_crc.crc_order(poly) == r_crc.crc_order(poly)
        for n in (1, 40, 504, 5632) + ((61664,) if poly == t_common.LTE_CRC24A else ()):
            np.testing.assert_array_equal(t_crc.crc_matrix_np(poly, n), r_crc.crc_matrix_np(poly, n))


def test_trellis_and_window_layout():
    ref, port = r_turbo._trellis(), t_turbo._trellis()
    assert ref.keys() == port.keys()
    for key in ref:
        np.testing.assert_array_equal(port[key], ref[key])
    for k in t_cbsegm.CB_SIZES:
        assert t_turbo._window_layout(k) == r_turbo._window_layout(k), k
    for a, b in zip(t_turbo._perm_tables(5632), r_turbo._perm_tables(5632)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smooth,interp", [(3, True), (0, False)])
def test_chest_tables(smooth, interp):
    cfg_ref = r_chest.ChestDlConfig(smooth_len=smooth, time_interp=interp)
    cfg = from_reference(cfg_ref)
    for kw in CELLS[:3]:
        ref, port = cells(**kw)
        for p in range(min(ref.nof_ports, 2)):
            for a, b in zip(t_chest._chest_tables(port, 2, cfg, p),
                            r_chest._chest_tables(ref, 2, cfg_ref, p)):
                np.testing.assert_array_equal(a, b)


# --- the host transmitter (stimuli), bit for bit ------------------------------


def test_ra_tables_every_mcs_and_prb():
    for name in ("DL_MCS_TBS_IDX", "DL_MCS_TBS_IDX_256QAM", "UL_MCS_TBS_IDX", "TBS_TABLE"):
        assert getattr(t_tbs_data, name) == getattr(r_tbs_data, name), name
    for q256, n_mcs in ((False, 29), (True, 28)):
        for mcs in range(n_mcs):
            assert int(t_ra.dl_mcs_to_mod(mcs, q256)) == int(r_ra.dl_mcs_to_mod(mcs, q256))
            assert t_ra.dl_mcs_to_itbs(mcs, q256) == r_ra.dl_mcs_to_itbs(mcs, q256)
            for prb in range(1, 111):
                assert t_ra.dl_tbs(mcs, prb, q256) == r_ra.dl_tbs(mcs, prb, q256)
                assert t_ra.dl_tbs(mcs, prb, q256, dwpts=True) == r_ra.dl_tbs(mcs, prb, q256, dwpts=True)
        with pytest.raises(ValueError):
            t_ra.dl_mcs_to_mod(n_mcs, q256)
    assert t_ra.tbs_lookup(26, 100) == r_ra.tbs_lookup(26, 100) == 75376


@pytest.mark.parametrize("k", [40, 136, 1056, 6144])
def test_turbo_encoder_and_crc_attach(k):
    rng = np.random.default_rng(k)
    msg = rng.integers(0, 2, k - 24).astype(np.uint8)
    for poly in (t_common.LTE_CRC24A, t_common.LTE_CRC24B):
        cb = t_crc.crc_attach_np(msg, poly)
        np.testing.assert_array_equal(cb, r_crc.crc_attach_np(msg, poly))
    d = t_turbo.turbo_encode_np(cb)
    assert d.shape == (3, k + 4) and d.dtype == np.uint8
    np.testing.assert_array_equal(d, r_turbo.turbo_encode_np(cb))
    for rv in range(4):
        for e, f in ((3 * k, 0), (4000, 8)):
            np.testing.assert_array_equal(t_rm.turbo_rate_match_tx(d, e, rv, f),
                                          np.asarray(r_rm.turbo_rate_match_tx(d, e, rv, f)))


@pytest.mark.parametrize("mod", [0, 1, 2, 3, 4])
def test_modulate_and_scramble_bits(mod):
    rng = np.random.default_rng(mod)
    bits = rng.integers(0, 2, 240).astype(np.uint8)
    seq = t_seq.gold_sequence(0x2345, 240)
    np.testing.assert_array_equal(t_scr.scramble_bits(bits, seq),
                                  np.asarray(r_scr.scramble_bits(bits, seq)))
    np.testing.assert_array_equal(t_modem.constellation_np(t_modem.Mod(mod)),
                                  r_modem.constellation_np(r_modem.Mod(mod)))
    np.testing.assert_array_equal(t_modem.modulate_np(t_modem.Mod(mod), bits),
                                  r_modem.modulate_np(r_modem.Mod(mod), bits))


# (nof_prb, cell id, subframe, mcs, first PRB, number of PRB, rv): one
# codeblock with filler, K- and K+ codeblocks, the PSS/PBCH subframe, a
# retransmission
TX_CASES = [(6, 0, 0, 3, 0, 6, 0), (25, 7, 5, 12, 3, 20, 2), (50, 301, 2, 20, 0, 50, 0),
            (100, 301, 9, 28, 0, 100, 3)]


@pytest.mark.parametrize("nof_prb,cell_id,sf_idx,mcs,s0,l,rv", TX_CASES)
def test_host_transmitter(nof_prb, cell_id, sf_idx, mcs, s0, l, rv):
    ref_cell, cell = cells(nof_prb=nof_prb, id=cell_id, nof_ports=1)
    tbs = r_ra.dl_tbs(mcs, l)
    ref_grant = r_pdsch.DlGrant(prb=tuple(range(s0, s0 + l)), mod=r_ra.dl_mcs_to_mod(mcs),
                                tbs=tbs, rv=rv, rnti=0x46)
    grant = from_reference(ref_grant)
    tb = np.random.default_rng(mcs).integers(0, 2, tbs).astype(np.uint8)
    g = len(r_pdsch.pdsch_re_indices(ref_cell, sf_idx, 1, ref_grant.prb)) * grant.qm
    np.testing.assert_array_equal(
        t_sch.dlsch_encode_np(tb, t_sch.TbCoding(tbs=tbs, g=g, qm=grant.qm, rv=rv)),
        r_sch.dlsch_encode_np(tb, r_sch.TbCoding(tbs=tbs, g=g, qm=grant.qm, rv=rv)))
    ref_grid = r_pdsch.pdsch_encode_np(ref_cell, sf_idx, 1, ref_grant, tb)
    grid = t_pdsch.pdsch_encode_np(cell, sf_idx, 1, grant, tb)
    assert grid.dtype == np.complex64
    np.testing.assert_array_equal(grid, ref_grid)
    np.testing.assert_array_equal(t_rs.put_crs_np(grid, cell, sf_idx),
                                  r_rs.put_crs_np(ref_grid, ref_cell, sf_idx))
    # the IFFT: complex64 on both sides, equal within fp32 FFT rounding
    ref_tx = np.asarray(r_ofdm.ofdm_tx_sf(r_ofdm.OfdmConfig.from_cell(ref_cell, normalize=True),
                                          ref_grid))
    tx = t_ofdm.ofdm_tx_sf(t_ofdm.OfdmConfig.from_cell(cell, normalize=True),
                           torch.from_numpy(grid))
    assert tx.dtype == torch.complex64 and tuple(tx.shape) == ref_tx.shape == (1, cell.sf_len)
    assert np.abs(tx.numpy() - ref_tx).max() <= 1e-5 * np.abs(ref_tx).max()


def test_ofdm_tx_rx_round_trip_with_shift():
    """`ofdm_tx_sf` followed by `ofdm_rx_sf` gives the grid back, also with
    the extended CP and the half-subcarrier shift (undone by the opposite
    shift at the receiver)."""
    rng = np.random.default_rng(0)
    for kw in (dict(nof_prb=6), dict(nof_prb=15, cp=t_common.CP.EXT, freq_shift_f=0.5)):
        cfg = t_ofdm.OfdmConfig(normalize=True, **kw)
        ref_cfg = r_ofdm.OfdmConfig(normalize=True, **dict(kw, cp=r_common.CP(int(kw.get("cp", 0)))))
        shape = (2, 2 * cfg.nsymb_slot, cfg.nof_re)
        grid = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        tx = t_ofdm.ofdm_tx_sf(cfg, torch.from_numpy(grid))
        ref_tx = np.asarray(r_ofdm.ofdm_tx_sf(ref_cfg, grid))
        assert np.abs(tx.numpy() - ref_tx).max() <= 1e-5 * np.abs(ref_tx).max()
        rx_cfg = dataclasses.replace(cfg, freq_shift_f=-cfg.freq_shift_f)
        np.testing.assert_allclose(t_ofdm.ofdm_rx_sf(rx_cfg, tx).numpy(), grid, atol=1e-5)


@pytest.mark.parametrize("m_sc", [12, 60, 300, 1152])
def test_ul_smoothing_matrix_and_time_weights(m_sc):
    """The tables of the UL channel estimate: the 5-tap smoothing matrix over
    an allocation, and the clamped linear time interpolation between the two
    DMRS symbols as the reference builds it inline."""
    import srsran_tpu_torch.phy.chest.chest_ul as t_chest_ul

    np.testing.assert_array_equal(t_chest._smooth_matrix(m_sc, 5), r_chest._smooth_matrix(m_sc, 5))
    for kw in (dict(nof_prb=6), dict(nof_prb=15, cp=1)):
        _ref_cell, cell = cells(**kw)
        l0, l1 = t_chest_ul.dmrs_symbols(cell)
        assert (l0, l1) == ((3, 10) if cell.nsymb_per_slot == 7 else (2, 8))
        t = t_chest_ul.time_interp_weights(cell)
        assert t.shape == (cell.nsymb_per_sf, 2) and t.dtype == np.float32
        np.testing.assert_allclose(t.sum(axis=1), 1.0, atol=1e-7)
        np.testing.assert_array_equal(t[l0], [1, 0])
        np.testing.assert_array_equal(t[l1], [0, 1])
        np.testing.assert_allclose(t[l0 + 1], [1 - 1 / (l1 - l0), 1 / (l1 - l0)], atol=1e-7)


def test_from_reference_takes_every_grant_class():
    """`from_reference` rebuilds the one- and two-codeword DL grants and the
    UL grant field by field; anything else raises."""
    import srsran_tpu.phy.phch.pusch as r_pusch
    import srsran_tpu_torch.phy.phch.pusch as t_pusch

    pairs = [
        (r_pdsch.DlGrant(prb=(1, 2), mod=r_modem.Mod.QAM16, tbs=600, rv=2, rnti=7,
                         tx_scheme="spatialmux", nof_layers=2, pmi=1), t_pdsch.DlGrant),
        (r_pdsch.DlGrant2(prb=(0, 5), mod1=r_modem.Mod.QAM64, tbs1=1000, mod2=r_modem.Mod.QPSK,
                          tbs2=328, rv1=1, rv2=3, pmi=2, rnti=9, tx_scheme="cdd"), t_pdsch.DlGrant2),
        (r_pusch.UlGrant(prb_start=3, nof_prb=12, mod=r_modem.Mod.QAM16, tbs=2000, rv=1, rnti=70),
         t_pusch.UlGrant),
    ]
    for ref, cls in pairs:
        got = from_reference(ref)
        assert type(got) is cls
        for f in dataclasses.fields(ref):
            want = getattr(ref, f.name)
            assert getattr(got, f.name) == (int(want) if isinstance(want, r_modem.Mod) else want)
        hash(got)  # a key for cached tables
    assert from_reference(pairs[1][0]).qm1 == 6 and from_reference(pairs[1][0]).qm2 == 2
    with pytest.raises(TypeError):
        from_reference(object())


# --- the control plane's host tables ----------------------------------------------

REG_CELLS = CELLS + [dict(nof_prb=25, id=7, phich_length=1), dict(nof_prb=100, id=301, phich_resources=3),
                     dict(nof_prb=6, id=5, cp=1, phich_resources=0)]


@pytest.mark.parametrize("kw", REG_CELLS)
def test_reg_interleaver_tables(kw):
    """TS 36.211 §6.8.5 REGs of both CPs and both PHICH durations: the
    master list, the PCFICH, PHICH and PDCCH assignments and the flat RE
    indices of every channel."""
    import srsran_tpu.phy.phch.regs as r_regs
    import srsran_tpu_torch.phy.phch.regs as t_regs

    ref, port = cells(**kw)
    assert t_regs.PDCCH_PERM == r_regs.PDCCH_PERM and t_regs.PDCCH_NCOLS == r_regs.PDCCH_NCOLS
    got, want = t_regs.build_regs(port), r_regs.build_regs(ref)
    assert got == want
    np.testing.assert_array_equal(t_regs.pcfich_re_indices_true(port), r_regs.pcfich_re_indices_true(ref))
    assert t_regs.nof_phich_groups_true(port) == r_regs.nof_phich_groups_true(ref)
    groups = len(want["phich"]) * (1 if ref.nsymb_per_slot == 7 else 2)
    for g in range(groups):
        np.testing.assert_array_equal(t_regs.phich_group_re_indices_true(port, g),
                                      r_regs.phich_group_re_indices_true(ref, g))
    for cfi in (1, 2, 3):
        np.testing.assert_array_equal(t_regs.pdcch_re_indices_true(port, cfi),
                                      r_regs.pdcch_re_indices_true(ref, cfi))


def test_rm_bases_and_riv():
    import srsran_tpu.phy.phch.uci_data as r_uci_data
    import srsran_tpu_torch.phy.phch.uci_data as t_uci_data

    for name in ("RM32_BASIS", "RM20_BASIS"):
        assert getattr(t_uci_data, name) == getattr(r_uci_data, name), name
    for prb in (6, 15, 25, 50, 75, 100):
        for st in range(prb):
            for l in range(1, prb - st + 1):
                riv = t_ra.riv_encode(prb, st, l)
                assert riv == r_ra.riv_encode(prb, st, l)
                assert t_ra.riv_decode(prb, riv) == r_ra.riv_decode(prb, riv) == (st, l)


def test_from_reference_takes_the_control_plane_classes():
    """`DlSched` (with its grants and DCI bits), `Mib`, `PucchConfig` and
    `UciCfg` come over field by field."""
    import srsran_tpu.phy.enb.enb_dl as r_enb_dl
    import srsran_tpu.phy.phch.pbch as r_pbch
    import srsran_tpu.phy.phch.pucch as r_pucch
    import srsran_tpu.phy.phch.pusch as r_pusch
    import srsran_tpu_torch.phy.enb.enb_dl as t_enb_dl

    g = r_pdsch.DlGrant(prb=(1, 2), mod=r_modem.Mod.QAM16, tbs=600, rnti=7)
    tb = np.ones(600, np.uint8)
    sched = r_enb_dl.DlSched(cfi=3, dcis=[(np.array([1, 0, 1], np.uint8), 0x46, 4, 8)],
                             grants=[(g, tb)], phich=[(1, 5, 1)])
    got = from_reference(sched)
    assert type(got) is t_enb_dl.DlSched and got.cfi == 3 and got.phich == [(1, 5, 1)]
    (bits, rnti, agg, cce), = got.dcis
    assert bits.tolist() == [1, 0, 1] and (rnti, agg, cce) == (0x46, 4, 8)
    (g2, tb2), = got.grants
    assert type(g2) is t_pdsch.DlGrant and g2.tbs == 600 and tb2 is tb
    for ref in (r_pbch.Mib(nof_prb=50, phich_length=1, phich_resources=2, sfn=513),
                r_pucch.PucchConfig(n_pucch=17, delta_shift=3),
                r_pusch.UciCfg(cqi_bits=(1, 0), ack=(1,), ri=(0,), i_offset_cqi=9)):
        got = from_reference(ref)
        assert type(got).__name__ == type(ref).__name__ and type(got) is not type(ref)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_cell_slot_len_and_srate():
    for kw in CELLS + [dict(nof_prb=25, id=1, use_standard_rates=False)]:
        ref, cell = cells(**kw)
        assert (cell.sf_len, cell.slot_len, cell.srate) == (ref.sf_len, ref.slot_len, ref.srate)


def test_pss_replicas_and_sss_hypotheses():
    """`pss_time_np` at every FFT size of the numerology and the (2, 168, 62)
    SSS hypothesis matrix of every N_id_2, bit for bit."""
    for sz in (128, 256, 384, 512, 768, 1024, 1536, 2048):
        for n_id_2 in range(3):
            got = t_pss.pss_time_np(n_id_2, sz)
            assert got.dtype == np.complex64
            np.testing.assert_array_equal(got, r_pss.pss_time_np(n_id_2, sz))
    for n_id_2 in range(3):
        got = t_sss.sss_hypothesis_matrix(n_id_2)
        assert got.dtype == np.float32 and got.shape == (2, 168, 62)
        np.testing.assert_array_equal(got, r_sss.sss_hypothesis_matrix(n_id_2))


def test_mac_pdu_tables_and_pcap_header(tmp_path):
    """`mac_pdu`'s LCID and CE tables, and `MacPcap`'s global header and
    per-packet context, byte for byte."""
    import srsran_tpu.runtime.pcap as r_pcap
    import srsran_tpu.stack.mac_pdu as r_mac
    import srsran_tpu_torch.runtime.pcap as t_pcap
    import srsran_tpu_torch.stack.mac_pdu as t_mac

    for name in ("LCID_PADDING", "LCID_DTCH", "LCID_SCELL_ACT", "DL_CE_SIZES", "UL_CE_SIZES"):
        assert getattr(t_mac, name) == getattr(r_mac, name), name
    for name in ("MAC_LTE_DLT", "FDD_RADIO", "DIRECTION_UPLINK", "DIRECTION_DOWNLINK", "NO_RNTI",
                 "P_RNTI", "RA_RNTI", "C_RNTI", "SI_RNTI"):
        assert getattr(t_pcap, name) == getattr(r_pcap, name), name
    files = []
    for mod in (t_pcap, r_pcap):
        path = tmp_path / f"{mod.__name__}.pcap"
        with mod.MacPcap(str(path), ue_id=3) as pcap:
            pcap.write_pdu(b"\x01\x02\x03", 0x46, sfn=17, sf_idx=4, crc_ok=False, cc_idx=1)
        files.append(path.read_bytes())
    assert files[0][:24] == files[1][:24]
    # a packet: 16 bytes of record header (its time differs), then context and PDU
    assert files[0][24 + 8 : 24 + 16] == files[1][24 + 8 : 24 + 16]
    assert files[0][24 + 16 :] == files[1][24 + 16 :]


def test_from_reference_takes_agc():
    from srsran_tpu.phy.agc import Agc as RAgc
    from srsran_tpu_torch.phy.agc import Agc as TAgc

    ref = RAgc(target=0.2, max_gain_db=60.0, gain_db=12.5, state="HOLD", hold_cnt=3)
    got = from_reference(ref)
    assert type(got) is TAgc and dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_prach_tables_and_config():
    """The PRACH tables (TS 36.211 Tables 5.7.2-2/-3/-4), the root spectra,
    the preamble roots and shifts of every N_cs configuration and the bin
    map of each cell width."""
    import srsran_tpu.phy.phch.prach as r_prach
    import srsran_tpu.phy.phch.prach_data as r_pd
    import srsran_tpu_torch.phy.phch.prach as t_prach
    import srsran_tpu_torch.phy.phch.prach_data as t_pd

    for name in ("NCS_UNRESTRICTED", "NCS_RESTRICTED", "NCS_FORMAT4", "ZC_ROOT_ORDER"):
        assert getattr(t_pd, name) == getattr(r_pd, name), name
    for u in (1, 129, 419, 838):
        np.testing.assert_array_equal(t_prach.zc_freq_np(u), r_prach.zc_freq_np(u))
    for zcz in range(1, 16):
        ref = r_prach.PrachConfig(root_seq_index=3 * zcz, zero_corr_zone=zcz, freq_offset=zcz)
        cfg = from_reference(ref)
        assert isinstance(cfg, t_prach.PrachConfig) and cfg.n_cs == ref.n_cs
        assert t_prach._roots_and_shifts(cfg) == r_prach._roots_and_shifts(ref)
        for kw in CELLS[:3]:
            ref_cell, cell = cells(**kw)
            if zcz + 6 <= cell.nof_prb:
                np.testing.assert_array_equal(t_prach._freq_map(cell, cfg),
                                              r_prach._freq_map(ref_cell, ref))


def test_tdd_tables_and_harq_timing():
    """`phy/tdd.py`: every table, and the timing functions over every
    UL/DL and special-subframe configuration (and FDD, cfg None)."""
    for name in ("NOF_SF_X_FRAME", "MAX_TDD_SF_CONFIGS", "MAX_TDD_SS_CONFIGS",
                 "FDD_HARQ_DELAY_UL_MS", "FDD_HARQ_DELAY_DL_MS", "FDD_NOF_HARQ", "SF_TYPE_TABLE",
                 "SS_SYMBOLS_TABLE", "NOF_HARQ_TABLE", "MI_TABLE", "K_PUSCH", "K_PHICH"):
        got, ref = getattr(t_tdd, name), getattr(r_tdd, name)
        assert np.array_equal(np.asarray(got, dtype=np.int64), np.asarray(ref, dtype=np.int64)), name
    for cfgs in ((None, None),) + tuple(
            (t_tdd.TddConfig(sf, ss), r_tdd.TddConfig(sf, ss))
            for sf in range(7) for ss in range(10)):
        tc, rc = cfgs
        for sf_idx in range(10):
            assert int(t_tdd.sf_type(tc, sf_idx)) == int(r_tdd.sf_type(rc, sf_idx))
            assert t_tdd.mi_value(tc, sf_idx) == r_tdd.mi_value(rc, sf_idx)
        assert t_tdd.nof_harq(tc) == r_tdd.nof_harq(rc)
        for tti in range(20):
            for fn in ("ack_tti", "pusch_tti", "phich_tti", "ul_pid"):
                try:
                    want = getattr(r_tdd, fn)(rc, tti)
                except (ValueError, KeyError, IndexError) as e:
                    with pytest.raises(type(e)):
                        getattr(t_tdd, fn)(tc, tti)
                    continue
                assert getattr(t_tdd, fn)(tc, tti) == want, (fn, tti)
        if tc is None:
            continue
        assert (t_tdd.nof_dw(tc), t_tdd.nof_gp(tc), t_tdd.nof_up(tc)) == (
            r_tdd.nof_dw(rc), r_tdd.nof_gp(rc), r_tdd.nof_up(rc))
        for slot in range(2):
            assert t_tdd.nof_dw_slot(tc, slot) == r_tdd.nof_dw_slot(rc, slot)
        for sf_idx in range(10):
            assert t_tdd.das_set(tc, sf_idx) == r_tdd.das_set(rc, sf_idx)
        np.testing.assert_array_equal(t_tdd.ul_sf_mask(tc), r_tdd.ul_sf_mask(rc))
        np.testing.assert_array_equal(t_tdd.dl_sf_mask(tc), r_tdd.dl_sf_mask(rc))
        np.testing.assert_array_equal(t_tdd.dl_sf_mask(tc, False), r_tdd.dl_sf_mask(rc, False))
