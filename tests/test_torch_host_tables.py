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
import srsran_tpu.phy.fec.turbo as r_turbo
import srsran_tpu.phy.phch.pdsch as r_pdsch
import srsran_tpu.phy.sequence as r_seq
import srsran_tpu_torch.phy.chest.chest_dl as t_chest
import srsran_tpu_torch.phy.chest.refsignal_dl as t_rs
import srsran_tpu_torch.phy.common as t_common
import srsran_tpu_torch.phy.crc as t_crc
import srsran_tpu_torch.phy.fec.cbsegm as t_cbsegm
import srsran_tpu_torch.phy.fec.rate_match as t_rm
import srsran_tpu_torch.phy.fec.turbo as t_turbo
import srsran_tpu_torch.phy.phch.pdsch as t_pdsch
import srsran_tpu_torch.phy.sequence as t_seq
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
    for name in ("NRE", "MAX_PRB", "CP_NORM_0_LEN", "CP_NORM_LEN", "CP_EXT_LEN",
                 "LTE_CRC24A", "LTE_CRC24B", "LTE_CRC16", "LTE_CRC8"):
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
    for prop in ("symbol_sz", "nsymb_per_slot", "nsymb_per_sf", "nof_re_per_symbol", "sf_len"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert int(port.cp) == int(ref.cp) and port.cp.nsymb == ref.cp.nsymb


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
