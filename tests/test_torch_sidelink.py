"""Sidelink on the port (`srsran_tpu_torch/phy/sync/sidelink.py`,
`phy/phch/{psbch,pscch,pssch}.py` and `examples/pssch_ue.py`) against the
JAX reference, on the CPU.

The twenty cases of `tests/test_sidelink.py` on the port.  The synthetic
cases run the reference beside the port on the same numpy inputs made from a
seed; each stored capture runs once, on the port, held to the reference
test's own expected values (the reference's decode of it is what those
values are).  Tolerances:
- PSSS root and offset, SSSS id, MIB-SL, SCI fields, N_x_id, TB bits and
  CRC verdicts: identical;
- the PSSS metric: rtol 1e-4 (FFT correlation in another library);
- host sequences and DMRS: identical (`tests/test_torch_host_tables.py`
  too); the SC-FDMA encoders: atol 1e-5 (the DFT precoding is a complex64
  matrix product in another library).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.phch.psbch as r_psbch
import srsran_tpu.phy.phch.pscch as r_pscch
import srsran_tpu.phy.phch.pssch as r_pssch
import srsran_tpu.phy.sync.sidelink as r_sl
from srsran_tpu.phy.ofdm import OfdmConfig as ROfdmConfig, ofdm_tx_sf as r_ofdm_tx_sf
from srsran_tpu_torch.phy.common import CP, Cell
from srsran_tpu_torch.phy.dft_precoding import valid_nof_prb
from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_rx_sf
from srsran_tpu_torch.phy.phch.psbch import MibSl, psbch_decode, psbch_decode_tm34, put_psbch_np
from srsran_tpu_torch.phy.phch.pscch import (
    Sci0, pscch_decode, pscch_decode_tm34, pscch_search_tm34, put_pscch_np)
from srsran_tpu_torch.phy.phch.pssch import (
    pssch_decode, pssch_decode_tm34, pssch_dmrs_np, put_pssch_np)
from srsran_tpu_torch.phy.phch.ra import riv_decode, tbs_lookup, ul_mcs_to_itbs
from srsran_tpu_torch.phy.sync.sidelink import (
    psss_find, psss_seq_np, put_sl_sync_grid, ssss_detect)

torch.set_num_threads(1)

VEC = os.path.join(os.path.dirname(__file__), "vectors")
CPU = "cpu"


def capture(name):
    return torch.from_numpy(np.fromfile(os.path.join(VEC, name), np.complex64))


def rx_grids(x, cell, n_sf, start=0):
    """The -0.5-subcarrier SC-FDMA grids of n_sf subframes from `start`."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    return ofdm_rx_sf(ofdm, x[start : start + n_sf * cell.sf_len].reshape(n_sf, cell.sf_len))


def cnoise(rng, shape, scale):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64) * scale


def ssss_equalized(grid, cell, root):
    k0 = cell.nof_re_per_symbol // 2 - 31
    ce = grid[1, k0 : k0 + 62] * torch.from_numpy(np.conj(psss_seq_np(root)))
    return grid[cell.nsymb_per_slot + 4, k0 : k0 + 62] * torch.conj(ce) / (torch.abs(ce) ** 2 + 1e-3)


def test_psss_roots_distinct():
    a, b = psss_seq_np(0), psss_seq_np(1)
    assert np.abs(np.vdot(a, b)) / 62 < 0.2
    np.testing.assert_allclose(np.abs(a), 1.0, atol=1e-5)
    for r in (0, 1):
        np.testing.assert_array_equal(psss_seq_np(r), r_sl.psss_seq_np(r))


def test_sl_sync_selfconsistent():
    """put → OFDM → find/detect roundtrip for a high N_sl_id (root 37),
    beside the reference's psss_find and ssss_detect."""
    cell = Cell(nof_prb=6, nof_ports=1, id=0)
    n_sl_id = 301
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    put_sl_sync_grid(grid, cell, n_sl_id)
    ref_cfg = ROfdmConfig(nof_prb=6, normalize=True, freq_shift_f=0.5)
    tx = np.asarray(r_ofdm_tx_sf(ref_cfg, grid))
    rx = tx + cnoise(np.random.default_rng(0), len(tx), 0.01)
    root, off, metric = psss_find(rx, 6, device=CPU)
    assert root == 1 and metric > 8
    root_r, off_r, metric_r = r_sl.psss_find(rx, 6)
    assert (root, off) == (root_r, off_r)
    np.testing.assert_allclose(metric, metric_r, rtol=1e-4)
    sf_start = off - OfdmConfig.from_cell(cell).symbol_starts()[1]
    assert abs(sf_start) <= 2
    g = rx_grids(torch.from_numpy(rx), cell, 1, max(sf_start, 0))[0]
    nid, conf = ssss_detect(ssss_equalized(g, cell, root))
    assert int(nid) == n_sl_id
    nid_r, conf_r = r_sl.ssss_detect(jnp.asarray(ssss_equalized(g, cell, root).numpy()))
    assert int(nid_r) == n_sl_id
    np.testing.assert_allclose(float(conf), float(conf_r), atol=1e-5)


def test_sidelink_golden_capture():
    """The ideal TM2 capture (6 PRB, SLSS id 0): PSSS root 0 found at the
    exact subframe start; SSSS resolves N_sl_id = 0 over all 336."""
    x = capture("signal_sidelink_ideal_tm2_p6_c0_s1.92e6.dat")
    cell = Cell(nof_prb=6, nof_ports=1, id=0)
    root, off, metric = psss_find(x, 6, device=CPU)
    assert root == 0 and metric > 8
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    assert off - ofdm.symbol_starts()[1] == 0
    nid, _ = ssss_detect(ssss_equalized(rx_grids(x, cell, 1)[0], cell, root))
    assert int(nid) == 0


def test_sidelink_golden_capture_25prb():
    """The 25-PRB ideal TM2 capture (SLSS id 168 → PSSS root 1)."""
    x = capture("signal_sidelink_ideal_tm2_p25_c168_s7.68e6.dat")
    cell = Cell(nof_prb=25, nof_ports=1, id=0)
    root, off, metric = psss_find(x, 25, device=CPU)
    assert root == 1 and metric > 10
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    sf_start = max(off - ofdm.symbol_starts()[1], 0)
    nid, _ = ssss_detect(ssss_equalized(rx_grids(x, cell, 1, sf_start)[0], cell, root))
    assert int(nid) == 168


def test_psbch_selfconsistent():
    cell = Cell(nof_prb=6, nof_ports=1, id=0)
    mib = MibSl(sl_bandwidth=0, direct_frame_number=123, direct_subframe_number=5, in_coverage=True)
    rng = np.random.default_rng(0)
    for nid in (0, 1, 255):
        grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
        put_psbch_np(grid, cell, mib, nid)
        ref = np.zeros_like(grid)
        r_psbch.put_psbch_np(ref, cell, r_psbch.MibSl(**vars(mib)), nid)
        np.testing.assert_allclose(grid, ref, atol=1e-5)
        rx = grid * np.complex64(0.8 * np.exp(0.3j)) + cnoise(rng, grid.shape, 0.02)
        mib_hat, ok = psbch_decode(torch.from_numpy(rx), cell, nid)
        assert ok and mib_hat == mib
        mib_r, ok_r = r_psbch.psbch_decode(rx, cell, nid)
        assert ok_r and vars(mib_r) == vars(mib_hat)
    empty = torch.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), dtype=torch.complex64)
    assert not psbch_decode(empty, cell, 0)[1]


def test_psbch_golden_captures():
    """MIB-SL decodes from every ideal TM2 capture with the bandwidth field
    matching the capture's PRB count."""
    for fn, prb, nid, bw in (
        ("signal_sidelink_ideal_tm2_p6_c0_s1.92e6.dat", 6, 0, 0),
        ("signal_sidelink_ideal_tm2_p15_c84_s3.84e6.dat", 15, 84, 1),
        ("signal_sidelink_ideal_tm2_p25_c168_s7.68e6.dat", 25, 168, 2),
        ("signal_sidelink_ideal_tm2_p50_c252_s15.36e6.dat", 50, 252, 3),
        ("signal_sidelink_ideal_tm2_p100_c335_s30.72e6.dat", 100, 335, 5),
    ):
        cell = Cell(nof_prb=prb, nof_ports=1, id=0)
        mib, ok = psbch_decode(rx_grids(capture(fn), cell, 1)[0], cell, nid)
        assert ok, fn
        assert mib.sl_bandwidth == bw and mib.in_coverage


def test_pscch_selfconsistent():
    cell = Cell(nof_prb=50, nof_ports=1, id=0)
    sci = Sci0(riv=1001, trp_idx=10, mcs_idx=12, n_sa_id=99)
    rng = np.random.default_rng(0)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    put_pscch_np(grid, cell, sci, prb_idx=7)
    rx = grid * np.complex64(0.9 * np.exp(-0.2j)) + cnoise(rng, grid.shape, 0.01)
    s_hat, ok = pscch_decode(torch.from_numpy(rx), cell, 7)
    assert ok and s_hat == sci
    s_r, ok_r = r_pscch.pscch_decode(rx, cell, 7)
    assert ok_r and vars(s_r) == vars(s_hat)
    assert not pscch_decode(torch.from_numpy(rx), cell, 8)[1]
    assert not r_pscch.pscch_decode(rx, cell, 8)[1]


def test_pscch_golden_capture():
    """SCI format 0 from the 100-PRB ideal TM2 capture."""
    cell = Cell(nof_prb=100, nof_ports=1, id=0)
    grid = rx_grids(capture("signal_sidelink_ideal_tm2_p100_c335_s30.72e6.dat"), cell, 1, cell.sf_len)[0]
    sci, ok = pscch_decode(grid, cell, prb_idx=0)
    assert ok and sci.trp_idx == 56 and sci.n_sa_id == 255 and not sci.freq_hopping


def test_pssch_selfconsistent():
    cell = Cell(nof_prb=50, nof_ports=1, id=0)
    rng = np.random.default_rng(0)
    tbs = tbs_lookup(ul_mcs_to_itbs(5), 4)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    put_pssch_np(grid, cell, tb, n_x_id=255, mcs_idx=5, prb_start=10, nof_prb=4, sf_idx=3)
    rx = grid * np.complex64(0.9 * np.exp(0.1j)) + cnoise(rng, grid.shape, 0.01)
    tb_hat, ok = pssch_decode(torch.from_numpy(rx), cell, 255, 5, 10, 4, 3)
    assert ok
    np.testing.assert_array_equal(tb_hat.numpy(), tb)
    tb_r, ok_r = r_pssch.pssch_decode(rx, cell, 255, 5, 10, 4, 3)
    assert ok_r and np.array_equal(tb_r, tb)
    np.testing.assert_array_equal(pssch_dmrs_np(255, 4), r_pssch.pssch_dmrs_np(255, 4))


def test_sidelink_full_chain_golden():
    """The TM2 receive chain on the 100-PRB capture: SCI-0 from subframe 1
    drives the PSSCH decode of subframe 3, whose TB reads c8e4."""
    cell = Cell(nof_prb=100, nof_ports=1, id=0)
    grids = rx_grids(capture("signal_sidelink_ideal_tm2_p100_c335_s30.72e6.dat"), cell, 4)
    sci, ok = pscch_decode(grids[1], cell, prb_idx=0)
    assert ok
    rb0, l_crb = riv_decode(100, sci.riv)
    tb, ok = pssch_decode(grids[3], cell, sci.n_sa_id, sci.mcs_idx, rb0, l_crb, sf_idx=0, rv=0)
    assert ok
    assert np.packbits(tb.numpy()).tobytes() == bytes.fromhex("c8e4")


def test_psbch_tm4_cmw500_golden():
    """The CMW500 capture (50 PRB V2X, SLSS id 169, 11.52 Msps): PSSS root 1
    and the TM4 MIB-SL-V2X with sl-Bandwidth = n50."""
    x = capture("signal_sidelink_cmw500_f5.92e9_s11.52e6_50prb_slss_id169.dat")
    cell = Cell(nof_prb=50, nof_ports=1, id=0, use_standard_rates=False)
    root, off, _metric = psss_find(x, 50, standard_rates=False, device=CPU)
    assert root == 1
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    st = max(off - ofdm.symbol_starts()[1], 0)
    bits, ok = psbch_decode_tm34(rx_grids(x, cell, 1, st)[0], cell, 169)
    assert ok and int("".join(map(str, bits[:3])), 2) == 3


def sci_hits(grid, cell, starts, nsub):
    """`pscch_search_tm34` against per-hypothesis `pscch_decode_tm34`: the
    same hits."""
    hits = pscch_search_tm34(grid, cell, starts, nsub)
    single = [(p, cs) for p in starts for cs in (0, 3, 6, 9)
              if pscch_decode_tm34(grid, cell, p, cs, nsub)[2]]
    assert [(p, cs) for p, cs, _s, _c in hits] == single
    return hits


def test_tm4_uxm_tester_full_chain():
    """The Keysight UXM capture (V2X TM4, 50 PRB, 10 subchannels of 5): SCI
    format 1 in both subframes (mcs 12), N_x_id 23387, and two 1608-bit
    PSSCH TBs."""
    cell = Cell(nof_prb=50, nof_ports=1, id=0)
    grids = rx_grids(capture("signal_sidelink_uxm_s15.36e6_50prb_0prb_offset_mcs12.dat"), cell, 2)
    n_tb = 0
    for sf in range(2):
        hits = sci_hits(grids[sf], cell, [s * 5 for s in range(10)], 10)
        assert hits
        p, _cs, sci, crc = hits[-1]
        sub = p // 5
        assert sci.mcs_idx == 12
        n_x_id = int("".join(map(str, crc)), 2)
        assert n_x_id == 23387
        l_subch = riv_decode(10, sci.riv)[1]
        prb_start = sub * 5 + 2
        tb, ok = pssch_decode_tm34(grids[sf], cell, n_x_id, sci.mcs_idx, prb_start,
                                   (l_subch + sub) * 5 - prb_start, sf_idx=sf, rv=0)
        assert ok and len(tb) == 1608
        n_tb += 1
    assert n_tb == 2


def test_tm4_qualcomm_chipset_sci():
    """The Qualcomm 9150 capture: one SCI-1 at subchannel 2, priority 2,
    mcs 6, retransmission signalled."""
    cell = Cell(nof_prb=50, nof_ports=1, id=0)
    grid = rx_grids(capture("signal_sidelink_qc9150_f5.92e9_s15.36e6_50prb_20offset.dat"), cell, 1)[0]
    hits = sci_hits(grid, cell, [s * 10 for s in range(5)], 5)
    assert len(hits) == 1
    p, _cs, sci, _crc = hits[0]
    assert p // 10 == 2 and sci.priority == 2 and sci.mcs_idx == 6 and sci.retransmission


def test_tm4_huawei_tester_sci_with_retx():
    """The Huawei capture (11.52 Msps): SCI-1s at subchannel 1 in subframes 0
    and 3, the retransmission flag flipping, time_gap 3."""
    cell = Cell(nof_prb=50, nof_ports=1, id=0, use_standard_rates=False)
    grids = rx_grids(capture("signal_sidelink_huawei_s11.52e6_50prb_10prb_offset_with_retx.dat"), cell, 4)
    found = {}
    for sf in range(4):
        for p, _cs, sci, _crc in sci_hits(grids[sf], cell, [s * 10 for s in range(5)], 5):
            found[sf] = (p // 10, sci)
    assert set(found) == {0, 3}
    (sub0, sci0), (sub3, sci3) = found[0], found[3]
    assert sub0 == sub3 == 1
    assert not sci0.retransmission and sci3.retransmission
    assert sci0.time_gap == sci3.time_gap == 3
    assert (sci0.riv, sci0.mcs_idx) == (sci3.riv, sci3.mcs_idx)


def test_tm4_uxm_100prb_four_subframes():
    """The 100-PRB UXM capture (23.04 Msps): SCI-1 in all four subframes
    (riv 40, N_x_id 28300) and four CRC-ok 9528-bit two-codeblock TBs."""
    cell = Cell(nof_prb=100, nof_ports=1, id=0, use_standard_rates=False)
    assert cell.symbol_sz == 1536
    grids = rx_grids(capture("signal_sidelink_uxm_s23.04e6_100prb_1prb_offset_mcs12_padding.dat"), cell, 4)
    n_sci = n_tb = 0
    for sf in range(4):
        hits = pscch_search_tm34(grids[sf], cell, [0], 10)
        assert hits
        _p, _cs, sci, crc = hits[-1]
        n_x_id = int("".join(map(str, crc)), 2)
        assert sci.mcs_idx == 12 and sci.riv == 40 and n_x_id == 28300
        n_sci += 1
        tb, ok = pssch_decode_tm34(grids[sf], cell, n_x_id, 12, 2, 48, sf_idx=sf, rv=0)
        assert ok and len(tb) == 9528
        n_tb += 1
    assert n_sci == 4 and n_tb == 4


def test_tm4_uxm_its_capture():
    """The 100-PRB UXM ITS capture at 30.72 Msps: SCI-1 and a 9528-bit TB
    with sf_idx = 6."""
    cell = Cell(nof_prb=100, nof_ports=1, id=0)
    grid = rx_grids(capture("signal_sidelink_uxm_s30.72e6_100prb_1prb_offset_mcs12_its.dat"), cell, 1)[0]
    hits = pscch_search_tm34(grid, cell, [0], 10)
    assert hits
    _p, _cs, sci, crc = hits[-1]
    assert sci.mcs_idx == 12
    tb, ok = pssch_decode_tm34(grid, cell, int("".join(map(str, crc)), 2), 12, 2, 48, sf_idx=6, rv=0)
    assert ok and len(tb) == 9528


def test_psbch_extended_cp_golden():
    """The extended-CP TM2 vector: the tm12_ext map decodes sl-Bandwidth n50."""
    cell = Cell(nof_prb=50, nof_ports=1, id=0, cp=CP.EXT)
    grid = rx_grids(capture("signal_sidelink_ideal_tm2_p50_c252_s15.36e6_ext.dat"), cell, 1)[0]
    mib, ok = psbch_decode(grid, cell, 252)
    assert ok and mib.sl_bandwidth == 3


def test_tm4_cmw500_1ms_sci():
    """The CMW500 1 ms V2X capture after the 20-sample offset: one SCI-1 at
    subchannel 0, mcs 5."""
    cell = Cell(nof_prb=50, nof_ports=1, id=0, use_standard_rates=False)
    x = capture("signal_sidelink_cmw500_f5.92e9_s11.52e6_50prb_0offset_1ms.dat")
    x = torch.nn.functional.pad(x[20:], (0, 20))
    hits = sci_hits(rx_grids(x, cell, 1)[0], cell, [s * 10 for s in range(5)], 5)
    assert len(hits) == 1
    p, _cs, sci, _crc = hits[0]
    assert p == 0 and sci.mcs_idx == 5


def test_tm4_uxm_mcs28_five_subframes():
    """The UXM mcs-28 capture: SCI-1 with mcs 28 in all five subframes, each
    a CRC-ok 14688-bit 64QAM TB on the DFT-valid 20-PRB allocation at rv 2."""
    cell = Cell(nof_prb=50, nof_ports=1, id=0)
    grids = rx_grids(capture("signal_sidelink_uxm_s15.36e6_50prb_0prb_offset_mcs28_padding_5ms.dat"), cell, 5)
    n_tb = 0
    for f in range(5):
        hits = pscch_search_tm34(grids[f], cell, [0], 10)
        assert hits
        _p, _cs, sci, crc = hits[-1]
        assert sci.mcs_idx == 28
        n_x_id = int("".join(map(str, crc)), 2)
        _start, l_subch = riv_decode(10, sci.riv)
        nof_prb = l_subch * 5 - 2
        while not valid_nof_prb(nof_prb):
            nof_prb -= 1
        assert nof_prb == 20
        tb, ok = pssch_decode_tm34(grids[f], cell, n_x_id, 28, 2, nof_prb, sf_idx=f + 1, rv=2)
        assert ok and len(tb) == 14688
        n_tb += 1
    assert n_tb == 5


def test_tm4_ideal_p100_sci():
    """The ideal TM4 100-PRB vector: SCI-1 in the occupied subframe, mcs 4,
    a full 10-subchannel allocation."""
    cell = Cell(nof_prb=100, nof_ports=1, id=0)
    x = capture("signal_sidelink_ideal_tm4_p100_c335_size10_num10_cshift0_s30.72e6.dat")
    grids = rx_grids(x, cell, x.shape[0] // cell.sf_len)
    hits = [(f, p, sci) for f in range(grids.shape[0])
            for p, _cs, sci, _crc in pscch_search_tm34(grids[f], cell, [s * 10 for s in range(10)], 10)]
    assert len(hits) >= 1
    _f, p, sci = hits[0]
    assert p == 0 and sci.mcs_idx == 4
    assert riv_decode(10, sci.riv) == (0, 10)


@pytest.mark.parametrize("args,want", [
    (["signal_sidelink_uxm_s15.36e6_50prb_0prb_offset_mcs12.dat", "-p", "50"], (2, 2)),
    (["signal_sidelink_cmw500_f5.92e9_s11.52e6_50prb_slss_id169.dat", "-p", "50",
      "--nonstandard-rates"], (0, 0)),
])
def test_pssch_ue_example(args, want, capsys):
    """`examples/pssch_ue.py` on the port, on two captures: the SCIs and TBs
    the reference script finds (the CMW500 sync capture: the MIB-SL of id
    169 and no SCI, exit 1 as there)."""
    import json

    from srsran_tpu_torch.examples import pssch_ue

    rc = pssch_ue.main(["-i", os.path.join(VEC, args[0])] + args[1:] + ["--device", CPU])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (res["scis"], res["tbs"]) == want and rc == (0 if want[0] else 1)
