"""NB-IoT on the port (`srsran_tpu_torch/phy/sync/nbiot.py`,
`phy/phch/{npbch,npdsch,nprach}.py`, `phy/ue/{ue_sync_nbiot,ue_nbiot}.py` and
the two example scripts) against the JAX reference, on the CPU.

The eleven cases of `tests/test_nbiot.py` on the port, each beside the
reference on the same numpy inputs made from a seed.  Tolerances:
- detected ids, frame positions, subframe indices, block indices, DCIs,
  MIBs, hard bits and CRC verdicts: identical;
- correlation metrics and confidences: atol 1e-5 (float32 sums in another
  order on O(1) values); NRS estimates and noise: atol 1e-6;
- NPRACH metrics: rtol 1e-5 (ratios of float32 energies);
- the raw acquisition's CFO: within 1e-4 subcarrier of the reference's
  (both estimate from the same products in float32 and float64), its
  timing and PSR identical and within 1e-4 relative;
- the 128-point demodulator: atol 1e-5 on unit-power bins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.phch.npbch as r_npbch
import srsran_tpu.phy.phch.npdsch as r_npdsch
import srsran_tpu.phy.phch.nprach as r_nprach
import srsran_tpu.phy.sync.nbiot as r_nbiot
import srsran_tpu.phy.ue.ue_nbiot as r_ue
import srsran_tpu.phy.ue.ue_sync_nbiot as r_sync
import srsran_tpu_torch.phy.phch.npbch as t_npbch
import srsran_tpu_torch.phy.phch.npdsch as t_npdsch
import srsran_tpu_torch.phy.phch.nprach as t_nprach
import srsran_tpu_torch.phy.sync.nbiot as t_nbiot
import srsran_tpu_torch.phy.ue.ue_nbiot as t_ue
import srsran_tpu_torch.phy.ue.ue_sync_nbiot as t_sync

torch.set_num_threads(1)

METRIC_ATOL = 1e-5
CPU = "cpu"


def t(x):
    return torch.from_numpy(np.array(x, np.complex64))


def cnoise(rng, shape, scale):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64) * scale


def r_mib(mib):
    return r_npbch.MibNb(**vars(mib)) if not isinstance(mib, r_npbch.MibNb) else mib


def same_mib(a, b):
    return vars(a) == vars(b)


def test_npss_detects_correct_subframe():
    rng = np.random.default_rng(0)
    sfs = cnoise(rng, (10, 14, 12), 0.3)
    t_nbiot.put_npss_grid(sfs[5])
    metric, best = t_nbiot.npss_correlate(t(sfs))
    m = metric.numpy()
    assert int(best) == 5
    assert m[5] > 3 * np.max(np.delete(m, 5))
    m_ref, best_ref = r_nbiot.npss_correlate(sfs)
    assert int(best_ref) == 5
    np.testing.assert_allclose(m, np.asarray(m_ref), atol=METRIC_ATOL)


def test_nsss_sequences_distinct():
    a = t_nbiot.nsss_sequence_np(0, 0)
    b = t_nbiot.nsss_sequence_np(1, 0)
    c = t_nbiot.nsss_sequence_np(0, 1)
    assert np.abs(np.vdot(a, b)) / 132 < 0.3
    assert np.abs(np.vdot(a, c)) / 132 < 0.3
    np.testing.assert_allclose(np.abs(a), 1.0, atol=1e-5)
    for nid, f4 in ((0, 0), (1, 0), (0, 1), (503, 3)):
        np.testing.assert_array_equal(t_nbiot.nsss_sequence_np(nid, f4), r_nbiot.nsss_sequence_np(nid, f4))


def test_nsss_detection_all_hypotheses():
    rng = np.random.default_rng(1)
    for nid, f4 in ((0, 0), (257, 2), (503, 3), (126, 1)):
        grid = np.zeros((14, 12), np.complex64)
        t_nbiot.put_nsss_grid(grid, nid, f4)
        rx = grid * np.complex64(0.8 * np.exp(0.7j)) + cnoise(rng, grid.shape, 0.05)
        nid_hat, f4_hat, conf = t_nbiot.nsss_detect(t(rx))
        assert int(nid_hat) == nid and int(f4_hat) == f4 and float(conf) > 0.5
        nid_r, f4_r, conf_r = r_nbiot.nsss_detect(jnp.asarray(rx))
        assert (int(nid_r), int(f4_r)) == (nid, f4)
        np.testing.assert_allclose(float(conf), float(conf_r), atol=METRIC_ATOL)


def test_nrs_roundtrip_chest():
    rng = np.random.default_rng(2)
    grid = np.zeros((14, 12), np.complex64)
    t_npbch.put_nrs_np(grid, n_id_ncell=257, sf_idx=0)
    h_true = np.complex64(0.7 + 0.5j)
    rx = grid * h_true + cnoise(rng, grid.shape, 0.02)
    h, noise = t_npbch.nrs_chest(t(rx), 257, 0)
    assert abs(complex(h) - h_true) < 0.05 and float(noise) < 0.01
    h_r, noise_r = r_npbch.nrs_chest(jnp.asarray(rx), 257, 0)
    assert abs(complex(h) - complex(h_r)) < 1e-6
    np.testing.assert_allclose(float(noise), float(noise_r), atol=1e-6)


def equalize(rx, ncell, idx, sf=0):
    """The reference test's NRS equalisation (host arithmetic)."""
    h, noise = r_npbch.nrs_chest(jnp.asarray(rx), ncell, sf)
    hc = complex(np.asarray(h))
    return (rx.reshape(-1)[idx] * np.conj(hc) / (abs(hc) ** 2 + float(np.asarray(noise)))).astype(np.complex64)


def test_npbch_mib_nb_roundtrip():
    """MIB-NB through NPBCH with blind block detection and NRS-based
    equalization; the port's `nrs_equalize` against the reference test's."""
    rng = np.random.default_rng(3)
    ncell = 123
    mib = t_npbch.MibNb(sfn_msb=9, sib1_sched=3, sys_info_tag=17, op_mode=3)
    blocks = t_npbch.npbch_encode_np(mib, ncell)
    np.testing.assert_array_equal(blocks, r_npbch.npbch_encode_np(r_mib(mib), ncell))
    idx = t_npbch.npbch_re_indices(ncell)
    for blk in (0, 5, 7):
        grid = np.zeros((14, 12), np.complex64)
        grid.reshape(-1)[idx] = blocks[blk]
        t_npbch.put_nrs_np(grid, ncell, 0)
        rx = grid * np.complex64(0.9 * np.exp(-0.4j)) + cnoise(rng, grid.shape, 0.03)
        eq = equalize(rx, ncell, idx)
        got = t_npbch.nrs_equalize(t(rx), ncell, 0, torch.from_numpy(idx.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), eq, atol=1e-5)
        mib_hat, blk_hat, ok = t_npbch.npbch_decode(got, ncell)
        assert ok and blk_hat == blk and mib_hat == mib
        mib_r, blk_r, ok_r = r_npbch.npbch_decode(eq, ncell)
        assert ok_r and blk_r == blk and same_mib(mib_r, mib_hat)


def frame_with_cell(ncell, mib, f4=0):
    frames = np.zeros((10, 14, 12), np.complex64)
    frames[0].reshape(-1)[t_npbch.npbch_re_indices(ncell)] = t_npbch.npbch_encode_np(mib, ncell)[0]
    t_npbch.put_nrs_np(frames[0], ncell, 0)
    t_nbiot.put_npss_grid(frames[5])
    t_nbiot.put_nsss_grid(frames[9], ncell, f4)
    return frames


def test_nbiot_cell_search_end_to_end():
    """NPSS -> NSSS -> MIB-NB over a simulated anchor-carrier stream."""
    rng = np.random.default_rng(7)
    ncell, f4 = 311, 1
    mib = t_npbch.MibNb(sfn_msb=2, op_mode=3)
    frames = frame_with_cell(ncell, mib, f4)
    rx = frames * np.complex64(0.8 * np.exp(0.3j)) + cnoise(rng, frames.shape, 0.04)
    res = t_nbiot.nbiot_cell_search(t(rx))
    assert res is not None
    nid, sf5, f4_hat, conf = res
    assert nid == ncell and sf5 == 5 and f4_hat == f4
    res_r = r_nbiot.nbiot_cell_search(jnp.asarray(rx))
    assert res_r[:3] == res[:3]
    np.testing.assert_allclose(conf, res_r[3], atol=METRIC_ATOL)
    idx = torch.from_numpy(t_npbch.npbch_re_indices(nid).astype(np.int64))
    mib_hat, blk, ok = t_npbch.npbch_decode(t_npbch.nrs_equalize(t(rx[sf5 - 5]), nid, 0, idx), nid)
    assert ok and blk == 0 and mib_hat == mib
    assert t_nbiot.nbiot_cell_search(t(cnoise(rng, frames.shape, 0.1))) is None


def test_npdsch_roundtrip_and_dci_n1():
    """NPDSCH TB over multiple subframes with DCI N1 scheduling fields."""
    dci = t_npdsch.DciN1(i_sf=2, i_tbs=4, i_rep=0, ndi=1)
    assert t_npdsch.DciN1.unpack(dci.pack()) == dci
    np.testing.assert_array_equal(dci.pack(), r_npdsch.DciN1(**vars(dci)).pack())
    assert t_npdsch.NB_TBS == r_npdsch.NB_TBS
    rng = np.random.default_rng(5)
    ncell, rnti = 77, 0x46
    tbs = t_npdsch.NB_TBS[(dci.i_tbs, dci.i_sf)]
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    sym = t_npdsch.npdsch_encode_np(tb, ncell, rnti, dci.i_sf)
    np.testing.assert_array_equal(sym, r_npdsch.npdsch_encode_np(tb, ncell, rnti, dci.i_sf))
    h = np.complex64(0.9 * np.exp(0.2j))
    rx = sym * h + cnoise(rng, sym.shape, 0.05)
    eq = (rx * np.conj(h) / (abs(h) ** 2)).astype(np.complex64)
    tb_hat, ok = t_npdsch.npdsch_decode(t(eq), ncell, rnti, dci.i_sf, tbs)
    assert ok
    np.testing.assert_array_equal(tb_hat, tb)
    tb_r, ok_r = r_npdsch.npdsch_decode(jnp.asarray(eq), ncell, rnti, dci.i_sf, tbs)
    assert ok_r and np.array_equal(np.asarray(tb_r), tb_hat)


def test_npdcch_to_npdsch_chain():
    """NPDCCH DCI N1 blind decode drives an NPDSCH decode."""
    rng = np.random.default_rng(6)
    ncell, rnti = 100, 0x123
    dci = t_npdsch.DciN1(i_sf=1, i_tbs=2, ndi=1, delay=0)
    ctrl_sym = t_npdsch.npdcch_encode_np(dci.pack(), rnti, ncell, sf_idx=1)
    np.testing.assert_array_equal(ctrl_sym, r_npdsch.npdcch_encode_np(dci.pack(), rnti, ncell, sf_idx=1))
    h = np.complex64(0.85)
    rx = ctrl_sym * h + cnoise(rng, ctrl_sym.shape, 0.05)
    eq = (rx * np.conj(h) / abs(h) ** 2).astype(np.complex64)
    dci_hat = t_npdsch.npdcch_blind_search(t(eq), rnti, ncell, 1)
    assert dci_hat == dci
    assert vars(r_npdsch.npdcch_blind_search(jnp.asarray(eq), rnti, ncell, 1)) == vars(dci_hat)
    assert t_npdsch.npdcch_blind_search(t(eq), 0x999, ncell, 1) is None
    tbs = t_npdsch.NB_TBS[(dci_hat.i_tbs, dci_hat.i_sf)]
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    data = t_npdsch.npdsch_encode_np(tb, ncell, rnti, dci_hat.i_sf, sf_idx0=2)
    tb_hat, ok = t_npdsch.npdsch_decode(t(data), ncell, rnti, dci_hat.i_sf, tbs, sf_idx0=2)
    assert ok
    np.testing.assert_array_equal(tb_hat, tb)


def test_nprach_detection():
    """NPRACH single-tone hopping preambles detect at the right candidate
    through noise; absent preambles stay below threshold."""
    rng = np.random.default_rng(4)
    for n_init in (0, 5, 11):
        p = t_nprach.nprach_generate_np(n_init)
        np.testing.assert_array_equal(p, r_nprach.nprach_generate_np(n_init))
        rx = p * np.complex64(0.7) + cnoise(rng, len(p), 0.1)
        metric, det, delay = t_nprach.nprach_detect(rx, device=CPU)
        m = metric.numpy()
        assert det[n_init] and int(np.argmax(m)) == n_init
        m_r, det_r, delay_r = r_nprach.nprach_detect(jnp.asarray(rx))
        np.testing.assert_allclose(m, np.asarray(m_r), rtol=1e-5)
        np.testing.assert_array_equal(det.numpy(), np.asarray(det_r))
        np.testing.assert_allclose(delay, float(delay_r), atol=1e-3)
    noise = cnoise(rng, 5376, 0.1)
    _, det, _ = t_nprach.nprach_detect(noise, device=CPU)
    assert not det.any()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_nprach.nprach_detect(noise)


def ue_stream(rng, ncell=42, rnti=0x85):
    """The reference test's anchor stream: NPBCH sf0, NPDCCH sf1, NPDSCH
    sf2-3, NPSS sf5, NSSS sf9."""
    mib = t_npbch.MibNb(sfn_msb=7, op_mode=3)
    frames = frame_with_cell(ncell, mib)
    dci = t_npdsch.DciN1(i_sf=1, i_tbs=4, ndi=1)
    tbs = t_npdsch.NB_TBS[(dci.i_tbs, dci.i_sf)]
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    idx = t_npdsch.npdsch_re_indices(ncell)
    frames[1].reshape(-1)[idx] = t_npdsch.npdcch_encode_np(dci.pack(), rnti, ncell, 1)
    t_npbch.put_nrs_np(frames[1], ncell, 1)
    data = t_npdsch.npdsch_encode_np(tb, ncell, rnti, dci.i_sf, sf_idx0=2)
    for s in range(2):
        frames[2 + s].reshape(-1)[idx] = data[s]
        t_npbch.put_nrs_np(frames[2 + s], ncell, 2 + s)
    return frames, mib, dci, tb


def test_nbiot_ue_facade_acquire_and_data():
    """ue_sync_nbiot/ue_dl_nbiot analog: acquire the cell from a simulated
    anchor stream, then receive an NPDCCH-scheduled NPDSCH TB."""
    rng = np.random.default_rng(11)
    ncell, rnti = 42, 0x85
    frames, mib, dci, tb = ue_stream(rng, ncell, rnti)
    rx = frames * np.complex64(0.8 * np.exp(-0.5j)) + cnoise(rng, frames.shape, 0.03)
    cell = t_ue.nbiot_ue_acquire(rx, device=CPU)
    assert cell is not None and cell.n_id_ncell == ncell and cell.mib == mib
    cell_r = r_ue.nbiot_ue_acquire(rx)
    assert (cell_r.n_id_ncell, cell_r.sf5_index, cell_r.frame4) == (ncell, cell.sf5_index, cell.frame4)
    dci_hat, tb_hat, ok = t_ue.nbiot_ue_rx_data(rx[1], rx[2:4], cell, rnti, 1, 2, device=CPU)
    assert ok and dci_hat == dci
    np.testing.assert_array_equal(tb_hat, tb)
    dci_r, tb_r, ok_r = r_ue.nbiot_ue_rx_data(rx[1], rx[2:4], cell_r, rnti, 1, 2)
    assert ok_r and vars(dci_r) == vars(dci_hat) and np.array_equal(np.asarray(tb_r), tb_hat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ue.nbiot_ue_acquire(rx)


def test_nbiot_raw_sample_acquisition():
    """Acquire from raw 1.92 Msps baseband — unknown timing offset, CFO,
    channel phase — via NPSS time correlation + NPSS-based CFO estimation,
    then NSSS + MIB-NB through the grid chain; beside the reference's
    acquisition of the same capture, and the EARFCN scan."""
    rng = np.random.default_rng(3)
    ncell = 257
    mib = t_npbch.MibNb(sfn_msb=5, op_mode=2)
    frame = frame_with_cell(ncell, mib)
    tx = t_sync.nbiot_modulate_np(np.tile(frame, (4, 1, 1)))
    np.testing.assert_array_equal(tx, r_sync.nbiot_modulate_np(np.tile(frame, (4, 1, 1))))
    cfo_norm = 0.02
    n = np.arange(len(tx))
    rx = tx * np.exp(2j * np.pi * cfo_norm * n / 128) * np.exp(0.7j) * 0.8
    rx = np.concatenate([np.zeros(777, np.complex64), rx])
    rx = (rx + 0.02 * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))).astype(np.complex64)

    res = t_sync.nbiot_acquire_raw(rx, device=CPU)
    assert res is not None
    assert res.cell.n_id_ncell == ncell and res.cell.mib == mib
    assert abs(res.cfo - cfo_norm) < 0.005
    assert res.timing % (10 * t_sync.SF_LEN) == 777 % (10 * t_sync.SF_LEN)
    ref = r_sync.nbiot_acquire_raw(rx)
    assert ref.timing == res.timing and ref.cell.n_id_ncell == ncell
    assert abs(ref.cfo - res.cfo) < 1e-4
    np.testing.assert_allclose(res.psr, ref.psr, rtol=1e-4)
    peak, psr = t_sync.npss_find(t(rx))
    assert psr == pytest.approx(ref.psr, rel=1e-4)
    assert peak == r_sync.npss_find(rx)[0]
    assert abs(t_sync.npss_cfo_estimate(t(rx), peak) - r_sync.npss_cfo_estimate(rx, peak)) < 1e-4
    np.testing.assert_allclose(res.grids.numpy(), r_sync.nbiot_demodulate_np(
        (rx * np.exp(-2j * np.pi * ref.cfo * np.arange(len(rx)) / 128)).astype(np.complex64), ref.timing),
        atol=2e-3)
    noise = (0.1 * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))).astype(np.complex64)
    found = t_sync.nbiot_cell_search_scan({2506: noise, 2510: rx}, device=CPU)
    assert [e for e, _ in found] == [2510]


def test_nbiot_demodulator_and_replica():
    """The 128-point demodulator against the reference's at a timing offset;
    the NPSS replica bit for bit."""
    rng = np.random.default_rng(8)
    x = cnoise(rng, 5 * t_sync.SF_LEN + 300, np.sqrt(0.5))
    np.testing.assert_allclose(t_sync.nbiot_demodulate(t(x), 123).numpy(),
                               r_sync.nbiot_demodulate_np(x, 123), atol=1e-5)
    np.testing.assert_array_equal(t_sync.npss_time_np(), r_sync.npss_time_np())


@pytest.mark.parametrize("name", ["cell_search_nbiot", "npdsch_ue"])
def test_example_selftests(name, capsys):
    """The two example scripts' `--selftest` on the CPU, with the reference
    scripts' prints."""
    import importlib

    mod = importlib.import_module(f"srsran_tpu_torch.examples.{name}")
    assert mod.main(["--selftest", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert ("selftest: OK" in out) if name == "cell_search_nbiot" else ("selftest: payload matches" in out)
    assert "EARFCN 2510: N_id_ncell=199" in out if name == "cell_search_nbiot" else "N_id_ncell = 42" in out
