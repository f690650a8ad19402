"""eMBMS on the port: the MBSFN OFDM half of `srsran_tpu_torch/phy/ofdm.py`
and `srsran_tpu_torch/phy/phch/pmch.py` against the JAX reference, on the CPU.

The four cases of `tests/test_pmch.py` on the port, each beside the
reference on the same numpy inputs made from a seed.  Tolerances:
- MBSFN RS positions, sequence and PMCH RE indices: identical (host copies;
  `tests/test_torch_host_tables.py` holds them bit for bit too).
- The mixed-CP modulator and demodulator: rtol/atol 1e-4 on unit-variance
  bins, as the OFDM cases of `tests/test_torch_modules.py` (FFTs of another
  library); the guard exactly zero on both.
- `chest_mbsfn`: atol 1e-5 on the O(1) estimate and the noise (sums in
  another order).
- TB bits and CRC verdicts: identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.ofdm as r_ofdm
import srsran_tpu.phy.phch.pmch as r_pmch
import srsran_tpu_torch.phy.ofdm as t_ofdm
import srsran_tpu_torch.phy.phch.pmch as t_pmch
from srsran_tpu.phy.common import CP, Cell, cp_len_norm
from srsran_tpu.phy.modem import Mod
from srsran_tpu.phy.phch.ra import dl_tbs
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.phy.modem import Mod as TMod

torch.set_num_threads(1)

GRID_TOL = 1e-4
CHEST_ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def ofdm_pair(cell):
    ref = r_ofdm.OfdmConfig.from_cell(cell, normalize=True)
    return ref, from_reference(ref)


def noise(rng, shape, scale):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64) * scale


def test_mbsfn_rs_positions():
    cell = Cell(nof_prb=25, nof_ports=1, id=1, cp=CP.EXT)
    syms, freqs = t_pmch.mbsfn_rs_positions(from_reference(cell))
    np.testing.assert_array_equal(syms, [2, 6, 10])
    assert freqs.shape == (3, 150)
    np.testing.assert_array_equal(freqs[0][:3], [0, 2, 4])
    np.testing.assert_array_equal(freqs[1][:3], [1, 3, 5])
    for a, b in zip((syms, freqs), r_pmch.mbsfn_rs_positions(cell)):
        np.testing.assert_array_equal(a, b)


def test_mbsfn_chest():
    cell = Cell(nof_prb=25, nof_ports=1, id=1, cp=CP.EXT)
    rng = np.random.default_rng(0)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    r_pmch.put_mbsfn_rs_np(grid, cell, 3, area_id=77)
    h = np.complex64(0.8 - 0.3j)
    rx = grid * h + noise(rng, grid.shape, 0.02)
    ce, nz = t_pmch.chest_mbsfn(t(rx), from_reference(cell), 3, 77)
    assert abs(complex(torch.mean(ce)) - h) < 0.03
    assert float(nz) < 0.01
    ce_r, nz_r = r_pmch.chest_mbsfn(rx, cell, 3, 77)
    np.testing.assert_allclose(ce.numpy(), np.asarray(ce_r), atol=CHEST_ATOL)
    np.testing.assert_allclose(float(nz), float(nz_r), atol=CHEST_ATOL)


def test_pmch_roundtrip_through_ofdm():
    """PMCH TB through the extended-CP OFDM chain with a dispersive channel,
    MBSFN-RS equalization, 16QAM, turbo decode CRC-OK, on both packages."""
    cell = Cell(nof_prb=25, nof_ports=1, id=1, cp=CP.EXT)
    tcell = from_reference(cell)
    rng = np.random.default_rng(1)
    area_id = 5
    tbs = dl_tbs(10, 25)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    grid = r_pmch.pmch_encode_np(cell, 3, area_id, Mod.QAM16, tbs, tb)
    np.testing.assert_array_equal(
        t_pmch.pmch_encode_np(tcell, 3, area_id, TMod.QAM16, tbs, tb), grid)
    ref_cfg, cfg = ofdm_pair(cell)
    tx = np.asarray(r_ofdm.ofdm_tx_sf(ref_cfg, grid))
    k = np.arange(cell.nof_re_per_symbol)
    hfreq = (1.0 + 0.3 * np.exp(-2j * np.pi * k * 8 / cell.symbol_sz)).astype(np.complex64)
    rx = np.asarray(r_ofdm.ofdm_rx_sf(ref_cfg, tx)) * hfreq[None, :]
    rx = rx + noise(rng, rx.shape, 0.01)
    tb_hat, ok = t_pmch.pmch_decode(t(rx), tcell, 3, area_id, TMod.QAM16, tbs)
    assert ok
    np.testing.assert_array_equal(tb_hat.numpy(), tb)
    tb_ref, ok_ref = r_pmch.pmch_decode(rx, cell, 3, area_id, Mod.QAM16, tbs)
    assert ok_ref == ok
    np.testing.assert_array_equal(tb_hat.numpy(), tb_ref)


def test_pmch_mixed_cp_mbsfn_subframe():
    """The real MBSFN layout (ofdm.c:429/543): 2 normal-CP control symbols +
    guard + extended-CP MBSFN region in ONE subframe, modulated and
    demodulated by the port and by the reference; decode after the
    round trip."""
    cell = Cell(nof_prb=25, nof_ports=1, id=1, cp=CP.EXT)
    tcell = from_reference(cell)
    rng = np.random.default_rng(2)
    area_id = 9
    tbs = dl_tbs(9, 25)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    grid = r_pmch.pmch_encode_np(cell, 4, area_id, Mod.QAM16, tbs, tb)
    ctrl = (rng.integers(0, 2, (2, cell.nof_re_per_symbol)) * 2 - 1).astype(np.complex64)
    grid[:2] = ctrl / np.sqrt(2)

    ref_cfg, cfg = ofdm_pair(cell)
    tx = t_ofdm.ofdm_tx_sf_mbsfn(cfg, t(grid), 2).numpy()
    assert tx.shape == (cfg.sf_sz,)
    tx_ref = np.asarray(r_ofdm.ofdm_tx_sf_mbsfn(ref_cfg, jnp.asarray(grid), 2))
    np.testing.assert_allclose(tx, tx_ref, rtol=GRID_TOL, atol=GRID_TOL)
    g0 = 2 * cfg.symbol_sz + cp_len_norm(0, cfg.symbol_sz) + cp_len_norm(1, cfg.symbol_sz)
    glen = t_ofdm.mbsfn_guard_len(2, cfg.symbol_sz)
    assert glen == r_ofdm.mbsfn_guard_len(2, cfg.symbol_sz)
    assert np.max(np.abs(tx[g0 : g0 + glen])) == 0.0

    rx_grid = t_ofdm.ofdm_rx_sf_mbsfn(cfg, t(tx), 2).numpy()
    np.testing.assert_allclose(
        rx_grid, np.asarray(r_ofdm.ofdm_rx_sf_mbsfn(ref_cfg, jnp.asarray(tx), 2)),
        rtol=GRID_TOL, atol=GRID_TOL)
    rx_grid = rx_grid + noise(rng, rx_grid.shape, 0.01)
    assert np.max(np.abs(rx_grid[:2] - grid[:2])) < 0.1
    tb_hat, ok = t_pmch.pmch_decode(t(rx_grid), tcell, 4, area_id, TMod.QAM16, tbs)
    assert ok
    np.testing.assert_array_equal(tb_hat.numpy(), tb)
    tb_ref, ok_ref = r_pmch.pmch_decode(rx_grid, cell, 4, area_id, Mod.QAM16, tbs)
    assert ok_ref and np.array_equal(tb_ref, tb)


@pytest.mark.parametrize("prb,region", [(6, 1), (15, 2), (50, 1), (100, 2)])
def test_mbsfn_layout_and_guard(prb, region):
    """The mixed-CP layout, the window and transmit index tables, and the
    zero guard, at the widths and control-region lengths the cells use."""
    cell = Cell(nof_prb=prb, nof_ports=1, id=3, cp=CP.EXT)
    ref_cfg, cfg = ofdm_pair(cell)
    assert t_ofdm._mbsfn_layout(cfg, region) == r_ofdm._mbsfn_layout(ref_cfg, region)
    g = noise(np.random.default_rng(prb), (12, cell.nof_re_per_symbol), np.sqrt(0.5))
    tx = t_ofdm.ofdm_tx_sf_mbsfn(cfg, t(g), region).numpy()
    np.testing.assert_allclose(tx, np.asarray(r_ofdm.ofdm_tx_sf_mbsfn(ref_cfg, jnp.asarray(g), region)),
                               rtol=GRID_TOL, atol=GRID_TOL)
    dst, _src = t_ofdm._mbsfn_tx_index(cfg, region)
    guard = np.setdiff1d(np.arange(cfg.sf_sz), dst)
    assert len(guard) == t_ofdm.mbsfn_guard_len(region, cfg.symbol_sz)
    assert np.all(tx[guard] == 0)
    np.testing.assert_allclose(t_ofdm.ofdm_rx_sf_mbsfn(cfg, t(tx), region).numpy(), g, atol=GRID_TOL)
