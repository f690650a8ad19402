"""Sounding reference signals (SRS), TS 36.211 §5.5.3: wideband, comb-2.

Counterpart of `srsran_tpu/phy/chest/srs.py`.  The sequence, its symbol and
the transmitter's grid writer are host numpy; `srs_estimate` (LS on the
comb, the noise from the high-pass residual, the SNR) runs on the device of
the grid.  The SRS takes every other subcarrier of the sounding bandwidth on
the last SC-FDMA symbol of the subframe.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..common import Cell
from .refsignal_ul import base_sequence


def srs_sequence(cell: Cell, nof_prb_srs: int, cyclic_shift: int = 0, comb: int = 0) -> np.ndarray:
    """SRS values on its comb: (6*nof_prb_srs,) complex64."""
    m_sc = 6 * nof_prb_srs  # comb-2: every other subcarrier
    # base sequences are defined for multiples of 12: the first m_sc values
    # of the length-m_base one (the reference's rounding, kept as it is)
    m_base = max(12, m_sc)
    r = base_sequence(cell.id % 30, m_base if m_base % 12 == 0 else 12 * ((m_base // 12) + 1))[:m_sc]
    alpha = 2 * np.pi * cyclic_shift / 8.0
    n = np.arange(m_sc)
    return (r * np.exp(1j * alpha * n)).astype(np.complex64)


def srs_symbol_index(cell: Cell) -> int:
    """SRS on the last symbol of the subframe."""
    return cell.nsymb_per_sf - 1


def _comb(prb_start: int, nof_prb_srs: int, comb: int) -> np.ndarray:
    return prb_start * 12 + comb + 2 * np.arange(6 * nof_prb_srs)


def put_srs_np(grid: np.ndarray, cell: Cell, prb_start: int, nof_prb_srs: int,
               cyclic_shift: int = 0, comb: int = 0) -> np.ndarray:
    """Host TX: write the SRS into a (nsymb_sf, nre) grid."""
    grid[srs_symbol_index(cell), _comb(prb_start, nof_prb_srs, comb)] = srs_sequence(
        cell, nof_prb_srs, cyclic_shift, comb)
    return grid


def _pilot_tables(cell: Cell, prb_start: int, nof_prb_srs: int, cyclic_shift: int, comb: int):
    """(flat indices (symbol*nre + k) of the comb, conjugated sequence)."""
    k = _comb(prb_start, nof_prb_srs, comb)
    return (srs_symbol_index(cell) * cell.nof_re_per_symbol + k).astype(np.int64), np.conj(
        srs_sequence(cell, nof_prb_srs, cyclic_shift, comb))


def srs_estimate(rx_grid, cell: Cell, prb_start: int, nof_prb_srs: int, cyclic_shift: int = 0,
                 comb: int = 0, *, device=None):
    """LS channel estimate + SNR on the SRS comb, on `device` (None: the card).

    rx_grid: (..., nsymb, nre) (numpy or a tensor).  Returns (ce (...,
    6*nof_prb_srs) complex64, snr (...,) float32, linear)."""
    dev = resolve(device)
    grid = as_samples(rx_grid, dev)
    idx, ref = table(_pilot_tables, cell, prb_start, nof_prb_srs, cyclic_shift, comb, device=dev)
    ls = grid.reshape(grid.shape[:-2] + (-1,))[..., idx] * ref
    # the noise from the high-pass residual
    resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
    noise = torch.mean(resid.abs() ** 2, dim=-1) / 1.5
    sig = torch.mean(ls.abs() ** 2, dim=-1)
    return ls, sig / torch.clamp(noise, min=1e-12)
