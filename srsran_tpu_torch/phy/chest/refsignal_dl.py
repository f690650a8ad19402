"""Cell-specific reference signals (CRS), TS 36.211 §6.10.1 — host side.

Copy of the receive-side tables of `srsran_tpu/phy/chest/refsignal_dl.py`:
c_init = 1024*(7*(ns+1)+l+1)*(2*cell_id+1) + 2*cell_id + N_cp, sequence
taken centred for nof_prb out of the 110-PRB master sequence, QPSK mapped
with 1/sqrt(2); frequency positions k = 6m + (v+vshift)%6.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..common import MAX_PRB, CP, Cell
from ..sequence import gold_sequence


def crs_v(port: int, ref_symbol_idx: int) -> int:
    """Frequency shift v per port/ref-symbol."""
    if port == 0:
        return 0 if ref_symbol_idx % 2 == 0 else 3
    if port == 1:
        return 3 if ref_symbol_idx % 2 == 0 else 0
    if port == 2:
        return 0 if ref_symbol_idx == 0 else 3
    return 3 if ref_symbol_idx == 0 else 0


def crs_nof_ref_symbols_slot(port: int) -> int:
    return 2 if port < 2 else 1


def crs_symbol_in_slot(ref_idx: int, cp: CP, port: int) -> int:
    """OFDM symbol within slot of CRS ref symbol (ports 0/1: 0 and nsymb-3)."""
    if port < 2:
        return 0 if ref_idx == 0 else cp.nsymb - 3
    return 1


def _crs_values(cell: Cell, ns: int, lp: int) -> np.ndarray:
    """(2*nof_prb,) complex64 CRS values of slot ns, symbol lp."""
    n_cp = 1 if cell.cp == CP.NORM else 0
    c_init = 1024 * (7 * (ns + 1) + lp + 1) * (2 * cell.id + 1) + 2 * cell.id + n_cp
    c = gold_sequence(c_init, 4 * MAX_PRB)
    m = np.arange(2 * cell.nof_prb) + MAX_PRB - cell.nof_prb
    re = (1.0 - 2.0 * c[2 * m]) * np.sqrt(0.5)
    im = (1.0 - 2.0 * c[2 * m + 1]) * np.sqrt(0.5)
    return (re + 1j * im).astype(np.complex64)


@lru_cache(maxsize=256)
def crs_positions(cell: Cell, port: int):
    """(symbol_indices (nref,), freq_indices (nref, 2*nof_prb)) int32.

    Ports 0/1: 4 ref symbols per sf (l = 0 and nsymb-3 of each slot);
    ports 2/3: 2 ref symbols (l = 1 of each slot)."""
    nsymb = cell.nsymb_per_slot
    syms = []
    freqs = []
    for slot in range(2):
        if port < 2:
            for ref in range(2):
                syms.append(slot * nsymb + crs_symbol_in_slot(ref, cell.cp, port))
                v = (crs_v(port, ref) + cell.id % 6) % 6
                freqs.append(v + 6 * np.arange(2 * cell.nof_prb))
        else:
            syms.append(slot * nsymb + 1)
            v0 = 3 * (slot % 2) if port == 2 else (3 + 3 * (slot % 2)) % 6
            freqs.append((v0 + cell.id % 6) % 6 + 6 * np.arange(2 * cell.nof_prb))
    return np.array(syms, np.int32), np.stack(freqs).astype(np.int32)


def crs_sequence(cell: Cell, sf_idx: int) -> np.ndarray:
    """CRS values of ports 0 and 1 (they share the sequence): (2, 4,
    2*nof_prb) complex64, the ref symbols in subframe order (slot 0 l = 0,
    slot 0 l = nsymb-3, slot 1 l = 0, slot 1 l = nsymb-3)."""
    return np.stack([crs_sequence_port(cell, sf_idx, 0)] * 2)


@lru_cache(maxsize=256)
def crs_sequence_port(cell: Cell, sf_idx: int, port: int) -> np.ndarray:
    """CRS values for one port: (nref, 2*nof_prb) complex64.  The Gold
    sequence depends only on (ns, l), so ports at the same (ns, l) share
    values."""
    if port < 2:
        return np.stack([
            _crs_values(cell, 2 * sf_idx + slot, crs_symbol_in_slot(ref, cell.cp, 0))
            for slot in range(2) for ref in range(2)
        ])
    return np.stack([_crs_values(cell, 2 * sf_idx + slot, 1) for slot in range(2)])


def put_crs_np(grid: np.ndarray, cell: Cell, sf_idx: int) -> np.ndarray:
    """Insert CRS into a (nports, nsymb_sf, nre) numpy grid (tx side)."""
    for p in range(min(cell.nof_ports, grid.shape[0], 4)):
        syms, freqs = crs_positions(cell, p)
        seq = crs_sequence_port(cell, sf_idx, p)
        for s in range(len(syms)):
            grid[p, syms[s], freqs[s]] = seq[s]
    return grid
