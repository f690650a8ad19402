"""UL demodulation reference signals (PUSCH DMRS), TS 36.211 §5.5 — host
side.  Copy of `base_sequence`, `pusch_dmrs` and `dmrs_symbol_in_slot` from
`srsran_tpu/phy/chest/refsignal_ul.py`: base sequences r_uv(n) from
cyclically-extended Zadoff-Chu (M >= 36) or the spec phase tables (M = 12,
24), a cyclic shift alpha, on SC-FDMA symbol 3 of each slot (normal CP).
Group hopping is off (u = cell_id % 30, v = 0).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..common import Cell
from .ul_rs_data import PHI_M12, PHI_M24


def _largest_prime_below(n: int) -> int:
    for c in range(n - 1, 1, -1):
        if all(c % d for d in range(2, int(c**0.5) + 1)):
            return c
    raise ValueError(n)


@lru_cache(maxsize=512)
def base_sequence(u: int, m_sc: int, v: int = 0) -> np.ndarray:
    """r_uv(n) of length m_sc (TS 36.211 §5.5.1)."""
    if m_sc in (12, 24):
        phi = np.asarray((PHI_M12 if m_sc == 12 else PHI_M24)[u], np.float64)
        return np.exp(1j * phi * np.pi / 4).astype(np.complex64)
    nzc = _largest_prime_below(m_sc)
    q_bar = nzc * (u + 1) / 31.0
    q = int(np.floor(q_bar + 0.5) + v * (-1) ** np.floor(2 * q_bar))
    m = np.arange(nzc)
    zc = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    return zc[np.arange(m_sc) % nzc].astype(np.complex64)


def pusch_dmrs(cell: Cell, nof_prb_alloc: int, cyclic_shift: int = 0,
               slot_in_sf: int = 0) -> np.ndarray:
    """DMRS sequence of one slot's PUSCH allocation: (12*nof_prb,) complex64."""
    m_sc = 12 * nof_prb_alloc
    r = base_sequence(cell.id % 30, m_sc)
    alpha = 2 * np.pi * cyclic_shift / 12.0
    return (r * np.exp(1j * alpha * np.arange(m_sc))).astype(np.complex64)


def dmrs_symbol_in_slot(cell: Cell) -> int:
    """PUSCH DMRS on symbol 3 (normal CP) / 2 (extended)."""
    return 3 if cell.nsymb_per_slot == 7 else 2
