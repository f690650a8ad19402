"""PSS generation, TS 36.211 §6.11.1 (host side).

Copy of the transmit half of `srsran_tpu/phy/sync/pss.py`: the frequency
domain Zadoff-Chu sequence and its placement in a subframe grid, which the
windowed generator's `template="full"` bakes into subframes 0 and 5.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

PSS_ROOTS = (25, 29, 34)  # u for N_id_2 = 0, 1, 2


@lru_cache(maxsize=8)
def pss_freq_np(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS d_u(n), length 62 (TS 36.211 §6.11.1.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    n2 = np.arange(31, 62)
    b = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63.0)
    return np.concatenate([a, b]).astype(np.complex64)


def put_pss_grid(grid: np.ndarray, n_id_2: int, nof_prb: int, symbol: int):
    """Place the PSS into a (nsymb, nre) grid at `symbol`, on the 62
    subcarriers around DC."""
    k0 = nof_prb * 12 // 2 - 31
    grid[symbol, k0 : k0 + 62] = pss_freq_np(n_id_2)
    return grid
