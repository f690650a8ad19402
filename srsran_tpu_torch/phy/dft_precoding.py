"""Transform (DFT) precoding for SC-FDMA, TS 36.211 §5.3.3.

Counterpart of `valid_nof_prb`, `_dft_matrix`, `dft_precode` and
`dft_predecode` of `srsran_tpu/phy/dft_precoding.py`.  Sizes are 12*n with n
composed of factors 2/3/5, so instead of non-power-of-2 FFT plans a
precomputed (M, M) DFT matrix multiplies each symbol batch: one complex64
`torch.matmul` (M ≤ 1200).  The matrix moves to a device once per
(M, direction); at 1152 x 1152 it holds 10.6 MB, so the cache is bounded.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def valid_nof_prb(n: int) -> bool:
    """n must factor into 2/3/5 (TS 36.211 §5.3.3)."""
    if n < 1:
        return False
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


@lru_cache(maxsize=16)
def _dft_matrix(m: int, inverse: bool) -> np.ndarray:
    n = np.arange(m)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(n, n) / m) / np.sqrt(m)
    return w.astype(np.complex64)


@lru_cache(maxsize=16)
def _dft_matrix_on(m: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dft_matrix(m, inverse)).to(device)


def dft_precode(symbols: torch.Tensor) -> torch.Tensor:
    """(..., nsym, M) → DFT along the last axis (normalized by 1/sqrt(M))."""
    return torch.matmul(symbols, _dft_matrix_on(symbols.shape[-1], False, symbols.device))


def dft_predecode(symbols: torch.Tensor) -> torch.Tensor:
    """The inverse transform (IDFT), used at the receiver."""
    return torch.matmul(symbols, _dft_matrix_on(symbols.shape[-1], True, symbols.device))
