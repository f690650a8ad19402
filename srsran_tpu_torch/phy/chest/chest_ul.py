"""UL channel estimation from the PUSCH DMRS.

Counterpart of `srsran_tpu/phy/chest/chest_ul.py`: LS estimates at the two
DMRS symbols → frequency smoothing as one product with the (M, M) matrix of
`chest_dl._smooth_matrix` → noise from the residual → linear time
interpolation between the two DMRS symbols, clamped outside them.  The
tables are host-built and move to a device once per allocation; the
smoothing matrix is cast to complex64 there (the product must stay in full
fp32: TF32 off on the card) and holds 10.6 MB at 96 PRB, so that cache is
bounded.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...runtime.trace import count
from ..common import Cell
from .chest_dl import _smooth_matrix
from .refsignal_ul import dmrs_symbol_in_slot, pusch_dmrs


def dmrs_symbols(cell: Cell) -> tuple[int, int]:
    """The two DMRS symbols of a subframe."""
    l_dmrs = dmrs_symbol_in_slot(cell)
    return l_dmrs, cell.nsymb_per_slot + l_dmrs


def time_interp_weights(cell: Cell) -> np.ndarray:
    """(nsymb_sf, 2) float32 weights of the two DMRS-symbol estimates at every
    symbol: linear between them, clamped outside."""
    l0, l1 = dmrs_symbols(cell)
    t = np.zeros((cell.nsymb_per_sf, 2), np.float32)
    for l in range(cell.nsymb_per_sf):
        if l <= l0:
            t[l, 0] = 1.0
        elif l >= l1:
            t[l, 1] = 1.0
        else:
            w = (l - l0) / (l1 - l0)
            t[l] = (1.0 - w, w)
    return t


@lru_cache(maxsize=8)
def _tables(cell: Cell, nof_prb_alloc: int, cyclic_shift: int, smooth_len: int,
            device: torch.device):
    """(conjugated DMRS (2, m_sc), smoothing (m_sc, m_sc), time weights
    (nsymb, 2)), complex64 on `device`."""
    m_sc = 12 * nof_prb_alloc
    r = np.stack([np.conj(pusch_dmrs(cell, nof_prb_alloc, cyclic_shift, s)) for s in range(2)])
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.complex64)).to(device)
                 for a in (r, _smooth_matrix(m_sc, smooth_len), time_interp_weights(cell)))


def chest_ul(rx_grid: torch.Tensor, cell: Cell, prb_start: int, nof_prb_alloc: int,
             cyclic_shift: int = 0, smooth_len: int = 5):
    """Estimate the UL channel over the allocation.

    rx_grid: (..., nsymb_sf, nre) complex64 received grid.
    Returns (ce (..., nsymb_sf, 12*nof_prb_alloc) complex64, noise_est (...,)
    float32)."""
    m_sc = 12 * nof_prb_alloc
    k0 = prb_start * 12
    r, sm, t = _tables(cell, nof_prb_alloc, cyclic_shift, smooth_len, rx_grid.device)
    # the list becomes an index tensor copied from pageable host memory,
    # which makes the host wait for the device's queue: a host read
    count("host_reads")
    pilots = rx_grid[..., list(dmrs_symbols(cell)), k0 : k0 + m_sc]  # (..., 2, m_sc)
    ls = pilots * r
    ls_s = torch.einsum("np,...sp->...sn", sm, ls)
    noise = torch.mean((ls - ls_s).abs() ** 2, dim=(-1, -2))
    ce = torch.einsum("ls,...sn->...ln", t, ls_s)
    return ce.to(torch.complex64), noise
