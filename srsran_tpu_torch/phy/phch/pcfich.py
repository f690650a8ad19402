"""PCFICH: CFI coding and mapping, TS 36.212 §5.3.4 / TS 36.211 §6.7.

Counterpart of `srsran_tpu/phy/phch/pcfich.py`: the three 32-bit CFI
codewords are rotations of [0, 1, 1]; the host writer scrambles, maps to
QPSK and puts the 16 symbols on the four PCFICH REGs (SFBC for 2+ ports);
`pcfich_decode` correlates the descrambled soft bits against the three
codewords on the device of its input.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import Cell
from ..modem import Mod, demod_soft, modulate_np
from ..sequence import gold_sequence, gold_sequence_signs

CFI_LEN = 32


@lru_cache(maxsize=8)
def cfi_codeword(cfi: int) -> np.ndarray:
    base = np.array([0, 1, 1], np.uint8)
    off = (2 * (cfi - 1)) % 3
    return base[(np.arange(CFI_LEN) + off) % 3]


def pcfich_cinit(sf_idx: int, cell_id: int) -> int:
    return ((sf_idx + 1) * (2 * cell_id + 1) << 9) + cell_id


@lru_cache(maxsize=256)
def pcfich_re_indices(cell: Cell) -> np.ndarray:
    """16 RE indices (symbol 0) of the 4 PCFICH REGs (TS 36.211 §6.7.4)."""
    nre = cell.nof_re_per_symbol
    vshift = cell.id % 6
    k_bar = 6 * (cell.id % (2 * cell.nof_prb))
    out = []
    for i in range(4):
        k0 = (k_bar + (i * cell.nof_prb // 2) * 6) % nre
        ks = [k0 + j for j in range(6) if (k0 + j) % 3 != vshift % 3]
        out += ks[:4]
    return np.asarray(out, np.int32)


def pcfich_put_np(grid: np.ndarray, cell: Cell, sf_idx: int, cfi: int):
    """grid: (nsymb, nre) single-port, or (nports, nsymb, nre) — 2+ ports get
    SFBC transmit diversity (TS 36.211 §6.7.3)."""
    cw = cfi_codeword(cfi)
    seq = gold_sequence(pcfich_cinit(sf_idx, cell.id), CFI_LEN)
    sym = modulate_np(Mod.QPSK, cw ^ seq)
    idx = pcfich_re_indices(cell)
    if grid.ndim == 3 and grid.shape[0] >= 2:
        from ..mimo import precode_diversity2

        ports = precode_diversity2(sym.astype(np.complex64))
        grid[0][0, idx] = ports[0]
        grid[1][0, idx] = ports[1]
    else:
        g = grid if grid.ndim == 2 else grid[0]
        g[0, idx] = sym
    return grid


def _pcfich_signs(sf_idx: int, cell_id: int) -> np.ndarray:
    return gold_sequence_signs(pcfich_cinit(sf_idx, cell_id), CFI_LEN)


def _cfi_book() -> np.ndarray:
    """(32, 3) ±1 columns of the three CFI codewords (bit 0 → +1)."""
    return np.stack([1.0 - 2.0 * cfi_codeword(c) for c in (1, 2, 3)], axis=1).astype(np.float32)


def pcfich_decode(sym_eq: torch.Tensor, cell: Cell, sf_idx: int):
    """(16,) equalized symbols → (cfi (), corr (3,)) on the device of
    `sym_eq`; the first CFI wins a tie."""
    dev = sym_eq.device
    llr = demod_soft(Mod.QPSK, sym_eq) * table(_pcfich_signs, sf_idx, cell.id, device=dev)
    corr = (-llr) @ table(_cfi_book, device=dev)
    return torch.argmax(corr) + 1, corr
