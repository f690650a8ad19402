"""PHICH: HARQ ACK/NACK indicator, TS 36.211 §6.9.

Counterpart of `srsran_tpu/phy/phch/phich.py`: 1 ACK bit → BPSK ×3
repetition → length-4 orthogonal cover (8 sequences: Walsh ± j·Walsh; 2
and 4 for extended CP) → 12 symbols, scrambled, on the group's 3 REGs (the
§6.9.3 cell-ID spread of `regs.py`).  Host writer in numpy; `phich_decode`
despreads on the device of its input.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import Cell
from ..sequence import gold_sequence_signs
from .pcfich import pcfich_cinit

NSF = 4  # spreading factor, normal CP (extended CP halves it)
PHICH_LEN = 12  # symbols per PHICH, normal CP

_WALSH4 = np.array(
    [[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], np.float32
)
_WALSH2 = np.array([[1, 1], [1, -1]], np.float32)


def phich_nsf(cell: Cell) -> int:
    """Spreading factor: 4 (normal CP) or 2 (extended CP, TS 36.211 §6.9.1)."""
    return 4 if cell.nsymb_per_slot == 7 else 2


def phich_len(cell: Cell) -> int:
    return 3 * phich_nsf(cell)


def nof_phich_sequences(cell: Cell) -> int:
    """2·NSF orthogonal sequences per group (Table 6.9.1-2)."""
    return 2 * phich_nsf(cell)


@lru_cache(maxsize=16)
def phich_sequence(n_seq: int, nsf: int = 4) -> np.ndarray:
    """Orthogonal cover n_seq ∈ [0, 2·nsf): Walsh ± j·Walsh of length nsf
    (TS 36.211 Table 6.9.1-2 for both CP lengths)."""
    tab = _WALSH4 if nsf == 4 else _WALSH2
    w = tab[n_seq % nsf].astype(np.complex64)
    return w if n_seq < nsf else (1j * w).astype(np.complex64)


def nof_phich_groups(cell: Cell, ng: float | None = None) -> int:
    """N_group from the cell's Ng (MIB phich_resources 0..3 → 1/6, 1/2, 1,
    2); doubled for extended CP (two groups per mapping unit)."""
    if ng is None:
        ng = {0: 1 / 6, 1: 1 / 2, 2: 1.0, 3: 2.0}.get(cell.phich_resources, 1 / 6)
    m1 = int(np.ceil(ng * cell.nof_prb / 8.0))
    return m1 if cell.nsymb_per_slot == 7 else 2 * m1


@lru_cache(maxsize=256)
def phich_re_indices(cell: Cell, group: int) -> np.ndarray:
    """The REs of a PHICH group — the cell-ID-spread REG selection of
    TS 36.211 §6.9.3 (`regs.py`)."""
    from .regs import phich_group_re_indices_true

    idx = phich_group_re_indices_true(cell, group)
    if cell.phich_length == 0 and not (idx < cell.nof_re_per_symbol).all():
        raise ValueError("a normal-duration PHICH group left symbol 0")
    return idx


def phich_encode(ack: int, n_seq: int, nsf: int = 4) -> np.ndarray:
    """1 bit → 3·nsf complex symbols (before scrambling); bit 0 → +1."""
    b = 1.0 - 2.0 * ack
    z = np.repeat(np.complex64(b), 3)
    return (np.kron(z, phich_sequence(n_seq, nsf))).astype(np.complex64)


def phich_put_np(grid: np.ndarray, cell: Cell, sf_idx: int, group: int, n_seq: int, ack: int):
    """grid: (nsymb, nre) or (nports, nsymb, nre) — 2+ ports use SFBC."""
    nsf = phich_nsf(cell)
    sym = phich_encode(ack, n_seq, nsf)
    signs = gold_sequence_signs(pcfich_cinit(sf_idx, cell.id), 3 * nsf)
    idx = phich_re_indices(cell, group)
    nre = cell.nof_re_per_symbol
    ls, ks = idx // nre, idx % nre  # extended duration spans symbols 0..2
    tx = (sym * signs).astype(np.complex64)
    if grid.ndim == 3 and grid.shape[0] >= 2:
        from ..mimo import precode_diversity2

        ports = precode_diversity2(tx)
        grid[0][ls, ks] += ports[0]
        grid[1][ls, ks] += ports[1]
    else:
        g = grid if grid.ndim == 2 else grid[0]
        g[ls, ks] += tx
    return grid


def _phich_signs(sf_idx: int, cell_id: int, n: int) -> np.ndarray:
    return gold_sequence_signs(pcfich_cinit(sf_idx, cell_id), n)


def _phich_cover_conj(n_seq: int, nsf: int) -> np.ndarray:
    return np.conj(phich_sequence(n_seq, nsf))


def phich_decode(sym_eq: torch.Tensor, cell: Cell, sf_idx: int, n_seq: int):
    """(3·nsf,) equalized symbols of a group → (ack bit () uint8, soft
    metric ()) on the device of `sym_eq`.  Despread with the cover
    sequence; a positive metric is ACK = 0."""
    nsf = phich_nsf(cell)
    dev = sym_eq.device
    z = (sym_eq * table(_phich_signs, sf_idx, cell.id, 3 * nsf, device=dev)).reshape(3, nsf)
    corr = torch.sum(z * table(_phich_cover_conj, n_seq, nsf, device=dev), dim=-1)
    metric = torch.sum(corr).real
    return (metric < 0).to(torch.uint8), metric
