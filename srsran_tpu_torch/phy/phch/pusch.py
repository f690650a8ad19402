"""PUSCH: grant, channel interleaver, scrambling c_init and host encode.

Counterpart of `UlGrant`, `_interleaver_indices`, `pusch_symbols_data`,
`pusch_cinit` and `pusch_encode_np` of `srsran_tpu/phy/phch/pusch.py`, for
data-only grants.  Chain (TS 36.212 §5.2.2 / 36.211 §5.3): UL-SCH coding →
time-first channel interleaver → scrambling → modulation → DFT precoding →
mapping to the allocated PRBs (every symbol but the DMRS symbol of each
slot) → DMRS.  UCI multiplexing on PUSCH is not ported yet.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from ..chest.refsignal_ul import dmrs_symbol_in_slot, pusch_dmrs
from ..common import Cell
from ..dft_precoding import _dft_matrix
from ..modem import Mod, modulate_np
from ..scrambling import scramble_bits
from ..sequence import gold_sequence
from .pdsch import MOD_QM
from .sch import TbCoding, dlsch_encode_np


@dataclasses.dataclass(frozen=True)
class UlGrant:
    prb_start: int
    nof_prb: int
    mod: Mod = Mod.QPSK
    tbs: int = 0
    rv: int = 0
    rnti: int = 0x1234

    @property
    def qm(self) -> int:
        return MOD_QM[self.mod]


@lru_cache(maxsize=256)
def _interleaver_indices(g: int, qm: int, c_mux: int = 12) -> np.ndarray:
    """Time-first channel interleaver permutation (TS 36.212 §5.2.2.8).

    Returns idx with out[i] = in[idx[i]] for the G coded bits: bits are
    written row-wise in Qm-groups into (R', C_mux) and read column-wise."""
    if g % (qm * c_mux):
        raise ValueError(f"G={g} is no multiple of Qm*C_mux={qm * c_mux}")
    r_prime = g // (qm * c_mux)
    m = np.arange(g).reshape(r_prime, c_mux, qm)
    return m.transpose(1, 0, 2).reshape(-1).astype(np.int32)


@lru_cache(maxsize=256)
def _deinterleaver_indices(g: int, qm: int, c_mux: int = 12) -> np.ndarray:
    """The inverse permutation: in[j] = out[inv[j]] (what the receiver's
    scatter `zeros.at[idx].set(out)` computes, as a gather)."""
    idx = _interleaver_indices(g, qm, c_mux)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(g, dtype=idx.dtype)
    return inv


def pusch_symbols_data(cell: Cell, shortened: bool = False) -> list[int]:
    """Data-bearing SC-FDMA symbols.  `shortened` drops the last symbol, the
    cell-specific SRS subframe format (TS 36.211 §5.5.3.3)."""
    l_dmrs = dmrs_symbol_in_slot(cell)
    last = cell.nsymb_per_sf - (1 if shortened else 0)
    return [l for l in range(last) if l % cell.nsymb_per_slot != l_dmrs]


def pusch_cinit(rnti: int, sf_idx: int, cell_id: int) -> int:
    return (rnti << 14) + (sf_idx << 9) + cell_id


def pusch_encode_np(cell: Cell, sf_idx: int, grant: UlGrant, tb_bits: np.ndarray,
                    uci=None, shortened: bool = False) -> np.ndarray:
    """Host TX: one TB → (nsymb_sf, nre) complex64 grid (UE side, 1 antenna)."""
    if uci is not None:
        raise NotImplementedError("UCI on PUSCH is not ported")
    m_sc = 12 * grant.nof_prb
    data_syms = pusch_symbols_data(cell, shortened)
    g = len(data_syms) * m_sc * grant.qm
    coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv)
    bits = dlsch_encode_np(tb_bits, coding)  # UL-SCH is the same chain here
    inter = bits[_interleaver_indices(g, grant.qm)]
    seq = gold_sequence(pusch_cinit(grant.rnti, sf_idx, cell.id), g)
    sym = modulate_np(grant.mod, scramble_bits(inter, seq)).reshape(len(data_syms), m_sc)
    precoded = (sym @ _dft_matrix(m_sc, False)).astype(np.complex64)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    k0 = grant.prb_start * 12
    grid[data_syms, k0 : k0 + m_sc] = precoded
    l_dmrs = dmrs_symbol_in_slot(cell)
    for slot in range(2):
        grid[slot * cell.nsymb_per_slot + l_dmrs, k0 : k0 + m_sc] = pusch_dmrs(
            cell, grant.nof_prb, 0, slot)
    return grid
