"""PDSCH grant, RE indices, scrambling c_init and host encode — host side.

Copies of `DlGrant`, `pdsch_re_indices` (FDD, full subframe),
`pdsch_cinit` and `pdsch_encode_np` (port 0) from
`srsran_tpu/phy/phch/pdsch.py`.  RE mapping is a
host-built flat index table per (cell, sf, cfi, PRB set); on the device
the receive side is one gather with that table.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from ..common import Cell
from ..modem import Mod, modulate_np
from ..scrambling import scramble_bits
from ..sequence import gold_sequence
from .sch import TbCoding, dlsch_encode_np

MOD_QM = {Mod.QPSK: 2, Mod.QAM16: 4, Mod.QAM64: 6, Mod.QAM256: 8}


@dataclasses.dataclass(frozen=True)
class DlGrant:
    """Simplified DL grant (subset of `srslte_pdsch_grant_t`)."""

    prb: tuple[int, ...]  # allocated PRB indices (same in both slots)
    mod: Mod = Mod.QPSK
    tbs: int = 0
    rv: int = 0
    rnti: int = 0x1234
    tx_scheme: str = "port0"  # port0 | diversity | diversity4 | cdd | spatialmux
    nof_layers: int = 1
    pmi: int = 0

    @property
    def qm(self) -> int:
        return MOD_QM[self.mod]


@lru_cache(maxsize=512)
def pdsch_re_indices(cell: Cell, sf_idx: int, cfi: int, prb: tuple[int, ...]) -> np.ndarray:
    """Flat indices (symbol*nre + k) of PDSCH REs, in LTE mapping order
    (frequency-first within each symbol, symbols ascending).

    Skips the control region (cfi symbols), CRS of all cell ports, and
    PSS/SSS and PBCH in the central 6 PRB (FDD positions).
    """
    nre = cell.nof_re_per_symbol
    nsymb = cell.nsymb_per_sf
    nctrl = cfi + (1 if cell.nof_prb < 10 else 0)
    vshift = cell.id % 6

    reserved = np.zeros((nsymb, nre), bool)
    # CRS: ports 0/1 on symbols 0 and nsymb_slot-3 of each slot; 4 ports add symbol 1
    nports = max(cell.nof_ports, 1)
    for slot in range(2):
        base = slot * cell.nsymb_per_slot
        for li, l in enumerate((base, base + cell.nsymb_per_slot - 3)):
            # one port: v = 0 on ref0, 3 on ref1; more ports: union {0, 3}
            v_list = [0 if li == 0 else 3] if nports == 1 else [0, 3]
            for v in v_list:
                reserved[l, (v + vshift) % 6 + 6 * np.arange(2 * cell.nof_prb)] = True
        if nports == 4:
            for v in (0, 3):
                reserved[base + 1, (v + vshift) % 6 + 6 * np.arange(2 * cell.nof_prb)] = True

    # PSS/SSS at the end of slot 0 of sf 0/5; PBCH in sf 0, slot 1 symbols
    # 0..3 — all on the central 72 REs
    c0 = (cell.nof_prb // 2) * 12 - 36 + (6 * (cell.nof_prb % 2))
    central = np.arange(c0, c0 + 72)
    if sf_idx in (0, 5):
        reserved[cell.nsymb_per_slot - 1, central] = True  # PSS
        reserved[cell.nsymb_per_slot - 2, central] = True  # SSS
    if sf_idx == 0:
        for l in range(4):
            reserved[cell.nsymb_per_slot + l, central] = True

    prb_arr = np.asarray(sorted(prb))
    sc = np.sort((prb_arr[:, None] * 12 + np.arange(12)[None, :]).reshape(-1))
    sel = [l * nre + sc[~reserved[l, sc]] for l in range(nctrl, nsymb)]
    return np.concatenate(sel).astype(np.int32)


def pdsch_cinit(rnti: int, sf_idx: int, cell_id: int, q: int = 0) -> int:
    """TS 36.211 §6.3.1 PDSCH scrambling c_init."""
    return (rnti << 14) + (q << 13) + (sf_idx << 9) + cell_id


def pdsch_encode_np(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant,
                    tb_bits: np.ndarray) -> np.ndarray:
    """Host TX: encode one TB into a (1, nsymb, nre) complex64 grid (no CRS),
    port 0 only."""
    if grant.tx_scheme != "port0":
        raise NotImplementedError(f"tx_scheme {grant.tx_scheme!r} is not ported")
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb)
    coding = TbCoding(tbs=grant.tbs, g=len(idx) * grant.qm, qm=grant.qm, rv=grant.rv)
    bits = dlsch_encode_np(tb_bits, coding)
    seq = gold_sequence(pdsch_cinit(grant.rnti, sf_idx, cell.id), len(bits))
    sym = modulate_np(grant.mod, scramble_bits(bits, seq))
    grid = np.zeros((1, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    grid.reshape(1, -1)[:, idx] = sym[None, :]
    return grid
