"""PDSCH: grants, RE mapping, scrambling, host encode and the decode of
the UE facade.

Counterpart of `srsran_tpu/phy/phch/pdsch.py` (FDD and TDD: frame
structure 2's sync positions and the DwPTS data region).  Host
copies: `DlGrant`, `DlGrant2`, `pdsch_re_indices`, `pdsch_nof_re`,
`pdsch_cinit`, `pdsch_encode_np` and `pdsch_encode2_np` (every transmit
scheme).  RE mapping is a host-built flat index table per (cell, sf, cfi,
PRB set); on the device the receive side is one gather with that table.
`pdsch_decode` and `pdsch_decode2` (pdsch.c:785-1007: RE extract →
predecode → layer demap → soft demod with CSI weights → descramble →
`dlsch_decode`) run on the device of the received grid.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import sized_table, table
from ..common import Cell
from ..mimo import (
    layerdemap,
    layermap,
    precode_cdd2,
    precode_diversity2,
    precode_diversity4,
    precode_spatialmux,
    precode_spatialmux4,
    predecode_cdd2,
    predecode_diversity2,
    predecode_diversity4,
    predecode_single_mrc,
    predecode_spatialmux4,
    predecode_zf_mmse,
)
from ..modem import Mod, demod_soft, modulate_np
from ..scrambling import scramble_bits, scramble_soft
from ..sequence import gold_sequence, gold_sequence_signs
from .sch import TbCoding, dlsch_decode, dlsch_encode_np

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
def pdsch_re_indices(cell: Cell, sf_idx: int, cfi: int, prb: tuple[int, ...],
                     tdd: bool = False, last_symbol: int | None = None) -> np.ndarray:
    """Flat indices (symbol*nre + k) of PDSCH REs, in LTE mapping order
    (frequency-first within each symbol, symbols ascending).

    Skips the control region (cfi symbols), CRS of all cell ports, and
    PSS/SSS and PBCH in the central 6 PRB.  ``tdd`` moves the sync signals
    to their frame-structure-2 positions (PSS: symbol 2 of sf 1/6; SSS:
    last symbol of sf 0/5 — TS 36.211 §6.11).  ``last_symbol`` truncates
    the data region for TDD special subframes (DwPTS, ra_dl.c:61-62).
    """
    nre = cell.nof_re_per_symbol
    nsymb = cell.nsymb_per_sf
    if last_symbol is not None:
        nsymb = min(nsymb, last_symbol)
    nctrl = cfi + (1 if cell.nof_prb < 10 else 0)
    vshift = cell.id % 6

    reserved = np.zeros((cell.nsymb_per_sf, nre), bool)
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

    # PSS/SSS: FDD at the end of slot 0 of sf 0/5; TDD PSS on symbol 2 of
    # sf 1/6, SSS on the last symbol of sf 0/5 (TS 36.211 §6.11.1.2,
    # §6.11.2.2).  PBCH in sf 0, slot 1 symbols 0..3.  All on the central
    # 72 REs
    c0 = (cell.nof_prb // 2) * 12 - 36 + (6 * (cell.nof_prb % 2))
    central = np.arange(c0, c0 + 72)
    if not tdd:
        if sf_idx in (0, 5):
            reserved[cell.nsymb_per_slot - 1, central] = True  # PSS
            reserved[cell.nsymb_per_slot - 2, central] = True  # SSS
    else:
        if sf_idx in (1, 6):
            reserved[2, central] = True  # PSS (DwPTS)
        if sf_idx in (0, 5):
            reserved[cell.nsymb_per_sf - 1, central] = True  # SSS
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


def pdsch_nof_re(cell: Cell, sf_idx: int, cfi: int, prb: tuple[int, ...],
                 tdd: bool = False, last_symbol: int | None = None) -> int:
    return len(pdsch_re_indices(cell, sf_idx, cfi, prb, tdd, last_symbol))


# descrambling signs per (c_init, length): one entry per RNTI, subframe and
# grant size in use
_signs_table = sized_table(64)


def _descramble(llr: torch.Tensor, rnti: int, sf_idx: int, cell_id: int, q: int = 0):
    signs = _signs_table(gold_sequence_signs, pdsch_cinit(rnti, sf_idx, cell_id, q),
                         llr.shape[-1], device=llr.device)
    return scramble_soft(llr, signs)


def _extract(rx_grid: torch.Tensor, ce: torch.Tensor, cell: Cell, sf_idx: int, cfi: int, prb,
             tdd: bool = False, last_symbol: int | None = None):
    """(y (nrx, M), h (nrx, nports, M)) at the grant's PDSCH REs."""
    idx = table(pdsch_re_indices, cell, sf_idx, cfi, tuple(prb), tdd, last_symbol,
                device=rx_grid.device, dtype=torch.int64)
    y = rx_grid.reshape(rx_grid.shape[0], -1)[:, idx]
    h = ce.reshape(ce.shape[0], ce.shape[1], -1)[:, :, idx]
    return y, h, idx.numel()


def _soft_bits(mod: Mod, qm: int, sym: torch.Tensor, csi: torch.Tensor) -> torch.Tensor:
    """CSI-weighted LLRs of one codeword's symbols."""
    return demod_soft(mod, sym) * torch.repeat_interleave(csi.to(torch.float32), qm, dim=-1)


def pdsch_decode(rx_grid: torch.Tensor, ce: torch.Tensor, noise_est, cell: Cell, sf_idx: int,
                 cfi: int, grant: DlGrant, max_iterations: int = 5, softbuffers=None,
                 tdd: bool = False, last_symbol: int | None = None):
    """Decode one TB on the device of `rx_grid`.

    rx_grid: (nrx, nsymb, nre) complex64; ce: (nrx, nports, nsymb, nre).
    ``tdd``/``last_symbol`` select frame structure 2's RE map (see
    `pdsch_re_indices`).  Returns (tb_bits (tbs,) uint8 numpy, crc_ok bool,
    softbuffers)."""
    y, h, n_re = _extract(rx_grid, ce, cell, sf_idx, cfi, grant.prb, tdd, last_symbol)
    nof_layers = 1
    if grant.tx_scheme == "port0":
        sym, csi = predecode_single_mrc(y, h[:, 0], noise_est)
    elif grant.tx_scheme == "diversity":
        sym, csi = predecode_diversity2(y, h)
    elif grant.tx_scheme == "diversity4":
        sym, csi = predecode_diversity4(y, h)
    elif grant.tx_scheme in ("cdd", "spatialmux"):
        if grant.tx_scheme == "cdd":
            x, csi = predecode_cdd2(y, h, noise_est)
            nof_layers = 2
        else:
            x, csi = predecode_zf_mmse(y, h, grant.nof_layers, noise_est, pmi=grant.pmi)
            nof_layers = grant.nof_layers
        sym, csi = layerdemap(x, 1)[0], layerdemap(csi, 1)[0]
    else:
        raise NotImplementedError(grant.tx_scheme)
    llr = _descramble(_soft_bits(grant.mod, grant.qm, sym, csi), grant.rnti, sf_idx, cell.id)
    coding = TbCoding(tbs=grant.tbs, g=n_re * grant.qm * nof_layers, qm=grant.qm, rv=grant.rv,
                      nof_layers=nof_layers)
    return dlsch_decode(llr, coding, max_iterations, softbuffers)


def pdsch_encode_np(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant, tb_bits: np.ndarray,
                    tdd: bool = False, last_symbol: int | None = None) -> np.ndarray:
    """Host TX: encode one TB into a (nof_ports, nsymb, nre) complex64 grid
    (no CRS).  ``tdd``/``last_symbol`` select frame structure 2's sync
    positions and the DwPTS data region."""
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb, tdd, last_symbol)
    nof_layers = 1 if grant.tx_scheme in ("diversity", "diversity4") else grant.nof_layers
    coding = TbCoding(tbs=grant.tbs, g=len(idx) * grant.qm * nof_layers, qm=grant.qm,
                      rv=grant.rv, nof_layers=grant.nof_layers)
    bits = dlsch_encode_np(tb_bits, coding)
    seq = gold_sequence(pdsch_cinit(grant.rnti, sf_idx, cell.id), len(bits))
    sym = modulate_np(grant.mod, scramble_bits(bits, seq))
    if grant.tx_scheme == "port0":
        ports = sym[None, :]
    elif grant.tx_scheme == "diversity":
        ports = precode_diversity2(sym)
    elif grant.tx_scheme == "diversity4":
        ports = precode_diversity4(sym)
    elif grant.tx_scheme == "cdd":
        ports = precode_cdd2(layermap([sym], 2))
    elif grant.tx_scheme == "spatialmux":
        ports = precode_spatialmux(layermap([sym], grant.nof_layers), grant.pmi)
    else:
        raise NotImplementedError(grant.tx_scheme)
    grid = np.zeros((ports.shape[0], cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    grid.reshape(ports.shape[0], -1)[:, idx] = ports
    return grid


@dataclasses.dataclass(frozen=True)
class DlGrant2:
    """Two-codeword spatial-multiplexing grant (TM3/TM4, DCI 2/2A)."""

    prb: tuple[int, ...]
    mod1: Mod
    tbs1: int
    mod2: Mod
    tbs2: int
    rv1: int = 0
    rv2: int = 0
    pmi: int = 0  # codebook index (TM4)
    rnti: int = 0x1234
    # "spatialmux" (2-port TM4 codebook) | "cdd" (2-port TM3) |
    # "spatialmux4" (4-port codebook, TS 36.211 Table 6.3.4.2.3-2)
    tx_scheme: str = "spatialmux"
    nof_layers: int = 2  # 2..4 (2 codewords; >2 only with spatialmux4)

    @property
    def qm1(self) -> int:
        return MOD_QM[self.mod1]

    @property
    def qm2(self) -> int:
        return MOD_QM[self.mod2]


def pdsch_encode2_np(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant2,
                     tb1: np.ndarray, tb2: np.ndarray) -> np.ndarray:
    """Host TX of two codewords: each TB through its own DL-SCH chain and
    per-codeword scrambling, then layer mapping and precoding.  Returns a
    (nof_ports, nsymb, nre) complex64 grid (no CRS)."""
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb)
    n_re = len(idx)
    nl = grant.nof_layers if grant.tx_scheme == "spatialmux4" else 2
    nl_cw = (nl // 2, nl - nl // 2)
    cws = []
    for q, (tb, mod, tbs, rv, qm) in enumerate(
            ((tb1, grant.mod1, grant.tbs1, grant.rv1, grant.qm1),
             (tb2, grant.mod2, grant.tbs2, grant.rv2, grant.qm2))):
        coding = TbCoding(tbs=tbs, g=n_re * qm * nl_cw[q], qm=qm, rv=rv, nof_layers=nl_cw[q])
        bits = dlsch_encode_np(tb, coding)
        seq = gold_sequence(pdsch_cinit(grant.rnti, sf_idx, cell.id, q=q), len(bits))
        cws.append(modulate_np(mod, scramble_bits(bits, seq)))
    layers = layermap(cws, nl)
    if grant.tx_scheme == "cdd":
        ports = precode_cdd2(layers)
    elif grant.tx_scheme == "spatialmux4":
        ports = precode_spatialmux4(layers, grant.pmi)
    elif grant.tx_scheme == "spatialmux":
        ports = precode_spatialmux(layers, grant.pmi)
    else:
        raise NotImplementedError(grant.tx_scheme)
    grid = np.zeros((ports.shape[0], cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    grid.reshape(ports.shape[0], -1)[:, idx] = ports
    return grid


def pdsch_decode2(rx_grid: torch.Tensor, ce: torch.Tensor, noise_est, cell: Cell, sf_idx: int,
                  cfi: int, grant: DlGrant2, max_iterations: int = 5, softbuffers=(None, None)):
    """Two-codeword decode on the device of `rx_grid`: MMSE predecode, then
    per codeword layer demap, CSI-weighted soft demod, descramble and
    `dlsch_decode`.  Returns [(tb1, ok1, sb1), (tb2, ok2, sb2)]."""
    y, h, n_re = _extract(rx_grid, ce, cell, sf_idx, cfi, grant.prb)
    nl = grant.nof_layers if grant.tx_scheme == "spatialmux4" else 2
    nl_cw = (nl // 2, nl - nl // 2)
    if grant.tx_scheme == "cdd":
        x, csi = predecode_cdd2(y, h, noise_est)
    elif grant.tx_scheme == "spatialmux4":
        x, csi = predecode_spatialmux4(y, h, nl, grant.pmi, noise_est)
    elif grant.tx_scheme == "spatialmux":
        x, csi = predecode_zf_mmse(y, h, 2, noise_est, pmi=grant.pmi)
    else:
        raise NotImplementedError(grant.tx_scheme)
    sym_cws, csi_cws = layerdemap(x, 2), layerdemap(csi, 2)
    out = []
    for q, (mod, tbs, rv, qm) in enumerate(((grant.mod1, grant.tbs1, grant.rv1, grant.qm1),
                                            (grant.mod2, grant.tbs2, grant.rv2, grant.qm2))):
        llr = _descramble(_soft_bits(mod, qm, sym_cws[q], csi_cws[q]), grant.rnti, sf_idx,
                          cell.id, q)
        coding = TbCoding(tbs=tbs, g=n_re * qm * nl_cw[q], qm=qm, rv=rv, nof_layers=nl_cw[q])
        out.append(dlsch_decode(llr, coding, max_iterations, softbuffers[q]))
    return out
