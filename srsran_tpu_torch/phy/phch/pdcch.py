"""PDCCH: DCI coding, CCE mapping and blind search, TS 36.212 §5.3.3 / TS
36.211 §6.8 / TS 36.213 §9.1.1.

Counterpart of `srsran_tpu/phy/phch/pdcch.py`: DCI bits + CRC16 XOR RNTI →
K=7 tail-biting conv code → rate match to 72·L bits (L CCEs) → QPSK →
control region, on the §6.8.5 REG quadruplet interleaver with the cell-ID
cyclic shift (`regs.py`).  The host side (encode, search space, writer,
candidate extraction) is numpy; `pdcch_blind_search` decodes every
(candidate, L) hypothesis of one RNTI as one batched Viterbi on the device
of its input.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..common import LTE_CRC16, Cell
from ..crc import crc_compute_np
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx_np, conv_rate_match_tx
from ..modem import Mod, demod_soft, modulate_np
from ..sequence import gold_sequence, gold_sequence_signs

CCE_BITS = 72  # 1 CCE = 9 REG = 36 RE = 72 QPSK bits
AGG_LEVELS = (1, 2, 4, 8)
NOF_CANDIDATES_UE = {1: 6, 2: 6, 4: 2, 8: 2}
NOF_CANDIDATES_COMMON = {4: 4, 8: 2}


@lru_cache(maxsize=256)
def pdcch_re_indices(cell: Cell, sf_idx: int, cfi: int) -> np.ndarray:
    """Flat RE indices of the PDCCH in CCE/quadruplet transmit order, the
    PCFICH and PHICH REGs excluded (sf_idx is unused)."""
    from .regs import pdcch_re_indices_true

    return pdcch_re_indices_true(cell, cfi)


def nof_cce(cell: Cell, sf_idx: int, cfi: int) -> int:
    return len(pdcch_re_indices(cell, sf_idx, cfi)) // 36


def pdcch_cinit(rnti_unused: int, sf_idx: int, cell_id: int) -> int:
    """PDCCH scrambling c_init (TS 36.211 §6.8.2): sf << 9 + cell_id."""
    return (sf_idx << 9) + cell_id


def _rnti_mask(rnti: int) -> np.ndarray:
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)


def dci_encode_np(dci_bits: np.ndarray, rnti: int, agg_level: int) -> np.ndarray:
    """DCI payload → 72·L coded bits (before scrambling)."""
    crc = crc_compute_np(dci_bits.astype(np.uint8), LTE_CRC16)
    b = np.concatenate([dci_bits.astype(np.uint8), crc ^ _rnti_mask(rnti)])
    return conv_rate_match_tx(convcoder_encode_np(b), CCE_BITS * agg_level).astype(np.uint8)


def search_space_candidates(rnti: int, sf_idx: int, n_cce: int, ue_specific=True):
    """CCE start indices per aggregation level (TS 36.213 §9.1.1 Y_k hash):
    {L: [cce_start, ...]}, deduplicated, within n_cce."""
    out = {}
    if ue_specific:
        y = rnti
        for _ in range(sf_idx + 1):
            y = (39827 * y) % 65537
        tab = NOF_CANDIDATES_UE
    else:
        y = 0
        tab = NOF_CANDIDATES_COMMON
    for lvl, m_max in tab.items():
        cands = []
        denom = n_cce // lvl
        if denom == 0:
            continue
        for m in range(m_max):
            start = lvl * ((y + m) % denom)
            if start + lvl <= n_cce and start not in cands:
                cands.append(start)
        out[lvl] = cands
    return out


def pdcch_put_np(grid: np.ndarray, cell: Cell, sf_idx: int, cfi: int,
                 dci_bits: np.ndarray, rnti: int, agg_level: int, cce_start: int):
    """Encode, scramble and modulate one DCI into the (nsymb, nre) grid
    ((nports, nsymb, nre) with SFBC for 2+ ports)."""
    coded = dci_encode_np(dci_bits, rnti, agg_level)
    seq = gold_sequence(pdcch_cinit(rnti, sf_idx, cell.id), CCE_BITS * nof_cce(cell, sf_idx, cfi))
    off = cce_start * CCE_BITS
    sym = modulate_np(Mod.QPSK, coded ^ seq[off : off + len(coded)])
    idx = pdcch_re_indices(cell, sf_idx, cfi)
    re_sel = idx[cce_start * 36 : cce_start * 36 + len(sym)]
    if grid.ndim == 3 and grid.shape[0] >= 2:
        from ..mimo import precode_diversity2

        ports = precode_diversity2(sym.astype(np.complex64))
        grid[0].reshape(-1)[re_sel] = ports[0]
        grid[1].reshape(-1)[re_sel] = ports[1]
    else:
        (grid if grid.ndim == 2 else grid[0]).reshape(-1)[re_sel] = sym
    return grid


@lru_cache(maxsize=4096)
def _blind_candidates(rnti: int, sf_idx: int, n: int, ue_specific: bool):
    """UE-specific ∪ common search-space candidates per (rnti, sf_idx, n):
    ((L, (starts...)), ...)."""
    cands = search_space_candidates(rnti, sf_idx, n, ue_specific)
    common = search_space_candidates(rnti, sf_idx, n, ue_specific=False)
    for lvl, starts in common.items():
        for st in starts:
            if st not in cands.setdefault(lvl, []):
                cands[lvl].append(st)
    return tuple((lvl, tuple(starts)) for lvl, starts in cands.items())


@lru_cache(maxsize=4096)
def _blind_signs(rnti: int, sf_idx: int, cell_id: int, nbits: int):
    return gold_sequence_signs(pdcch_cinit(rnti, sf_idx, cell_id), nbits)


def blind_hypotheses(sym_eq: torch.Tensor, cell: Cell, sf_idx: int, cfi: int, rnti: int,
                     dci_len: int, ue_specific: bool = True):
    """The blind search's host part: the LLRs of sym_eq (n_cce·36,) come to
    the host once, descrambled; each candidate of `rnti` (the common search
    space included) is de-rate-matched.  Returns ([(agg_level, cce_start)],
    d-stream LLRs (H, 3, dci_len + 16) float32)."""
    n = nof_cce(cell, sf_idx, cfi)
    llr_all = demod_soft(Mod.QPSK, sym_eq).cpu().numpy()
    llr_all = llr_all * _blind_signs(rnti, sf_idx, cell.id, CCE_BITS * n)[: len(llr_all)]
    d = dci_len + 16
    cands, streams = [], []
    for lvl, starts in _blind_candidates(rnti, sf_idx, n, ue_specific):
        for st in starts:
            cands.append((lvl, st))
            streams.append(conv_rate_match_rx_np(llr_all[st * CCE_BITS : (st + lvl) * CCE_BITS], d))
    return cands, (np.stack(streams) if streams else np.zeros((0, 3, d), np.float32))


def blind_collect(cands, bits: np.ndarray, rnti: int, dci_len: int):
    """[(dci_bits, agg_level, cce_start)] of the decoded hypotheses (H, d)
    whose CRC, masked with `rnti`, checks."""
    mask = _rnti_mask(rnti)
    return [(b[:dci_len], lvl, st) for (lvl, st), b in zip(cands, bits)
            if np.array_equal(b[dci_len:] ^ mask, crc_compute_np(b[:dci_len], LTE_CRC16))]


def pdcch_blind_search(sym_eq: torch.Tensor, cell: Cell, sf_idx: int, cfi: int, rnti: int,
                       dci_len: int, ue_specific: bool = True):
    """Blind-decode every candidate of `rnti` (the common search space
    included): sym_eq (n_cce·36,) equalized PDCCH symbols in transmit order,
    on any device.  The Viterbi runs on that device.  Returns [(dci_bits,
    agg_level, cce_start)] of the candidates that pass the CRC-RNTI check."""
    cands, batch = blind_hypotheses(sym_eq, cell, sf_idx, cfi, rnti, dci_len, ue_specific)
    if not cands:
        return []
    bits = viterbi_decode(torch.from_numpy(batch).to(sym_eq.device), dci_len + 16).cpu().numpy()
    return blind_collect(cands, bits, rnti, dci_len)
