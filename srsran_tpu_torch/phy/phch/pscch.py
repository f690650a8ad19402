"""PSCCH: sidelink control channel carrying SCI format 0 (TM1/2) and SCI
format 1 (TM3/4, V2X), TS 36.211 §9.4 / TS 36.212 §5.4.3 (counterpart of
`srsran_tpu/phy/phch/pscch.py`).

TM1/2: one PRB, 12 data symbols budgeted (the last SC-FDMA symbol is
dropped), QPSK; SCI-0 + CRC16 → K=7 TBCC → rate match to E = 288 → C_mux=12
time-first interleaver → scrambling with the fixed seed 510 → 12-point DFT
precoding.  DMRS on symbols 3 and 10: the 1-PRB phi-table base sequence
with u = 0, cyclic shift 0, w = [1, 1].

Host copies: the SCI formats, the DMRS, the encoders.  The receive chain
(`_sl_tbcc_decode`, shared with the PSBCH) runs on the device of the grid
over a batch of hypotheses (PRB starts × DMRS), one Viterbi batch and one
host read; `pscch_search_tm34` puts every subchannel and the four cyclic
shifts of a subframe into that one batch.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..chest.refsignal_ul import base_sequence
from ..common import LTE_CRC16, Cell
from ..crc import crc_compute_np
from ..dft_precoding import dft_precode, dft_predecode
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx, conv_rate_match_tx
from ..modem import Mod, demod_soft, modulate_np
from ..sequence import gold_sequence, gold_sequence_signs
from .pusch import _deinterleaver_indices, _interleaver_indices

SCRAMBLING_SEED = 510
N_DATA_BUDGET = 12
DATA_SYMS = (0, 1, 2, 4, 5, 6, 7, 8, 9, 11, 12)  # transmitted (11 of 12)
DMRS_SYMS = (3, 10)
M_SC = 12
E_BITS = N_DATA_BUDGET * M_SC * 2  # 288


def sci0_riv_nbits(nof_prb: int) -> int:
    return int(math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2)))


def sci0_len(nof_prb: int) -> int:
    return 1 + sci0_riv_nbits(nof_prb) + 7 + 5 + 11 + 8


@dataclasses.dataclass(frozen=True)
class Sci0:
    """SCI format 0 (TS 36.212 §5.4.3.1.1)."""

    riv: int = 0
    trp_idx: int = 0
    mcs_idx: int = 0
    timing_advance: int = 0
    n_sa_id: int = 0
    freq_hopping: bool = False

    def pack(self, nof_prb: int) -> np.ndarray:
        bits = []

        def put(v, n):
            bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

        put(int(self.freq_hopping), 1)
        put(self.riv, sci0_riv_nbits(nof_prb))
        put(self.trp_idx, 7)
        put(self.mcs_idx, 5)
        put(self.timing_advance, 11)
        put(self.n_sa_id, 8)
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits, nof_prb: int) -> "Sci0":
        b = list(map(int, bits))
        pos = 0

        def get(n):
            nonlocal pos
            v = int("".join(map(str, b[pos : pos + n])), 2)
            pos += n
            return v

        fh = bool(get(1))
        return cls(get(sci0_riv_nbits(nof_prb)), get(7), get(5), get(11), get(8), fh)


@lru_cache(maxsize=1)
def pscch_dmrs_np() -> np.ndarray:
    """(2, 12) PSCCH DMRS (chest_sl_pscch_gen TM1/2: u=0, n_cs=0, w=1)."""
    r = base_sequence(0, M_SC)
    return np.stack([r, r]).astype(np.complex64)


def sl_tbcc_encode_np(bits: np.ndarray, e_bits: int, budget: int, seed: int, m_sc: int) -> np.ndarray:
    """CRC16 → TBCC → rate match to e_bits → time-first interleaver (C_mux =
    budget) → scrambling → QPSK → DFT precoding: (budget, m_sc) symbols."""
    crc = crc_compute_np(bits, LTE_CRC16)
    coded = convcoder_encode_np(np.concatenate([bits, crc])).astype(np.float32)
    e = np.asarray(conv_rate_match_tx(coded, e_bits)).astype(np.uint8)
    inter = e[_interleaver_indices(e_bits, 2, c_mux=budget)]
    scr = (inter ^ gold_sequence(seed, e_bits)).astype(np.uint8)
    sym = modulate_np(Mod.QPSK, scr).reshape(budget, m_sc)
    return dft_precode(torch.from_numpy(sym)).numpy()


def pscch_encode_np(sci: Sci0, nof_prb: int) -> np.ndarray:
    """SCI-0 → (11, 12) transmitted SC-FDMA symbols."""
    prec = sl_tbcc_encode_np(sci.pack(nof_prb), E_BITS, N_DATA_BUDGET, SCRAMBLING_SEED, M_SC)
    return prec[: len(DATA_SYMS)]


def put_pscch_np(grid: np.ndarray, cell: Cell, sci: Sci0, prb_idx: int):
    k0 = prb_idx * 12
    sym = pscch_encode_np(sci, cell.nof_prb)
    for i, l in enumerate(DATA_SYMS):
        grid[l, k0 : k0 + M_SC] = sym[i]
    dmrs = pscch_dmrs_np()
    for j, l in enumerate(DMRS_SYMS):
        grid[l, k0 : k0 + M_SC] = dmrs[j]
    return grid


def sl_equalize(grid: torch.Tensor, k0s, dmrs: torch.Tensor, dmrs_syms, data_syms):
    """The DMRS estimate and equalisation shared by the sidelink channels,
    for H hypotheses at once: k0s (H,) first subcarriers, dmrs (H or 1, nd,
    m_sc).  The estimate is the mean of the DMRS symbols' LS values, the
    noise the first symbol's deviation from it.  Returns (eq (H, nt, m_sc),
    empty (H,): no signal at the DMRS, where an all-zero LLR vector would
    trivially pass a CRC)."""
    dev = grid.device
    m_sc = dmrs.shape[-1]
    cols = torch.as_tensor(np.asarray(k0s), device=dev)[:, None] + torch.arange(m_sc, device=dev)
    ls = grid[torch.as_tensor(dmrs_syms, device=dev)[None, :, None], cols[:, None, :]] * torch.conj(dmrs)
    ce = torch.mean(ls, dim=1)  # (H, m_sc)
    empty = torch.mean(torch.abs(ce), dim=-1) < 1e-6
    noise = torch.mean(torch.abs(ls[:, 0] - ce) ** 2, dim=-1)
    y = grid[torch.as_tensor(data_syms, device=dev)[None, :, None], cols[:, None, :]]
    eq = y * torch.conj(ce)[:, None] / (torch.abs(ce) ** 2 + noise[:, None])[:, None]
    return eq, empty


def _sl_tbcc_decode(grid: torch.Tensor, k0s, dmrs: torch.Tensor, dmrs_syms, data_syms,
                    budget: int, seeds, n_bits: int):
    """The sidelink control receive chain for H hypotheses: equalisation,
    IDFT de-precoding, QPSK soft demod, zero LLRs for the budgeted symbols
    never sent, descrambling (by one scrambling seed, or one per
    hypothesis), de-interleaving, de-rate-match, one batched tail-biting
    Viterbi.  One host read: (bits (H, n_bits) uint8, empty (H,) bool)
    numpy."""
    dev = grid.device
    m_sc = dmrs.shape[-1]
    e_bits = budget * m_sc * 2
    eq, empty = sl_equalize(grid, k0s, dmrs, dmrs_syms, data_syms)
    h = eq.shape[0]
    llr_tx = demod_soft(Mod.QPSK, dft_predecode(eq).reshape(h, -1))
    llr = torch.nn.functional.pad(llr_tx, (0, e_bits - llr_tx.shape[-1]))
    seeds = [seeds] if isinstance(seeds, int) else seeds
    llr = llr * torch.stack([table(gold_sequence_signs, sd, e_bits, device=dev) for sd in seeds])
    deinter = llr[:, table(_deinterleaver_indices, e_bits, 2, budget, device=dev, dtype=torch.int64)]
    bits = viterbi_decode(conv_rate_match_rx(deinter, n_bits), n_bits)
    out = torch.cat([bits, empty[:, None].to(torch.uint8)], dim=1).cpu().numpy()
    return out[:, :n_bits], out[:, n_bits].astype(bool)


def crc16_ok(bits: np.ndarray, n: int) -> bool:
    return bool(np.array_equal(bits[n:], crc_compute_np(bits[:n], LTE_CRC16)))


def pscch_decode(grid: torch.Tensor, cell: Cell, prb_idx: int):
    """Try to decode a SCI-0 from `prb_idx` of a (nsymb, nre) grid tensor;
    returns (Sci0, ok)."""
    n = sci0_len(cell.nof_prb)
    bits, empty = _sl_tbcc_decode(grid, [prb_idx * 12], table(pscch_dmrs_np, device=grid.device)[None],
                                  DMRS_SYMS, DATA_SYMS, N_DATA_BUDGET, SCRAMBLING_SEED, n + 16)
    if empty[0]:
        return Sci0(), False
    return Sci0.unpack(bits[0, :n], cell.nof_prb), crc16_ok(bits[0], n)


# --- TM3/4 (V2X) variant ----------------------------------------------------

SCI1_LEN = 32  # SCI format 1 is zero-padded to 32 bits (SRSLTE_SCI_TM34_LEN)
DATA_SYMS_TM34 = (0, 1, 3, 4, 6, 7, 9, 10, 12)  # 9 transmitted of 10 budget
DMRS_SYMS_TM34 = (2, 5, 8, 11)
N_DATA_BUDGET_TM34 = 10
NOF_PRB_TM34 = 2
E_BITS_TM34 = N_DATA_BUDGET_TM34 * NOF_PRB_TM34 * 12 * 2
CYCLIC_SHIFTS_TM34 = (0, 3, 6, 9)


@dataclasses.dataclass(frozen=True)
class Sci1:
    """SCI format 1 (V2X, TS 36.212 §5.4.3.1.2)."""

    priority: int = 0
    resource_reserv: int = 0
    riv: int = 0
    time_gap: int = 0
    mcs_idx: int = 0
    retransmission: bool = False

    @staticmethod
    def riv_nbits(num_sub_channel: int) -> int:
        return int(math.ceil(math.log2(num_sub_channel * (num_sub_channel + 1) / 2)))

    def pack(self, num_sub_channel: int) -> np.ndarray:
        bits = []

        def put(v, n):
            bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

        put(self.priority, 3)
        put(self.resource_reserv, 4)
        put(self.riv, Sci1.riv_nbits(num_sub_channel))
        put(self.time_gap, 4)
        put(self.mcs_idx, 5)
        put(int(self.retransmission), 1)
        bits += [0] * (SCI1_LEN - len(bits))
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits, num_sub_channel: int) -> "Sci1":
        b = list(map(int, bits))
        pos = 0

        def get(n):
            nonlocal pos
            v = int("".join(map(str, b[pos : pos + n])), 2)
            pos += n
            return v

        return cls(get(3), get(4), get(Sci1.riv_nbits(num_sub_channel)), get(4), get(5), bool(get(1)))


@lru_cache(maxsize=8)
def pscch_dmrs_tm34_np(cyclic_shift: int) -> np.ndarray:
    """(4, 24) TM3/4 PSCCH DMRS: u = 8, n_cs = given shift, w = ones."""
    alpha = 2 * np.pi * cyclic_shift / 12
    r = base_sequence(8, NOF_PRB_TM34 * 12) * np.exp(1j * alpha * np.arange(NOF_PRB_TM34 * 12))
    return np.stack([r] * 4).astype(np.complex64)


def _dmrs_tm34_stack(shifts: tuple) -> np.ndarray:
    return np.stack([pscch_dmrs_tm34_np(cs) for cs in shifts])


def _tm34_decode(grid: torch.Tensor, prb_starts, shifts, num_sub_channel: int):
    """Every (PRB start, cyclic shift) pair in one batch: [(prb_start, cs,
    Sci1, crc_bits (16,), ok)] in that order, empty-DMRS pairs not ok."""
    pairs = [(p, cs) for p in prb_starts for cs in shifts]
    dmrs = table(_dmrs_tm34_stack, tuple(shifts), device=grid.device)
    dmrs = dmrs.repeat(len(prb_starts), 1, 1)
    bits, empty = _sl_tbcc_decode(grid, [12 * p for p, _cs in pairs], dmrs, DMRS_SYMS_TM34,
                                  DATA_SYMS_TM34, N_DATA_BUDGET_TM34, SCRAMBLING_SEED, SCI1_LEN + 16)
    out = []
    for (p, cs), b, e in zip(pairs, bits, empty):
        crc_bits = crc_compute_np(b[:SCI1_LEN], LTE_CRC16)
        ok = not e and bool(np.array_equal(b[SCI1_LEN:], crc_bits))
        out.append((p, cs, Sci1() if e else Sci1.unpack(b[:SCI1_LEN], num_sub_channel),
                    np.zeros(16, np.uint8) if e else crc_bits, ok))
    return out


def pscch_decode_tm34(grid: torch.Tensor, cell: Cell, prb_start: int, cyclic_shift: int,
                      num_sub_channel: int):
    """TM3/4 SCI-1 decode from the 2 PSCCH PRBs at `prb_start` under one DMRS
    cyclic shift; returns (Sci1, crc_bits, ok)."""
    _p, _cs, sci, crc_bits, ok = _tm34_decode(grid, [prb_start], (cyclic_shift,), num_sub_channel)[0]
    return sci, crc_bits, ok


def pscch_search_tm34(grid: torch.Tensor, cell: Cell, prb_starts, num_sub_channel: int,
                      shifts=CYCLIC_SHIFTS_TM34):
    """The TM3/4 PSCCH search of a subframe: every PRB start (one per
    subchannel) under the four DMRS cyclic shifts, decoded as one batch with
    one host read.  Returns the CRC-confirmed hits [(prb_start,
    cyclic_shift, Sci1, crc_bits)] in (PRB start, shift) order."""
    return [(p, cs, sci, crc) for p, cs, sci, crc, ok in
            _tm34_decode(grid, list(prb_starts), tuple(shifts), num_sub_channel) if ok]
