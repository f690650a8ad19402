"""NB-IoT broadcast channel: NRS reference signals + NPBCH / MIB-NB,
TS 36.211 §10.2.4/§10.2.6, TS 36.331 MIB-NB (counterpart of
`srsran_tpu/phy/phch/npbch.py`).

MIB-NB (34 bits) + CRC16 → tail-biting convolutional code → rate match to
1600 bits → 8 independently decodable 200-bit sub-blocks, one per 80 ms
(each repeated 8 frames; one repetition is transmitted and decoded).  NPBCH
occupies the 100 REs of symbols 3-13 of subframe 0 that are not NRS
positions (standalone mode).

Host copies: `MibNb`, the NRS positions and sequence, `put_nrs_np`,
`npbch_re_indices`, `npbch_encode_np`.  `nrs_chest` and `npbch_decode` run
on the device of their input: the eight block hypotheses go through one
batched de-rate-match and one batched tail-biting Viterbi.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import LTE_CRC16, MAX_PRB
from ..crc import crc_compute_np
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx, conv_rate_match_tx
from ..modem import Mod, demod_soft, modulate_np
from ..sequence import gold_sequence, gold_sequence_signs

NPBCH_BITS_TOTAL = 1600
NPBCH_BLOCK_BITS = 200  # one 80 ms sub-block
NPBCH_SYMS = 100


@dataclasses.dataclass(frozen=True)
class MibNb:
    """MIB-NB fields (TS 36.331 §6.7.2 MasterInformationBlock-NB subset)."""

    sfn_msb: int = 0  # 4 MSBs of the SFN
    hyper_sfn_lsb: int = 0  # 2 bits
    sib1_sched: int = 0  # 4 bits schedulingInfoSIB1
    sys_info_tag: int = 0  # 5 bits
    access_barring: bool = False
    op_mode: int = 2  # 0=inband-same, 1=inband-diff, 2=guardband, 3=standalone

    def pack(self) -> np.ndarray:
        bits = []

        def put(v, n):
            bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

        put(self.sfn_msb, 4)
        put(self.hyper_sfn_lsb, 2)
        put(self.sib1_sched, 4)
        put(self.sys_info_tag, 5)
        put(int(self.access_barring), 1)
        put(self.op_mode, 2)
        put(0, 16)  # spare + op-mode-info (standalone: spare)
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits) -> "MibNb":
        b = list(map(int, bits))

        def get(pos, n):
            return int("".join(map(str, b[pos : pos + n])), 2)

        return cls(
            sfn_msb=get(0, 4),
            hyper_sfn_lsb=get(4, 2),
            sib1_sched=get(6, 4),
            sys_info_tag=get(10, 5),
            access_barring=bool(get(15, 1)),
            op_mode=get(16, 2),
        )


# --- NRS (narrowband reference signals) ------------------------------------


@lru_cache(maxsize=256)
def nrs_positions(n_id_ncell: int):
    """(syms (4,), freqs (4, 2)): NRS in the last 2 symbols of each slot,
    2 subcarriers each (vshift = ncellid mod 6)."""
    v = n_id_ncell % 6
    syms = np.array([5, 6, 12, 13], np.int32)
    freqs = np.stack([np.array([(0 + v) % 12, (6 + v) % 12]) for _ in range(4)])
    return syms, freqs.astype(np.int32)


@lru_cache(maxsize=512)
def nrs_sequence(n_id_ncell: int, sf_idx: int) -> np.ndarray:
    """(4, 2) NRS values (CRS-style Gold QPSK, m centered for 1 PRB)."""
    out = np.zeros((4, 2), np.complex64)
    for i, (slot_off, lp) in enumerate(((0, 5), (0, 6), (1, 5), (1, 6))):
        ns = 2 * sf_idx + slot_off
        c_init = 1024 * (7 * (ns + 1) + lp + 1) * (2 * n_id_ncell + 1) + 2 * n_id_ncell + 1
        c = gold_sequence(c_init, 4 * MAX_PRB)
        m = np.arange(2) + MAX_PRB - 1
        re = (1.0 - 2.0 * c[2 * m]) * np.sqrt(0.5)
        im = (1.0 - 2.0 * c[2 * m + 1]) * np.sqrt(0.5)
        out[i] = (re + 1j * im).astype(np.complex64)
    return out


def put_nrs_np(grid: np.ndarray, n_id_ncell: int, sf_idx: int):
    syms, freqs = nrs_positions(n_id_ncell)
    seq = nrs_sequence(n_id_ncell, sf_idx)
    for i in range(4):
        grid[syms[i], freqs[i]] = seq[i]
    return grid


def _nrs_tables(n_id_ncell: int, sf_idx: int):
    syms, freqs = nrs_positions(n_id_ncell)
    return (syms.astype(np.int64)[:, None], freqs.astype(np.int64),
            np.conj(nrs_sequence(n_id_ncell, sf_idx)))


def nrs_chest(grid: torch.Tensor, n_id_ncell: int, sf_idx: int):
    """LS estimate at the NRS of a (..., 14, 12) grid, averaged → (ce (...),
    noise (...)) tensors on the grid's device."""
    syms, freqs, ref_conj = table(_nrs_tables, n_id_ncell, sf_idx, device=grid.device)
    ls = grid[..., syms, freqs] * ref_conj  # (..., 4, 2)
    h = torch.mean(ls, dim=(-1, -2))
    noise = torch.mean(torch.abs(ls - h[..., None, None]) ** 2, dim=(-1, -2))
    return h, noise


def nrs_equalize(grid: torch.Tensor, n_id_ncell: int, sf_idx: int, idx: torch.Tensor) -> torch.Tensor:
    """The REs `idx` of a (14, 12) grid equalised by its NRS estimate
    (h* / (|h|² + noise))."""
    h, noise = nrs_chest(grid, n_id_ncell, sf_idx)
    return grid.reshape(-1)[idx] * torch.conj(h) / (torch.abs(h) ** 2 + noise)


# --- NPBCH ------------------------------------------------------------------


@lru_cache(maxsize=64)
def npbch_re_indices(n_id_ncell: int) -> np.ndarray:
    """Flat (l*12 + k) indices of the 100 NPBCH REs (symbols 3-13 minus
    NRS positions, standalone mode)."""
    reserved = np.zeros((14, 12), bool)
    syms, freqs = nrs_positions(n_id_ncell)
    for i in range(4):
        reserved[syms[i], freqs[i]] = True
    # also reserve the mirrored CRS-style positions used in in-band mode
    # (npbch.c always rate-matches around 4 ports worth of RS): 2 more REs
    # in symbols 5,6,12,13 at v+3
    v = n_id_ncell % 6
    for l in (5, 6, 12, 13):
        for k in ((3 + v) % 12, (9 + v) % 12):
            reserved[l, k] = True
    out = []
    for l in range(3, 14):
        ks = np.nonzero(~reserved[l])[0]
        out.append(l * 12 + ks)
    idx = np.concatenate(out).astype(np.int32)
    assert len(idx) >= NPBCH_SYMS
    return idx[:NPBCH_SYMS]


def npbch_encode_np(mib: MibNb, n_id_ncell: int) -> np.ndarray:
    """MIB-NB → (8, 100) QPSK symbol blocks (one row per 80 ms block)."""
    bits = mib.pack()
    crc = crc_compute_np(bits, LTE_CRC16)
    b50 = np.concatenate([bits, crc])
    coded = convcoder_encode_np(b50).astype(np.float32)
    e = np.asarray(conv_rate_match_tx(coded, NPBCH_BITS_TOTAL)).astype(np.uint8)
    seq = gold_sequence(n_id_ncell, NPBCH_BITS_TOTAL)
    scr = (e ^ seq).astype(np.uint8)
    sym = modulate_np(Mod.QPSK, scr)
    return sym.reshape(8, NPBCH_SYMS)


def _block_index() -> np.ndarray:
    """(8, 200): hypothesis b's LLRs land on bits [200 b, 200 b + 200)."""
    return (np.arange(8)[:, None] * NPBCH_BLOCK_BITS + np.arange(NPBCH_BLOCK_BITS)).astype(np.int64)


def npbch_decode(sym_eq: torch.Tensor, n_id_ncell: int):
    """Blind decode from ONE block's 100 equalized symbols (a tensor).

    All 8 block positions go through one batched de-rate-match and Viterbi
    (like pbch.c's frame-offset blindness); one host read of the bits.
    Returns (MibNb, block_idx, ok)."""
    dev = sym_eq.device
    llr = demod_soft(Mod.QPSK, sym_eq)  # (200,)
    full = llr.new_zeros((8, NPBCH_BITS_TOTAL))
    full.scatter_(1, table(_block_index, device=dev), llr.expand(8, -1))
    full = full * table(gold_sequence_signs, n_id_ncell, NPBCH_BITS_TOTAL, device=dev)
    bits = viterbi_decode(conv_rate_match_rx(full, 50), 50).cpu().numpy()
    for blk in range(8):
        b = bits[blk]
        if np.array_equal(b[34:], crc_compute_np(b[:34], LTE_CRC16)):
            return MibNb.unpack(b[:34]), blk, True
    return MibNb(), 0, False
