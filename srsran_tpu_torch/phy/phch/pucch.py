"""PUCCH formats 1/1a/1b (SR, ACK/NACK), 2/2a/2b (CQI) and 3 (multi-ACK),
TS 36.211 §5.4 / §5.4.2A.

Counterpart of `srsran_tpu/phy/phch/pucch.py`: length-12 cyclically
shifted base sequences, per-symbol cell-specific shift hopping (ncs_cell
from the cell Gold sequence), orthogonal covers for format 1, RM(20,A)-coded
QPSK for format 2, block-spread DFT-S-OFDM with RM(32,O) (single or dual)
for format 3, band-edge PRB mapping with slot hopping, and the TDD
channel-selection tables.  Encoders and the format-1 decode are host numpy,
as in the reference; the format 2, 2a/2b and 3 decodes are torch on the
device of the received PRB grid.

Scope: normal CP, no SRS shortening, single antenna.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..chest.refsignal_ul import base_sequence
from ..common import Cell
from ..modem import Mod, demod_soft, modulate_np
from ..sequence import gold_sequence
from .uci import rm_decode, rm_encode
from .uci_data import RM20_BASIS

# format 1 / format 2: data and DMRS symbol positions within a slot,
# per cyclic prefix (TS 36.211 Tables 5.4.1-2 / 5.4.2-1; pucch.c)
def _f1_syms(cell: Cell):
    if cell.nsymb_per_slot == 7:
        return (0, 1, 5, 6), (2, 3, 4)
    return (0, 1, 4, 5), (2, 3)


def _f2_syms(cell: Cell):
    if cell.nsymb_per_slot == 7:
        return (0, 2, 3, 4, 6), (1, 5)
    return (0, 1, 2, 4, 5), (3,)


# normal-CP aliases (kept for external callers)
F1_DATA_SYMS = (0, 1, 5, 6)
F1_DMRS_SYMS = (2, 3, 4)
F2_DATA_SYMS = (0, 2, 3, 4, 6)
F2_DMRS_SYMS = (1, 5)

# orthogonal covers for format 1 (length 4, TS 36.211 Table 5.4.1-2)
W4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, -1, -1, 1]], np.float32)
# DMRS covers length 3 (Table 5.5.2.2.1-2) and length 2 (extended CP)
W3 = np.exp(
    2j * np.pi / 3 * np.array([[0, 0, 0], [0, 1, 2], [0, 2, 1]], np.float64)
).astype(np.complex64)
W2 = np.array([[1, 1], [1, -1]], np.complex64)


def _f1_covers(cell: Cell) -> int:
    """Format-1 cover count c: 3 (normal CP) or 2 (extended CP,
    Table 5.4.3-1)."""
    return 3 if cell.nsymb_per_slot == 7 else 2


@lru_cache(maxsize=256)
def ncs_cell(cell: Cell) -> np.ndarray:
    """Cell-specific cyclic-shift hopping table (20 slots, nsymb
    symbols): ncs(ns, l) = sum 2^i c(8*(nsymb*ns+l)+i) (TS 36.211 §5.4)."""
    nsym = cell.nsymb_per_slot
    c = gold_sequence(cell.id, 8 * nsym * 20)
    out = np.zeros((20, nsym), np.int32)
    for ns in range(20):
        for l in range(nsym):
            idx = 8 * (nsym * ns + l)
            out[ns, l] = int(sum(c[idx + i] << i for i in range(8)))
    return out


def pucch_prb(m: int, ns: int, nof_prb: int) -> int:
    """Band-edge PRB with slot hopping (TS 36.211 §5.4.3)."""
    if (m + ns) % 2 == 0:
        return m // 2
    return nof_prb - 1 - m // 2


@dataclasses.dataclass(frozen=True)
class PucchConfig:
    n_pucch: int = 0  # resource index
    delta_shift: int = 2


def pucch_f1_prb(n_pucch: int, ns: int, nof_prb: int, delta_shift: int = 2,
                 covers: int = 3) -> int:
    """PRB of a format-1 resource: 12/Δ · c resources share one PRB
    (c = 3 normal CP, 2 extended) before spilling to the next one
    (TS 36.211 §5.4.3 m formula with N(2)_RB = 0)."""
    per_prb = (12 // delta_shift) * covers
    return pucch_prb(n_pucch // per_prb, ns, nof_prb)


def _f1_alpha_cover(cell: Cell, cfg: PucchConfig, ns: int):
    """Per-symbol cyclic shifts + cover index for format 1 (simplified
    in-PRB resource mapping: 6 shifts × c covers orthogonal resources;
    the (shift, cover) pair is unique for n_pucch % (6·c))."""
    shifts = []
    ncs = ncs_cell(cell)
    c = _f1_covers(cell)
    n = cfg.n_pucch % (6 * c)
    base_shift = (n * cfg.delta_shift) % 12
    for l in range(cell.nsymb_per_slot):
        shifts.append((base_shift + ncs[ns, l]) % 12)
    cover = n // 6
    return shifts, cover


# --- TDD HARQ-ACK multiplexing with channel selection -----------------------
# TS 36.213 Tables 10.1.3-2/3/4, mirrored row-for-row from the reference's
# get_npucch_tdd (pucch_proc.c:470-585).  States: 1=ACK, 0=NACK, 2=DTX;
# "ND" matches NACK or DTX.
ACK, NACK, DTX = 1, 0, 2
_CS_ROWS = {
    2: [
        (("A", "A"), 3, 1), (("A", "ND"), 1, 0), (("ND", "A"), 0, 1),
        (("ND", "N"), 2, 1), (("N", "D"), 2, 0),
    ],
    3: [
        (("A", "A", "A"), 3, 2), (("A", "A", "ND"), 3, 1), (("A", "ND", "A"), 3, 0),
        (("A", "ND", "ND"), 1, 0), (("ND", "A", "A"), 2, 2), (("ND", "A", "ND"), 0, 1),
        (("ND", "ND", "A"), 0, 2), (("D", "D", "N"), 1, 2), (("D", "N", "ND"), 2, 1),
        (("N", "ND", "ND"), 2, 0),
    ],
    4: [
        (("A", "A", "A", "A"), 3, 1), (("A", "A", "A", "ND"), 2, 1),
        (("ND", "ND", "N", "D"), 3, 2), (("A", "A", "ND", "A"), 2, 1),
        (("N", "D", "D", "D"), 2, 0), (("A", "A", "ND", "ND"), 2, 1),
        (("A", "ND", "A", "A"), 1, 3), (("ND", "ND", "ND", "N"), 3, 3),
        (("A", "ND", "A", "N"), 2, 1), (("A", "ND", "ND", "A"), 1, 0),
        (("A", "ND", "ND", "ND"), 3, 0), (("ND", "A", "A", "A"), 1, 3),
        (("ND", "N", "D", "D"), 0, 1), (("ND", "A", "A", "ND"), 2, 2),
        (("ND", "A", "ND", "A"), 2, 3), (("ND", "A", "ND", "ND"), 1, 1),
        (("ND", "ND", "A", "A"), 1, 3), (("ND", "ND", "A", "ND"), 0, 2),
        (("ND", "ND", "ND", "A"), 0, 3),
    ],
}


def _cs_match(cond: str, state: int) -> bool:
    return {"A": state == ACK, "N": state == NACK, "D": state == DTX,
            "ND": state in (NACK, DTX)}[cond]


def tdd_channel_selection(states: list[int]) -> tuple[int, tuple[int, int]]:
    """HARQ-ACK multiplexing: M∈{1..4} ACK/NACK/DTX states → (resource
    index, (b0, b1)) for PUCCH format 1b with channel selection."""
    m = len(states)
    if m == 1:
        return 0, (states[0] == ACK, 0)
    for conds, b01, res in _CS_ROWS[m]:
        if all(_cs_match(c, s) for c, s in zip(conds, states)):
            return res, (b01 >> 1, b01 & 1)
    return 0, (0, 0)  # all-DTX-like: nothing to send (caller may skip)


@lru_cache(maxsize=8)
def _cs_decode_table(m: int):
    """(res, b01) → per-subframe ACK booleans.

    The spec tables are NOT injective (several state patterns share one
    constellation point — a known property of TDD channel selection), so
    the decoder takes the INTERSECTION of ACK positions over all rows
    mapping to the point: a position reads ACK only when every candidate
    pattern agrees.  An uncertain ACK decodes as NACK → a spurious
    retransmission, never a false delivery."""
    table: dict = {}
    for conds, b01, res in _CS_ROWS[m]:
        key = (res, b01)
        mask = tuple(c == "A" for c in conds)
        if key in table:
            table[key] = tuple(a and b for a, b in zip(table[key], mask))
        else:
            table[key] = mask
    return table


def tdd_channel_selection_decode(res: int, b0: int, b1: int, m: int) -> tuple[bool, ...]:
    return _cs_decode_table(m).get((res, 2 * b0 + b1), (False,) * m)


def pucch_format1_encode_np(cell: Cell, cfg: PucchConfig, sf_idx: int, bits) -> np.ndarray:
    """Format 1/1a/1b: 0 (SR), 1 or 2 bits → (nsymb_sf, 12) PRB-local grid.

    Caller places the 12 subcarriers at `pucch_prb(...)` per slot.
    """
    bits = np.asarray(bits, np.uint8)
    if len(bits) == 0:
        d = np.complex64(1.0)
    elif len(bits) == 1:
        d = modulate_np(Mod.BPSK, bits)[0]
    else:
        d = modulate_np(Mod.QPSK, bits)[0]
    u = cell.id % 30
    r = base_sequence(u, 12)
    out = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    n = np.arange(12)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f1_syms(cell)
    wd = W3 if nsym == 7 else W2  # DMRS cover length tracks N_RS per CP
    c = _f1_covers(cell)
    for slot in range(2):
        ns = 2 * sf_idx + slot
        shifts, cover = _f1_alpha_cover(cell, cfg, ns)
        for i, l in enumerate(data_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            out[slot * nsym + l] = d * W4[cover % c, i] * r * np.exp(1j * alpha * n)
        for i, l in enumerate(dmrs_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            out[slot * nsym + l] = wd[cover % c, i] * r * np.exp(1j * alpha * n)
    return out


def pucch_format1_decode(prb_grid, cell: Cell, cfg: PucchConfig, sf_idx: int, nof_bits: int):
    """(nsymb_sf, 12) received PRB-local grid → (bits, detection_metric).

    Coherent: channel from the DMRS symbols, then despread data symbols.
    """
    u = cell.id % 30
    r = np.asarray(base_sequence(u, 12))
    n = np.arange(12)
    grid = np.asarray(prb_grid)
    est = []
    data = []
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f1_syms(cell)
    wd = W3 if nsym == 7 else W2
    c = _f1_covers(cell)
    # pure numpy: (nsymb, 12) host math — an eager-JAX version of this
    # cost ~11 ms/call in per-op dispatch on the full-stack control path
    for slot in range(2):
        ns = 2 * sf_idx + slot
        shifts, cover = _f1_alpha_cover(cell, cfg, ns)
        h_acc = 0.0
        for i, l in enumerate(dmrs_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            ref = np.exp(1j * alpha * n).astype(np.complex64) * r * wd[cover % c, i]
            h_acc = h_acc + np.sum(grid[slot * nsym + l] * np.conj(ref))
        h = h_acc / (len(dmrs_syms) * 12)
        for i, l in enumerate(data_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            ref = np.exp(1j * alpha * n).astype(np.complex64) * r * np.float32(W4[cover % c, i])
            z = np.sum(grid[slot * nsym + l] * np.conj(ref)) / 12
            data.append(z * np.conj(h) / (np.abs(h) ** 2 + 1e-9))
        est.append(np.abs(h) ** 2)
    d = np.mean(np.stack(data))
    # DTX metric: DMRS correlation-energy ratio (see original comment)
    metric = np.sum(np.stack(est)) / (np.mean(np.abs(grid) ** 2) + 1e-12)
    if nof_bits == 0:
        return np.zeros(0, np.uint8), metric
    if nof_bits == 1:
        return np.asarray([np.real(d) + np.imag(d) < 0], np.uint8), metric
    b0 = np.uint8(np.real(d) < 0)
    b1 = np.uint8(np.imag(d) < 0)
    return np.stack([b0, b1]), metric


def pucch_format2_encode_np(cell: Cell, cfg: PucchConfig, sf_idx: int, uci_bits) -> np.ndarray:
    """Format 2: ≤13 CQI bits → (nsymb_sf, 12) PRB-local grid."""
    coded = rm_encode(np.asarray(uci_bits, np.uint8), 20, RM20_BASIS)
    seq = gold_sequence((((sf_idx * 2 + 1) * (2 * cell.id + 1)) << 9) + cell.id, 20)
    d = modulate_np(Mod.QPSK, coded ^ seq)
    u = cell.id % 30
    r = base_sequence(u, 12)
    out = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    n = np.arange(12)
    ncs = ncs_cell(cell)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f2_syms(cell)
    k = 0
    for slot in range(2):
        ns = 2 * sf_idx + slot
        for l in data_syms:
            alpha = 2 * np.pi * ((cfg.n_pucch + ncs[ns, l]) % 12) / 12
            out[slot * nsym + l] = d[k] * r * np.exp(1j * alpha * n)
            k += 1
        for l in dmrs_syms:
            alpha = 2 * np.pi * ((cfg.n_pucch + ncs[ns, l]) % 12) / 12
            out[slot * nsym + l] = r * np.exp(1j * alpha * n)
    return out


def _f2_refs_conj(cell: Cell, n_pucch: int, sf_idx: int) -> np.ndarray:
    """(nsymb_sf, 12) complex64 conjugated format-2 references (cyclic shift
    per symbol times the base sequence) of one (resource, subframe)."""
    r = base_sequence(cell.id % 30, 12)
    n = np.arange(12)
    ncs = ncs_cell(cell)
    nsym = cell.nsymb_per_slot
    out = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    for slot in range(2):
        for l in range(nsym):
            alpha = 2 * np.pi * ((n_pucch + ncs[2 * sf_idx + slot, l]) % 12) / 12
            out[slot * nsym + l] = np.conj(np.exp(1j * alpha * n).astype(np.complex64) * r)
    return out


def _f2_scramble_signs(cell: Cell, sf_idx: int) -> np.ndarray:
    seq = gold_sequence((((sf_idx * 2 + 1) * (2 * cell.id + 1)) << 9) + cell.id, 20)
    return (1.0 - 2.0 * seq).astype(np.float32)


def pucch_format2_decode(prb_grid: torch.Tensor, cell: Cell, cfg: PucchConfig, sf_idx: int,
                         nof_bits: int):
    """(nsymb_sf, 12) received grid (a tensor on any device) → (uci bits,
    metric): coherent per-slot channel from the DMRS, despread, RM(20,A)
    ML decode."""
    dev = prb_grid.device
    refc = table(_f2_refs_conj, cell, cfg.n_pucch, sf_idx, device=dev)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f2_syms(cell)
    corr = torch.sum(prb_grid * refc, dim=-1)  # (nsymb_sf,)
    zs = []
    for slot in range(2):
        h = sum(corr[slot * nsym + l] for l in dmrs_syms) / (len(dmrs_syms) * 12)
        for l in data_syms:
            z = corr[slot * nsym + l] / 12
            zs.append(z * torch.conj(h) / (torch.abs(h) ** 2 + 1e-9))
    llr = demod_soft(Mod.QPSK, torch.stack(zs))  # (20,)
    llr = llr * table(_f2_scramble_signs, cell, sf_idx, device=dev)
    return rm_decode(llr, nof_bits, use20=True)


def pucch_format2ab_encode_np(
    cell: Cell, cfg: PucchConfig, sf_idx: int, uci_bits, ack_bits
) -> np.ndarray:
    """Formats 2a/2b (TS 36.211 §5.4.2, pucch.c): CQI as format 2 plus 1-2
    HARQ-ACK bits BPSK/QPSK-modulated onto the second DMRS symbol of each
    slot."""
    assert cell.nsymb_per_slot == 7, (
        "formats 2a/2b exist only for normal CP (TS 36.211 Table 5.4-1; "
        "extended CP joint-codes HARQ-ACK with the CQI on format 2)")
    out = pucch_format2_encode_np(cell, cfg, sf_idx, uci_bits).copy()
    ack = np.asarray(ack_bits, np.uint8)
    if len(ack) == 1:  # 2a: BPSK
        d_ack = np.complex64(1.0 if ack[0] == 0 else -1.0)
    else:  # 2b: QPSK
        mapping = {(0, 0): 1, (0, 1): -1j, (1, 0): 1j, (1, 1): -1}
        d_ack = np.complex64(mapping[(int(ack[0]), int(ack[1]))])
    second_dmrs = F2_DMRS_SYMS[1]
    for slot in range(2):
        out[slot * 7 + second_dmrs] *= d_ack
    return out


def pucch_format2ab_decode(prb_grid: torch.Tensor, cell: Cell, cfg: PucchConfig, sf_idx: int,
                           nof_cqi_bits: int, nof_ack_bits: int):
    """(nsymb_sf, 12) received grid (a tensor on any device) → (cqi bits,
    ack bits (numpy), metric): the ACK from the second DMRS symbol against
    the first, then the format-2 CQI decode with the ACK rotation undone."""
    refc = table(_f2_refs_conj, cell, cfg.n_pucch, sf_idx, device=prb_grid.device)
    first, second = F2_DMRS_SYMS
    acc = 0.0
    for slot in range(2):
        h = torch.sum(prb_grid[slot * 7 + first] * refc[slot * 7 + first]) / 12
        z = torch.sum(prb_grid[slot * 7 + second] * refc[slot * 7 + second]) / 12
        acc = acc + z * torch.conj(h)
    re, im = float(acc.real), float(acc.imag)
    if nof_ack_bits == 1:
        ack = np.array([1 if re < 0 else 0], np.uint8)
    else:
        # constellation: (0,0)->1, (0,1)->-j, (1,0)->+j, (1,1)->-1
        cands = {(0, 0): 1 + 0j, (0, 1): -1j, (1, 0): 1j, (1, 1): -1 + 0j}
        best = max(cands, key=lambda b: re * cands[b].real + im * cands[b].imag)
        ack = np.array(best, np.uint8)
    mapping = {(0,): 1, (1,): -1, (0, 0): 1, (0, 1): -1j, (1, 0): 1j, (1, 1): -1}
    d = np.complex64(mapping[tuple(int(b) for b in ack)])
    grid2 = prb_grid.clone()
    for slot in range(2):
        grid2[slot * 7 + second] *= complex(np.conj(d))
    cqi, metric = pucch_format2_decode(grid2, cell, cfg, sf_idx, nof_cqi_bits)
    return cqi, ack, metric


# ---------------------------------------------------------------------------
# Format 3 (block-spread DFT-S-OFDM, up to 21 HARQ-ACK/SR bits)
# ---------------------------------------------------------------------------

# length-5 DFT orthogonal covers w_noc(i) = exp(j2*pi*noc*i/5)
# (TS 36.211 Table 5.4.2A-1)
_W5 = np.exp(2j * np.pi / 5 * np.outer(np.arange(5), np.arange(5))).astype(np.complex64)
F3_DATA_SYMS = (0, 2, 3, 4, 6)
F3_DMRS_SYMS = (1, 5)


def _f3_coded_bits(uci_bits: np.ndarray) -> np.ndarray:
    """48 coded bits: single RM(32,O) circularly repeated for O<=11, else
    dual RM(32,.) with QPSK-pair interleaving (TS 36.212 §5.2.3.1)."""
    o = len(uci_bits)
    if o <= 11:
        return rm_encode(uci_bits, 48)
    # dual RM: split, encode each half to 24 bits, interleave in pairs
    o1 = (o + 1) // 2
    q1 = rm_encode(uci_bits[:o1], 24)
    q2 = rm_encode(uci_bits[o1:], 24)
    out = np.zeros(48, np.uint8)
    for k in range(12):
        out[4 * k : 4 * k + 2] = q1[2 * k : 2 * k + 2]
        out[4 * k + 2 : 4 * k + 4] = q2[2 * k : 2 * k + 2]
    return out


def _f3_scramble_seq(cell: Cell, sf_idx: int, rnti: int) -> np.ndarray:
    return gold_sequence(((sf_idx + 1) * (2 * cell.id + 1) << 16) + rnti, 48)


def _f3_noc(cfg: PucchConfig, slot: int) -> int:
    """Orthogonal-cover index per slot from the format-3 resource index
    (TS 36.211 §5.4.2A: n_oc0 = n_pucch mod 5, n_oc1 = (3*n_oc0) mod 5)."""
    noc0 = cfg.n_pucch % 5
    return noc0 if slot == 0 else (3 * noc0) % 5


def pucch_format3_encode_np(
    cell: Cell, cfg: PucchConfig, sf_idx: int, uci_bits, rnti: int = 0
) -> np.ndarray:
    """Format 3: O <= 21 UCI bits → (nsymb_sf, 12) PRB-local grid.

    48 coded bits → scramble → QPSK → 12 symbols per slot, DFT-precoded and
    block-spread over the 5 data SC-FDMA symbols with a length-5 cover."""
    uci_bits = np.asarray(uci_bits, np.uint8)
    coded = _f3_coded_bits(uci_bits) ^ _f3_scramble_seq(cell, sf_idx, rnti)
    d = modulate_np(Mod.QPSK, coded)  # (24,)
    u = cell.id % 30
    r = base_sequence(u, 12)
    ncs = ncs_cell(cell)
    n = np.arange(12)
    out = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    for slot in range(2):
        ns = 2 * sf_idx + slot
        noc = _f3_noc(cfg, slot)
        blk = d[slot * 12 : (slot + 1) * 12]
        y = np.fft.fft(blk) / np.sqrt(12)  # DFT precoding
        for i, l in enumerate(F3_DATA_SYMS):
            # quaternary per-symbol phase from the cell shift table
            phase = np.exp(1j * np.pi * (ncs[ns, l] // 64) / 2)
            out[slot * 7 + l] = _W5[noc, i] * phase * y
        for i, l in enumerate(F3_DMRS_SYMS):
            alpha = 2 * np.pi * ((ncs[ns, l] + noc) % 12) / 12
            out[slot * 7 + l] = r * np.exp(1j * alpha * n)
    return out


def _f3_refs(cell: Cell, n_pucch: int, sf_idx: int):
    """Format-3 references of one (resource, subframe): the conjugated DMRS
    (2, 2, 12) [slot, DMRS symbol, subcarrier] and the conjugated data
    covers (2, 5) [slot, data symbol]."""
    cfg = PucchConfig(n_pucch=n_pucch)
    r = base_sequence(cell.id % 30, 12)
    ncs = ncs_cell(cell)
    n = np.arange(12)
    dmrs = np.zeros((2, len(F3_DMRS_SYMS), 12), np.complex64)
    cover = np.zeros((2, len(F3_DATA_SYMS)), np.complex64)
    for slot in range(2):
        ns = 2 * sf_idx + slot
        noc = _f3_noc(cfg, slot)
        for i, l in enumerate(F3_DMRS_SYMS):
            alpha = 2 * np.pi * ((ncs[ns, l] + noc) % 12) / 12
            dmrs[slot, i] = np.conj(np.exp(1j * alpha * n).astype(np.complex64) * r)
        for i, l in enumerate(F3_DATA_SYMS):
            phase = np.exp(1j * np.pi * (int(ncs[ns, l]) // 64) / 2)
            cover[slot, i] = np.conj(_W5[noc, i] * phase)
    return dmrs, cover


def _f3_signs(cell: Cell, sf_idx: int, rnti: int) -> np.ndarray:
    return (1.0 - 2.0 * _f3_scramble_seq(cell, sf_idx, rnti)).astype(np.float32)


def pucch_format3_decode(prb_grid: torch.Tensor, cell: Cell, cfg: PucchConfig, sf_idx: int,
                         nof_bits: int, rnti: int = 0):
    """(nsymb_sf, 12) received grid (a tensor on any device) → (uci bits,
    metric): per-subcarrier channel from the DMRS, despread over the cover,
    equalize, undo the DFT precoding, RM(32,O) (dual above 11 bits)."""
    dev = prb_grid.device
    dmrs, cover = table(_f3_refs, cell, cfg.n_pucch, sf_idx, device=dev)
    llrs = []
    for slot in range(2):
        h = sum(prb_grid[slot * 7 + l] * dmrs[slot, i] for i, l in enumerate(F3_DMRS_SYMS)) / 2
        z = sum(prb_grid[slot * 7 + l] * cover[slot, i] for i, l in enumerate(F3_DATA_SYMS)) / 5
        eq = z * torch.conj(h) / (torch.abs(h) ** 2 + 1e-9)
        blk = torch.fft.ifft(eq) * float(np.sqrt(np.float32(12.0)))  # undo DFT precoding
        llrs.append(demod_soft(Mod.QPSK, blk))
    llr = torch.cat(llrs) * table(_f3_signs, cell, sf_idx, rnti, device=dev)  # (48,)
    if nof_bits <= 11:
        return rm_decode(llr, nof_bits)
    o1 = (nof_bits + 1) // 2
    idx1 = torch.from_numpy(np.concatenate([[4 * k, 4 * k + 1] for k in range(12)])).to(dev)
    b1, m1 = rm_decode(llr[idx1], o1)
    b2, m2 = rm_decode(llr[idx1 + 2], nof_bits - o1)
    return torch.cat([b1, b2]), (m1 + m2) / 2
