"""PBCH: MIB coding and blind decoding, TS 36.211 §6.6 / TS 36.212 §5.3.1.

Counterpart of `srsran_tpu/phy/phch/pbch.py`: 24-bit MIB + CRC16 (masked
by the antenna-port pattern), K=7 tail-biting conv code, rate matched to
1920 bits (normal CP), scrambled over the 40 ms TTI, QPSK on the central 72
subcarriers of slot-1 symbols 0-3 (4-port CRS positions always reserved).
The encoder is host numpy; `pbch_decode` tries the 4 frame offsets as one
batched Viterbi on the device of its input, then checks the CRC against the
three port masks on the host.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import LTE_CRC16, Cell
from ..crc import crc_compute_np
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx, conv_rm_indices
from ..modem import Mod, demod_soft
from ..sequence import gold_sequence, gold_sequence_signs

PBCH_TTI_BITS = 1920  # normal CP, 40 ms
PBCH_FRAME_BITS = PBCH_TTI_BITS // 4  # 480
PBCH_SYMS_FRAME = PBCH_FRAME_BITS // 2  # 240 QPSK symbols

# TS 36.212 Table 5.3.1.1-1 CRC masks per number of transmit antennas
CRC_MASKS = {1: [0] * 16, 2: [1] * 16, 4: [0, 1] * 8}


@dataclasses.dataclass
class Mib:
    nof_prb: int = 6
    phich_length: int = 0
    phich_resources: int = 1  # index 0..3 → 1/6, 1/2, 1, 2
    sfn: int = 0  # system frame number (full 10 bits; 8 MSBs in the MIB)

    def pack(self) -> np.ndarray:
        bw = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}[self.nof_prb]
        bits = [(bw >> (2 - i)) & 1 for i in range(3)]
        bits += [self.phich_length & 1]
        bits += [(self.phich_resources >> (1 - i)) & 1 for i in range(2)]
        sfn8 = (self.sfn >> 2) & 0xFF
        bits += [(sfn8 >> (7 - i)) & 1 for i in range(8)]
        bits += [0] * 10
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits: np.ndarray) -> "Mib":
        bw = int("".join(map(str, bits[:3])), 2)
        nof_prb = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}[bw]
        phich_len = int(bits[3])
        phich_res = int("".join(map(str, bits[4:6])), 2)
        sfn8 = int("".join(map(str, bits[6:14])), 2)
        return cls(nof_prb, phich_len, phich_res, sfn8 << 2)


@lru_cache(maxsize=128)
def pbch_re_indices(cell: Cell) -> np.ndarray:
    """Flat grid indices of the 240 PBCH REs (slot 1, symbols 0-3, central
    72 subcarriers, 4-port CRS positions skipped in symbols 0-1)."""
    nre = cell.nof_re_per_symbol
    k0 = nre // 2 - 36
    vshift = cell.id % 6
    out = []
    for l in range(4):
        sym = cell.nsymb_per_slot + l
        ks = np.arange(k0, k0 + 72)
        if l < 2:
            ks = ks[(ks % 3) != (vshift % 3)]
        out.append(sym * nre + ks)
    idx = np.concatenate(out).astype(np.int32)
    if len(idx) != PBCH_SYMS_FRAME:
        raise ValueError(f"{len(idx)} PBCH REs, expected {PBCH_SYMS_FRAME}")
    return idx


def pbch_encode_np(mib: Mib, cell: Cell, nof_ports: int) -> np.ndarray:
    """Encode the 40 ms PBCH TTI → (4, 240) complex64 QPSK symbols, one row
    per radio frame (row `sfn % 4`).  Single-port signal."""
    bits = mib.pack()
    crc = crc_compute_np(bits, LTE_CRC16) ^ np.array(CRC_MASKS[nof_ports], np.uint8)
    coded = convcoder_encode_np(np.concatenate([bits, crc]))  # (3, 40)
    e = coded.reshape(-1)[conv_rm_indices(coded.shape[-1], PBCH_TTI_BITS)].astype(np.uint8)
    scrambled = (e ^ gold_sequence(cell.id, PBCH_TTI_BITS)).astype(np.uint8)
    s = (1.0 - 2.0 * scrambled.astype(np.float32)) * np.float32(1.0 / np.sqrt(2.0))
    sym = (s[0::2] + 1j * s[1::2]).astype(np.complex64)
    return sym.reshape(4, PBCH_SYMS_FRAME)


def _pbch_signs(cell_id: int) -> np.ndarray:
    return gold_sequence_signs(cell_id, PBCH_TTI_BITS)


def pbch_decode(sym_eq: torch.Tensor, cell: Cell):
    """Blind MIB decode from ONE frame's 240 equalized PBCH symbols (a
    tensor on any device; the de-rate-match and the Viterbi run there).

    Tries the 4 frame offsets x 3 port counts.  Returns (mib bits (24,)
    uint8, nof_ports, frame offset, ok) on the host."""
    dev = sym_eq.device
    llr = demod_soft(Mod.QPSK, sym_eq)  # (480,)
    full = llr.new_zeros((4, PBCH_TTI_BITS))
    for off in range(4):
        full[off, off * PBCH_FRAME_BITS : (off + 1) * PBCH_FRAME_BITS] = llr
    full = full * table(_pbch_signs, cell.id, device=dev)
    bits = viterbi_decode(conv_rate_match_rx(full, 40), 40).cpu().numpy()  # (4, 40)
    for off in range(4):
        b = bits[off]
        crc_calc = crc_compute_np(b[:24], LTE_CRC16)
        for nports, mask in CRC_MASKS.items():
            if np.array_equal(b[24:] ^ np.array(mask, np.uint8), crc_calc):
                return b[:24], nports, off, True
    return bits[0][:24], 0, 0, False
