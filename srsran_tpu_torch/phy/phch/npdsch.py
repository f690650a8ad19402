"""NB-IoT downlink shared channel + control: NPDSCH and DCI format N1,
TS 36.211 §10.2.3 / TS 36.212 §6.4.3/§6.3.3.1 (counterpart of
`srsran_tpu/phy/phch/npdsch.py`).

NB-IoT has no turbo code: NPDSCH transport blocks (≤680 bits + CRC24A) go
through the same K=7 tail-biting convolutional code as control channels,
rate-matched to the subframe capacity and QPSK-mapped onto the non-NRS REs;
coverage extension works by subframe repetition.

Host copies: `NB_TBS`, `DciN1`, the RE indices, the c_init rules and the
encoders.  `npdsch_decode` and `npdcch_blind_search` run on the device of
the equalised symbols (soft demod, descrambling, de-rate-match, Viterbi)
and read the decoded bits once for the CRC.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import LTE_CRC16, LTE_CRC24A
from ..crc import crc_compute_np
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx, conv_rate_match_tx
from ..modem import Mod, demod_soft, modulate_np
from ..sequence import gold_sequence, gold_sequence_signs
from .npbch import nrs_positions

# TS 36.213 Table 16.4.1.5.1-1 (i_tbs x i_sf -> TBS bits), subset
NB_TBS = {
    (0, 0): 16, (0, 1): 32, (0, 2): 56, (0, 3): 88,
    (1, 0): 24, (1, 1): 56, (1, 2): 88, (1, 3): 144,
    (2, 0): 32, (2, 1): 72, (2, 2): 144, (2, 3): 176,
    (4, 0): 56, (4, 1): 120, (4, 2): 208, (4, 3): 256,
    (6, 0): 88, (6, 1): 176, (6, 2): 256, (6, 3): 392,
    (8, 0): 120, (8, 1): 256, (8, 2): 392, (8, 3): 536,
    (10, 0): 152, (10, 1): 304, (10, 2): 480, (10, 3): 680,
}
NB_I_SF_TO_N = [1, 2, 3, 4, 5, 6, 8, 10]  # i_sf -> nof subframes


@dataclasses.dataclass
class DciN1:
    """DCI format N1 (NPDSCH scheduling, TS 36.212 §6.4.3.2) — the fields
    driving the anchor-carrier data path."""

    sc_ind: int = 0  # 1 bit (flag format N0/N1)
    delay: int = 0  # 3 bits scheduling delay
    i_sf: int = 0  # 3 bits resource assignment (nof subframes)
    i_tbs: int = 0  # 4 bits MCS/TBS
    i_rep: int = 0  # 4 bits repetition number
    ndi: int = 0
    harq_ack_res: int = 0  # 4 bits

    def pack(self) -> np.ndarray:
        bits = []

        def put(v, n):
            bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

        put(1, 1)  # flag = N1
        put(self.sc_ind, 1)
        put(self.delay, 3)
        put(self.i_sf, 3)
        put(self.i_tbs, 4)
        put(self.i_rep, 4)
        put(self.ndi, 1)
        put(self.harq_ack_res, 4)
        put(0, 2)  # DCI subframe repetition number
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits) -> "DciN1":
        b = list(map(int, bits))
        if b[0] != 1:
            raise ValueError("not format N1")

        def get(pos, n):
            return int("".join(map(str, b[pos : pos + n])), 2)

        return cls(get(1, 1), get(2, 3), get(5, 3), get(8, 4), get(12, 4), get(16, 1), get(17, 4))

    @staticmethod
    def nof_bits() -> int:
        return 23


@lru_cache(maxsize=64)
def npdsch_re_indices(n_id_ncell: int, nof_ctrl: int = 3) -> np.ndarray:
    """Flat (l*12+k) NPDSCH REs of one subframe: symbols nof_ctrl..13
    minus the NRS (+in-band CRS mirror) positions."""
    reserved = np.zeros((14, 12), bool)
    syms, freqs = nrs_positions(n_id_ncell)
    for i in range(4):
        reserved[syms[i], freqs[i]] = True
    v = n_id_ncell % 6
    for l in (5, 6, 12, 13):
        for k in ((3 + v) % 12, (9 + v) % 12):
            reserved[l, k] = True
    out = []
    for l in range(nof_ctrl, 14):
        ks = np.nonzero(~reserved[l])[0]
        out.append(l * 12 + ks)
    return np.concatenate(out).astype(np.int32)


def npdsch_cinit(rnti: int, sf_idx: int, n_id_ncell: int) -> int:
    return (rnti << 15) + ((sf_idx % 10) << 9) + n_id_ncell


def npdsch_encode_np(
    tb_bits: np.ndarray, n_id_ncell: int, rnti: int, i_sf: int, sf_idx0: int = 0
) -> np.ndarray:
    """TB (+CRC24A appended here) → (n_sf, n_re) QPSK symbols over the
    allocated subframes (one repetition)."""
    n_sf = NB_I_SF_TO_N[i_sf]
    idx = npdsch_re_indices(n_id_ncell)
    n_re = len(idx)
    crc = crc_compute_np(tb_bits.astype(np.uint8), LTE_CRC24A)
    b = np.concatenate([tb_bits.astype(np.uint8), crc])
    coded = convcoder_encode_np(b).astype(np.float32)
    g = n_sf * n_re * 2
    e = np.asarray(conv_rate_match_tx(coded, g)).astype(np.uint8)
    out = np.zeros((n_sf, n_re), np.complex64)
    pos = 0
    for s in range(n_sf):
        seq = gold_sequence(npdsch_cinit(rnti, sf_idx0 + s, n_id_ncell), 2 * n_re)
        scr = (e[pos : pos + 2 * n_re] ^ seq).astype(np.uint8)
        out[s] = modulate_np(Mod.QPSK, scr)
        pos += 2 * n_re
    return out


def _npdsch_signs(n_id_ncell: int, rnti: int, n_sf: int, n_re: int, sf_idx0: int) -> np.ndarray:
    return np.concatenate([gold_sequence_signs(npdsch_cinit(rnti, sf_idx0 + s, n_id_ncell), 2 * n_re)
                           for s in range(n_sf)])


def _tbcc_decode(llr: torch.Tensor, n: int) -> np.ndarray:
    """LLRs (e,) → the n decoded bits of the tail-biting code, on the host."""
    return viterbi_decode(conv_rate_match_rx(llr, n)[None], n)[0].cpu().numpy()


def npdsch_decode(
    sym_eq: torch.Tensor, n_id_ncell: int, rnti: int, i_sf: int, tbs: int, sf_idx0: int = 0
):
    """(n_sf, n_re) equalized symbols (a tensor) → (tb_bits (tbs,) uint8
    numpy, crc_ok)."""
    n_sf = NB_I_SF_TO_N[i_sf]
    n_re = sym_eq.shape[-1]
    e = demod_soft(Mod.QPSK, sym_eq[:n_sf].reshape(-1))
    e = e * table(_npdsch_signs, n_id_ncell, rnti, n_sf, n_re, sf_idx0, device=sym_eq.device)
    bits = _tbcc_decode(e, tbs + 24)
    ok = np.array_equal(bits[tbs:], crc_compute_np(bits[:tbs], LTE_CRC24A))
    return bits[:tbs], ok


# --- NPDCCH -----------------------------------------------------------------

NPDCCH_FMT1_BITS = 23  # DCI N1/N2 size


def npdcch_cinit(sf_idx: int, n_id_ncell: int) -> int:
    """TS 36.211 §10.2.5.2 (search-space scrambling)."""
    return ((sf_idx % 10) << 9) + n_id_ncell


def _rnti_mask(rnti: int) -> np.ndarray:
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)


def npdcch_encode_np(dci_bits: np.ndarray, rnti: int, n_id_ncell: int, sf_idx: int) -> np.ndarray:
    """One aggregation-level-2 (full-subframe) NPDCCH candidate → (n_re,)
    QPSK symbols (npdcch.c encode path)."""
    idx = npdsch_re_indices(n_id_ncell)
    n_re = len(idx)
    crc = crc_compute_np(dci_bits.astype(np.uint8), LTE_CRC16)
    b = np.concatenate([dci_bits.astype(np.uint8), crc ^ _rnti_mask(rnti)])
    coded = convcoder_encode_np(b).astype(np.float32)
    e = np.asarray(conv_rate_match_tx(coded, 2 * n_re)).astype(np.uint8)
    seq = gold_sequence(npdcch_cinit(sf_idx, n_id_ncell), 2 * n_re)
    return modulate_np(Mod.QPSK, (e ^ seq).astype(np.uint8))


def npdcch_blind_search(sym_eq: torch.Tensor, rnti: int, n_id_ncell: int, sf_idx: int):
    """Decode the aggregation-2 candidate from its (n_re,) equalized symbols
    (a tensor); returns DciN1 or None (npdcch.c srslte_npdcch_decode_msg:
    CRC-RNTI confirms)."""
    n_re = sym_eq.shape[-1]
    llr = demod_soft(Mod.QPSK, sym_eq) * table(
        gold_sequence_signs, npdcch_cinit(sf_idx, n_id_ncell), 2 * n_re, device=sym_eq.device)
    bits = _tbcc_decode(llr, NPDCCH_FMT1_BITS + 16)
    if not np.array_equal(bits[NPDCCH_FMT1_BITS:] ^ _rnti_mask(rnti),
                          crc_compute_np(bits[:NPDCCH_FMT1_BITS], LTE_CRC16)):
        return None
    try:
        return DciN1.unpack(bits[:NPDCCH_FMT1_BITS])
    except ValueError:
        return None
