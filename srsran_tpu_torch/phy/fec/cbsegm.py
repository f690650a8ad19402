"""Code block segmentation, TS 36.212 §5.1.2, and the QPP turbo
interleaver (Table 5.1.3-3) — host side.

Copy of `srsran_tpu/phy/fec/cbsegm.py` (pure numpy): segmentation shapes
the static structure of a transport block, so it is known before any
device work.  Tests hold it equal to the reference over all 188 K.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property, lru_cache
from typing import NamedTuple

import numpy as np

from ..common import LTE_CRC24A, LTE_CRC24B

# TS 36.212 Table 5.1.3-3: K from 40 to 6144
# 40..512 step 8, 528..1024 step 16, 1056..2048 step 32, 2112..6144 step 64
CB_SIZES: tuple[int, ...] = tuple(
    list(range(40, 513, 8))
    + list(range(528, 1025, 16))
    + list(range(1056, 2049, 32))
    + list(range(2112, 6145, 64))
)
NOF_CB_SIZES = len(CB_SIZES)  # 188

# QPP interleaver parameters f1, f2 per CB size (TS 36.212 Table 5.1.3-3)
F1 = (
    3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57, 23, 13,
    27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21, 115, 193, 21, 133, 81,
    45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29, 247, 29, 89, 91, 157, 55, 31, 17, 35, 227,
    65, 19, 37, 41, 39, 185, 43, 21, 155, 79, 139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215,
    29, 15, 147, 29, 59, 65, 55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21, 43, 149,
    45, 49, 71, 13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31, 59, 185, 113, 31, 17, 171,
    209, 253, 367, 265, 181, 39, 27, 127, 143, 43, 29, 45, 157, 47, 13, 111, 443, 51, 51, 451, 257,
    57, 313, 271, 179, 331, 363, 375, 127, 31, 33, 43, 33, 477, 35, 233, 357, 337, 37, 71, 71, 37,
    39, 127, 39, 39, 31, 113, 41, 251, 43, 21, 43, 45, 45, 161, 89, 323, 47, 23, 47, 263,
)
F2 = (
    10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84, 44, 46, 48, 50,
    52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76, 78, 120, 82, 84, 86, 44, 90, 46,
    94, 48, 98, 40, 102, 52, 106, 72, 110, 168, 114, 58, 118, 180, 122, 62, 84, 64, 66, 68, 420,
    96, 74, 76, 234, 80, 82, 252, 86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110, 112,
    114, 58, 118, 60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78, 240, 82, 252, 86, 88, 60,
    92, 846, 48, 28, 80, 102, 104, 954, 96, 110, 112, 114, 116, 354, 120, 610, 124, 420, 64, 66, 136,
    420, 216, 444, 456, 468, 80, 164, 504, 172, 88, 300, 92, 188, 96, 28, 240, 204, 104, 212, 192, 220,
    336, 228, 232, 236, 120, 244, 248, 168, 64, 130, 264, 134, 408, 138, 280, 142, 480, 146, 444, 120, 152,
    462, 234, 158, 80, 96, 902, 166, 336, 170, 86, 174, 176, 178, 120, 182, 184, 186, 94, 190, 480,
)

assert len(F1) == NOF_CB_SIZES and len(F2) == NOF_CB_SIZES

MAX_CB_SIZE = 6144
TB_CRC_LEN = 24  # CRC24A on the transport block
CB_CRC_LEN = 24  # CRC24B on each code block (only when C > 1)


def cb_size_index(k: int) -> int:
    """Index of CB size k in CB_SIZES (`srslte_cbsegm_cbindex`)."""
    i = np.searchsorted(CB_SIZES, k)
    if i >= NOF_CB_SIZES or CB_SIZES[i] != k:
        raise ValueError(f"invalid CB size {k}")
    return int(i)


@dataclasses.dataclass(frozen=True)
class CbSegm:
    """Result of TB segmentation (`srslte_cbsegm_t`)."""

    tbs: int  # transport block size (without CRC)
    C: int  # number of code blocks
    C_plus: int  # number of CBs of size K_plus
    C_minus: int
    K_plus: int
    K_minus: int
    F: int  # filler bits (prepended to first CB)

    @property
    def cb_sizes(self) -> tuple[int, ...]:
        return (self.K_minus,) * self.C_minus + (self.K_plus,) * self.C_plus

    @cached_property
    def blocks(self) -> tuple[CbBlock, ...]:
        """Each code block's layout, in order; `e` and `off` are 0."""
        crc, poly = (CB_CRC_LEN, LTE_CRC24B) if self.C > 1 else (0, LTE_CRC24A)
        out, pos = [], 0
        for i, k in enumerate(self.cb_sizes):
            f = self.F if i == 0 else 0
            out.append(CbBlock(k, f, crc, k - f - crc, pos, poly))
            pos += k - f - crc
        return tuple(out)


class CbBlock(NamedTuple):
    """One code block of a TB: the layout of `CbSegm.blocks`, and in
    `sch.TbCoding.blocks` its place on the channel too."""

    k: int  # its size K
    f: int  # filler bits at its head: F on block 0, else 0
    crc: int  # its CRC24B bits: 24 when C > 1, else 0
    msg: int  # the bits of TB||CRC24A it carries, k - f - crc
    pos: int  # where they start in TB||CRC24A
    poly: int  # the CRC its decode checks: CRC24B, or the TB's CRC24A when C = 1
    e: int = 0  # its rate-matched bits
    off: int = 0  # where they start in the codeword


@lru_cache(maxsize=1024)
def cbsegm(tbs: int) -> CbSegm:
    """Segment a TB of `tbs` bits (TS 36.212 §5.1.2; cbsegm.c:44-110)."""
    B = tbs + TB_CRC_LEN
    Z = MAX_CB_SIZE
    if B <= Z:
        L = 0
        C = 1
        B_p = B
    else:
        L = CB_CRC_LEN
        C = int(np.ceil(B / (Z - L)))
        B_p = B + C * L

    # first K in table >= B'/C
    idx = int(np.searchsorted(CB_SIZES, int(np.ceil(B_p / C))))
    # searchsorted returns first >= value for side='left'
    while CB_SIZES[idx] * C < B_p:
        idx += 1
    K_plus = CB_SIZES[idx]
    if C == 1:
        K_minus, C_minus, C_plus = 0, 0, 1
    else:
        K_minus = CB_SIZES[idx - 1]
        dk = K_plus - K_minus
        C_minus = (C * K_plus - B_p) // dk
        C_plus = C - C_minus
    F = C_plus * K_plus + C_minus * K_minus - B_p
    return CbSegm(tbs=tbs, C=C, C_plus=C_plus, C_minus=C_minus, K_plus=K_plus, K_minus=K_minus, F=F)


@lru_cache(maxsize=1024)
def qpp_interleaver_np(k: int) -> np.ndarray:
    """QPP permutation Pi(i) = (f1*i + f2*i^2) mod K (TS 36.212 §5.1.3.2.3).

    Output: index array `per` with per[i] = Pi(i); the turbo encoder 2 input
    at step i is input[per[i]] (matches `tc_interl_lte.c` forward table).
    """
    idx = cb_size_index(k)
    f1, f2 = F1[idx], F2[idx]
    i = np.arange(k, dtype=np.int64)
    return ((f1 * i + f2 * i * i) % k).astype(np.int32)
