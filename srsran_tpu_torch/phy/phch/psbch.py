"""PSBCH: sidelink broadcast channel carrying MIB-SL, TS 36.211 §9.6 /
TS 36.331 MasterInformationBlock-SL (counterpart of
`srsran_tpu/phy/phch/psbch.py`).

TM1/2 normal-CP subframe layout (phy_common_sl.c symbol map):
  l = 0            PSBCH data
  l = 1, 2         PSSS
  l = 3            PSBCH DMRS
  l = 4..9         PSBCH data
  l = 10           PSBCH DMRS
  l = 11, 12       SSSS
  l = 13           guard

Coding: MIB-SL (40 bits) + CRC16 → K=7 tail-biting conv code → rate-match
to E = 8·72·2 = 1152 bits (8 data symbols budgeted, the 8th is never
transmitted) → PUSCH-style time-first interleaver (C_mux = 8) → scrambling
c_init = N_sl_id → QPSK → 72-point DFT precoding (SC-FDMA) → the 7
transmitted data symbols, centered 6 PRB.  Extended-CP cells use the
tm12_ext map; TM3/4 (V2X) carries a 48-bit MIB-SL-V2X.

Host copies: `MibSl`, the DMRS, the encoder.  The decodes run on the
device of the grid through `pscch._sl_tbcc_decode`.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..chest.refsignal_ul import base_sequence
from ..common import CP, Cell
from .pscch import _sl_tbcc_decode, crc16_ok, sl_tbcc_encode_np

MIB_SL_LEN = 40
N_DATA_BUDGET = 8  # rate-matching budget (symbols)
DATA_SYMS = (0, 4, 5, 6, 7, 8, 9)  # actually transmitted
DMRS_SYMS = (3, 10)
M_SC = 72  # 6 PRB
E_BITS = N_DATA_BUDGET * M_SC * 2

# extended-CP layout (srslte_psbch_symbol_map_tm12_ext, phy_common_sl.c:135;
# budget SRSLTE_PSBCH_TM12_NUM_DATA_SYMBOLS_EXT = 6, 5 transmitted)
N_DATA_BUDGET_EXT = 6
DATA_SYMS_EXT = (3, 4, 5, 6, 7)
DMRS_SYMS_EXT = (2, 8)
E_BITS_EXT = N_DATA_BUDGET_EXT * M_SC * 2


@dataclasses.dataclass(frozen=True)
class MibSl:
    """MasterInformationBlock-SL (TS 36.331 §6.5.2)."""

    sl_bandwidth: int = 0  # 0..5 -> n6,n15,n25,n50,n75,n100
    tdd_config_sl: int = 0  # 3 bits
    direct_frame_number: int = 0  # 10 bits
    direct_subframe_number: int = 0  # 4 bits
    in_coverage: bool = False

    def pack(self) -> np.ndarray:
        bits = []

        def put(v, n):
            bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

        put(self.sl_bandwidth, 3)
        put(self.tdd_config_sl, 3)
        put(self.direct_frame_number, 10)
        put(self.direct_subframe_number, 4)
        put(int(self.in_coverage), 1)
        put(0, 19)  # reserved
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits) -> "MibSl":
        b = list(map(int, bits))

        def get(pos, n):
            return int("".join(map(str, b[pos : pos + n])), 2)

        return cls(get(0, 3), get(3, 3), get(6, 10), get(16, 4), bool(get(20, 1)))


@lru_cache(maxsize=64)
def psbch_dmrs_np(n_sl_id: int) -> np.ndarray:
    """(2, 72) PSBCH DMRS (chest_sl_psbch_gen): u = (id/16) mod 30,
    alpha = 2π((id/2) mod 8)/12, w = [1, 1] for even id else [1, -1]."""
    u = (n_sl_id // 16) % 30
    n_cs = (n_sl_id // 2) % 8
    alpha = 2 * np.pi * n_cs / 12
    r = base_sequence(u, M_SC) * np.exp(1j * alpha * np.arange(M_SC))
    w = np.array([1.0, 1.0]) if n_sl_id % 2 == 0 else np.array([1.0, -1.0])
    return (w[:, None] * r[None, :]).astype(np.complex64)


def psbch_encode_np(mib: MibSl, n_sl_id: int) -> np.ndarray:
    """MIB-SL → (7, 72) SC-FDMA symbols (the transmitted data symbols)."""
    prec = sl_tbcc_encode_np(mib.pack(), E_BITS, N_DATA_BUDGET, n_sl_id, M_SC)
    return prec[: len(DATA_SYMS)]


def put_psbch_np(grid: np.ndarray, cell: Cell, mib: MibSl, n_sl_id: int):
    """Insert PSBCH data + DMRS into a (nsymb_sf, nre) grid."""
    k0 = cell.nof_re_per_symbol // 2 - 36
    sym = psbch_encode_np(mib, n_sl_id)
    for i, l in enumerate(DATA_SYMS):
        grid[l, k0 : k0 + M_SC] = sym[i]
    dmrs = psbch_dmrs_np(n_sl_id)
    for j, l in enumerate(DMRS_SYMS):
        grid[l, k0 : k0 + M_SC] = dmrs[j]
    return grid


def psbch_decode(grid: torch.Tensor, cell: Cell, n_sl_id: int):
    """(nsymb_sf, nre) grid tensor → (MibSl, ok).  DMRS-equalized, SC-FDMA
    de-precoded, the untransmitted last budget symbol contributes zero LLRs.
    Extended-CP cells use the tm12_ext symbol map."""
    ext = cell.cp == CP.EXT
    bits, empty = _sl_tbcc_decode(
        grid, [cell.nof_re_per_symbol // 2 - 36], table(psbch_dmrs_np, n_sl_id, device=grid.device)[None],
        DMRS_SYMS_EXT if ext else DMRS_SYMS, DATA_SYMS_EXT if ext else DATA_SYMS,
        N_DATA_BUDGET_EXT if ext else N_DATA_BUDGET, n_sl_id, MIB_SL_LEN + 16)
    if empty[0]:
        return MibSl(), False
    return MibSl.unpack(bits[0, :MIB_SL_LEN]), crc16_ok(bits[0], MIB_SL_LEN)


# --- TM3/4 (V2X) variant ----------------------------------------------------

MIB_SL_V2X_LEN = 48
DATA_SYMS_TM34 = (0, 3, 5, 7, 8, 10)  # 6 transmitted of 7 budgeted
DMRS_SYMS_TM34 = (4, 6, 9)
N_DATA_BUDGET_TM34 = 7
E_BITS_TM34 = N_DATA_BUDGET_TM34 * M_SC * 2


@lru_cache(maxsize=64)
def psbch_dmrs_tm34_np(n_sl_id: int) -> np.ndarray:
    """(3, 72) TM3/4 PSBCH DMRS: same base/shift as TM1/2, w = [1,1,1] for
    even id else [1,-1,1] (chest_sl.c §9.8 TM3/4 branch)."""
    u = (n_sl_id // 16) % 30
    n_cs = (n_sl_id // 2) % 8
    alpha = 2 * np.pi * n_cs / 12
    r = base_sequence(u, M_SC) * np.exp(1j * alpha * np.arange(M_SC))
    w = np.array([1.0, 1.0, 1.0]) if n_sl_id % 2 == 0 else np.array([1.0, -1.0, 1.0])
    return (w[:, None] * r[None, :]).astype(np.complex64)


def _dmrs_tm34_ids(ids: tuple) -> np.ndarray:
    return np.stack([psbch_dmrs_tm34_np(i) for i in ids])


def psbch_search_tm34(grid: torch.Tensor, cell: Cell, ids):
    """TM3/4 (V2X) MIB-SL decodes under every N_sl_id of `ids` in one batch
    (each id its own DMRS and scrambling), one host read → [(payload_bits
    (48,) uint8 numpy, ok)] per id."""
    ids = tuple(int(i) for i in ids)
    bits, empty = _sl_tbcc_decode(
        grid, [cell.nof_re_per_symbol // 2 - 36] * len(ids),
        table(_dmrs_tm34_ids, ids, device=grid.device),
        DMRS_SYMS_TM34, DATA_SYMS_TM34, N_DATA_BUDGET_TM34, list(ids), MIB_SL_V2X_LEN + 16)
    return [(np.zeros(MIB_SL_V2X_LEN, np.uint8), False) if e
            else (b[:MIB_SL_V2X_LEN], crc16_ok(b, MIB_SL_V2X_LEN)) for b, e in zip(bits, empty)]


def psbch_decode_tm34(grid: torch.Tensor, cell: Cell, n_sl_id: int):
    """TM3/4 (V2X) MIB-SL decode → (payload_bits (48,) uint8 numpy, ok)."""
    return psbch_search_tm34(grid, cell, [n_sl_id])[0]
