"""LTE numerology and cell configuration (host side, pure Python).

Copy of `srsran_tpu/phy/common.py`: the numerology's limits, the CP
enum, the frozen `Cell` dataclass (with the PCI's N_id_1 and N_id_2, its
REs and CRS shift), FFT, CP and subframe sizes, the CRS symbols, and the
CRC polynomials (TS 36.211, TS 36.212 §5.1.1).  Tests hold every value
equal to the reference.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import lru_cache

NRE = 12  # subcarriers per PRB
MAX_PRB = 110
MAX_PORTS = 4
MAX_LAYERS = 4
MAX_CODEWORDS = 2
MAX_CODEBLOCKS = 32
NOF_NID_1 = 168
NOF_NID_2 = 3
NUM_PCI = NOF_NID_1 * NOF_NID_2

CP_NORM_NSYMB = 7
CP_EXT_NSYMB = 6
# CP lengths in units of 1/2048 of the symbol
CP_NORM_0_LEN = 160
CP_NORM_LEN = 144
CP_EXT_LEN = 512

# CRC polynomials (TS 36.212 §5.1.1)
LTE_CRC24A = 0x1864CFB
LTE_CRC24B = 0x1800063
LTE_CRC16 = 0x11021
LTE_CRC8 = 0x19B

# RNTI spaces (reference phy_common.h:82-96)
SIRNTI = 0xFFFF
PRNTI = 0xFFFE
MRNTI = 0xFFFD

NOF_CFI = 3


class CP(enum.IntEnum):
    NORM = 0
    EXT = 1

    @property
    def nsymb(self) -> int:
        return CP_NORM_NSYMB if self == CP.NORM else CP_EXT_NSYMB


VALID_NOF_PRB = (6, 15, 25, 50, 75, 100)


def symbol_sz(nof_prb: int, use_standard_rates: bool = True) -> int:
    """FFT size for a bandwidth (power-of-2 sizes at standard rates)."""
    if nof_prb <= 0:
        raise ValueError(f"invalid nof_prb {nof_prb}")
    table = (
        ((6, 128), (15, 256), (25, 512), (50, 1024), (75, 1536), (100, 2048))
        if use_standard_rates
        else ((6, 128), (15, 256), (25, 384), (50, 768), (75, 1024), (100, 1536))
    )
    for prb, sz in table:
        if nof_prb <= prb:
            return sz
    raise ValueError(f"invalid nof_prb {nof_prb}")


def nof_prb_from_symbol_sz(sz: int, use_standard_rates: bool = True) -> int:
    for prb in VALID_NOF_PRB:
        if symbol_sz(prb, use_standard_rates) == sz:
            return prb
    raise ValueError(f"invalid symbol size {sz}")


def cp_len(sym_sz: int, c: int) -> int:
    """CP length in samples for a given FFT size."""
    return int(math.ceil(c * sym_sz / 2048.0))


def cp_len_norm(symbol_idx: int, sym_sz: int) -> int:
    return cp_len(sym_sz, CP_NORM_0_LEN if symbol_idx == 0 else CP_NORM_LEN)


def cp_len_ext(sym_sz: int) -> int:
    return cp_len(sym_sz, CP_EXT_LEN)


def slot_len(sym_sz: int) -> int:
    return sym_sz * 15 // 2


def sf_len(sym_sz: int) -> int:
    return sym_sz * 15


def sf_len_prb(nof_prb: int, use_standard_rates: bool = True) -> int:
    return sf_len(symbol_sz(nof_prb, use_standard_rates))


def srate(nof_prb: int, use_standard_rates: bool = True) -> float:
    """Sample rate in Hz (15 kHz subcarrier spacing)."""
    return symbol_sz(nof_prb, use_standard_rates) * 15000.0


@dataclasses.dataclass(frozen=True)
class Cell:
    """Static LTE cell definition (hashable: a key for cached tables)."""

    nof_prb: int = 6
    nof_ports: int = 1
    id: int = 0  # PCI: 3*N_id_1 + N_id_2
    cp: CP = CP.NORM
    phich_length: int = 0  # 0=norm, 1=ext
    phich_resources: int = 1
    use_standard_rates: bool = True

    def __post_init__(self):
        if self.nof_prb not in range(6, MAX_PRB + 1):
            raise ValueError(f"nof_prb {self.nof_prb} out of range")
        if self.id >= NUM_PCI:
            raise ValueError(f"cell id {self.id} out of range")
        if self.nof_ports not in (0, 1, 2, 4):
            raise ValueError(f"nof_ports {self.nof_ports} invalid")

    @property
    def n_id_1(self) -> int:
        return self.id // 3

    @property
    def n_id_2(self) -> int:
        return self.id % 3

    @property
    def symbol_sz(self) -> int:
        return symbol_sz(self.nof_prb, self.use_standard_rates)

    @property
    def nsymb_per_slot(self) -> int:
        return self.cp.nsymb

    @property
    def nsymb_per_sf(self) -> int:
        return 2 * self.cp.nsymb

    @property
    def nof_re_per_symbol(self) -> int:
        return self.nof_prb * NRE

    @property
    def nof_re(self) -> int:
        """REs in one subframe (one port)."""
        return self.nsymb_per_sf * self.nof_re_per_symbol

    @property
    def sf_len(self) -> int:
        """Time-domain samples in one 1 ms subframe."""
        return sf_len(self.symbol_sz)

    @property
    def slot_len(self) -> int:
        return slot_len(self.symbol_sz)

    @property
    def srate(self) -> float:
        return self.symbol_sz * 15000.0

    def cp_lengths_slot(self) -> tuple[int, ...]:
        """Per-symbol CP lengths within one slot."""
        n = self.symbol_sz
        if self.cp == CP.NORM:
            return tuple(cp_len_norm(i, n) for i in range(CP_NORM_NSYMB))
        return tuple(cp_len_ext(n) for _ in range(CP_EXT_NSYMB))

    def vshift(self) -> int:
        """CRS frequency shift (`SRSLTE_RS_VSHIFT`)."""
        return self.id % 6


def symbol_has_ref(l: int, cp: CP, nof_ports: int) -> bool:
    """Which OFDM symbols in a slot carry CRS (`SRSLTE_SYMBOL_HAS_REF`)."""
    return (l == 1 and nof_ports == 4) or l == 0 or l == cp.nsymb - 3


@lru_cache(maxsize=None)
def re_grid_shape(nof_prb: int, cp: CP = CP.NORM) -> tuple[int, int]:
    """(nsymb_per_sf, n_subcarriers) shape of the subframe resource grid."""
    return (2 * cp.nsymb, nof_prb * NRE)
