"""DL and UL MCS → (modulation, I_TBS), the TBS lookup and the resource
indication value, TS 36.213 §7.1.7, §8.6.1 and §7.1.6.3 — host side.  Copy
of that part of `srsran_tpu/phy/phch/ra.py`; the spec tables are in
`tbs_data.py`."""

from __future__ import annotations

from ..modem import Mod
from .tbs_data import DL_MCS_TBS_IDX, DL_MCS_TBS_IDX_256QAM, TBS_TABLE, UL_MCS_TBS_IDX


def dl_mcs_to_mod(mcs: int, use_256qam: bool = False) -> Mod:
    """TS 36.213 Table 7.1.7.1-1 (/-1A)."""
    bounds = ((4, Mod.QPSK), (10, Mod.QAM16), (19, Mod.QAM64), (27, Mod.QAM256)) if use_256qam \
        else ((9, Mod.QPSK), (16, Mod.QAM16), (28, Mod.QAM64))
    for last, mod in bounds:
        if mcs <= last:
            return mod
    raise ValueError(f"reserved MCS {mcs}")


def dl_mcs_to_itbs(mcs: int, use_256qam: bool = False) -> int:
    return (DL_MCS_TBS_IDX_256QAM if use_256qam else DL_MCS_TBS_IDX)[mcs]


def ul_mcs_to_mod(mcs: int) -> Mod:
    """TS 36.213 Table 8.6.1-1."""
    for last, mod in ((10, Mod.QPSK), (20, Mod.QAM16), (28, Mod.QAM64)):
        if mcs <= last:
            return mod
    raise ValueError(f"reserved MCS {mcs}")


def ul_mcs_to_itbs(mcs: int) -> int:
    return UL_MCS_TBS_IDX[mcs]


def tbs_lookup(i_tbs: int, n_prb: int) -> int:
    """TS 36.213 Table 7.1.7.2.1-1."""
    return TBS_TABLE[i_tbs][n_prb - 1]


def dl_tbs(mcs: int, n_prb: int, use_256qam: bool = False, dwpts: bool = False) -> int:
    """TBS of a DL grant.  ``dwpts``: a TDD special subframe uses
    max(1, 0.75*n_prb) as the table column (TS 36.213 §7.1.7)."""
    if dwpts:
        n_prb = max(1, int(0.75 * n_prb))
    return tbs_lookup(dl_mcs_to_itbs(mcs, use_256qam), n_prb)


def riv_encode(nof_prb: int, rb_start: int, l_crb: int) -> int:
    """TS 36.213 §7.1.6.3."""
    if l_crb < 1 or rb_start + l_crb > nof_prb:
        raise ValueError("invalid allocation")
    if (l_crb - 1) <= nof_prb // 2:
        return nof_prb * (l_crb - 1) + rb_start
    return nof_prb * (nof_prb - l_crb + 1) + (nof_prb - 1 - rb_start)


def riv_decode(nof_prb: int, riv: int) -> tuple[int, int]:
    """Returns (rb_start, l_crb)."""
    l_crb = riv // nof_prb + 1
    rb_start = riv % nof_prb
    if rb_start + l_crb > nof_prb:  # encoded with the flipped branch
        l_crb = nof_prb - l_crb + 2
        rb_start = nof_prb - 1 - rb_start
    if l_crb < 1 or rb_start + l_crb > nof_prb:
        raise ValueError(f"invalid RIV {riv}")
    return rb_start, l_crb
