"""Host copy of `srsran_tpu/phy/tdd.py`, held to it by `tests/test_torch_stack.py`.

LTE TDD (frame structure type 2) numerology and HARQ timing.

Covers the reference's TDD support surface:
- uplink/downlink configurations 0-6 and special-subframe configurations 0-9
  (reference `lib/src/phy/common/phy_common.c:98-177`,
  `srslte_sfidx_tdd_type/nof_dw/nof_gp/nof_up/nof_dw_slot`),
- the PHICH m_i factor table (TS 36.211 Table 6.9-1; reference
  `lib/src/phy/ue/ue_dl.c:51-59` `mi_tdd_table`),
- HARQ timing: the downlink association sets K (TS 36.213 Table 10.1-1),
  the PUSCH scheduling delay k (Table 8-2) and the PHICH delay k_PHICH
  (§9.1.2), and the UL HARQ process mapping — all mirrored from the
  reference's `srsue/src/phy/phy_common.cc:193-260,488-518`.

Everything here is static-table numerology evaluated host-side; the
device-side kernels only ever see the resulting symbol counts / subframe
masks, so all of this stays out of traced code.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

NOF_SF_X_FRAME = 10
MAX_TDD_SF_CONFIGS = 7
MAX_TDD_SS_CONFIGS = 10

FDD_HARQ_DELAY_UL_MS = 4
FDD_HARQ_DELAY_DL_MS = 4
FDD_NOF_HARQ = 8


class SfType(enum.IntEnum):
    """Subframe type in a TDD frame (D = downlink, U = uplink, S = special)."""

    D = 0
    U = 1
    S = 2


@dataclasses.dataclass(frozen=True)
class TddConfig:
    """TDD uplink/downlink configuration (TS 36.211 Table 4.2-2) plus the
    special-subframe configuration (Table 4.2-1)."""

    sf_config: int = 0  # uplink/downlink configuration 0-6
    ss_config: int = 0  # special subframe configuration 0-9
    configured: bool = True

    def __post_init__(self):
        if not 0 <= self.sf_config < MAX_TDD_SF_CONFIGS:
            raise ValueError(f"sf_config {self.sf_config}")
        if not 0 <= self.ss_config < MAX_TDD_SS_CONFIGS:
            raise ValueError(f"ss_config {self.ss_config}")


_D, _U, _S = SfType.D, SfType.U, SfType.S

# TS 36.211 Table 4.2-2 (uplink-downlink configurations)
SF_TYPE_TABLE: tuple[tuple[SfType, ...], ...] = (
    (_D, _S, _U, _U, _U, _D, _S, _U, _U, _U),  # config 0
    (_D, _S, _U, _U, _D, _D, _S, _U, _U, _D),  # config 1
    (_D, _S, _U, _D, _D, _D, _S, _U, _D, _D),  # config 2
    (_D, _S, _U, _U, _U, _D, _D, _D, _D, _D),  # config 3
    (_D, _S, _U, _U, _D, _D, _D, _D, _D, _D),  # config 4
    (_D, _S, _U, _D, _D, _D, _D, _D, _D, _D),  # config 5
    (_D, _S, _U, _U, _U, _D, _S, _U, _U, _D),  # config 6
)

# TS 36.211 Table 4.2-1 for normal CP: (DwPTS, GP, UpPTS) in OFDM symbols
SS_SYMBOLS_TABLE: tuple[tuple[int, int, int], ...] = (
    (3, 10, 1),
    (9, 4, 1),
    (10, 3, 1),
    (11, 2, 1),
    (12, 1, 1),
    (3, 9, 2),
    (9, 3, 2),
    (10, 2, 2),
    (11, 1, 1),
    (6, 6, 2),
)

# number of DL HARQ processes per UL/DL configuration (TS 36.213 Table 7-1;
# reference phy_common.c:181)
NOF_HARQ_TABLE = (7, 4, 2, 3, 2, 1, 6)

# PHICH m_i factor per (UL/DL config, subframe) — TS 36.211 Table 6.9-1
MI_TABLE = (
    (2, 1, 0, 0, 0, 2, 1, 0, 0, 0),
    (0, 1, 0, 0, 1, 0, 1, 0, 0, 1),
    (0, 0, 0, 1, 0, 0, 0, 0, 1, 0),
    (1, 0, 0, 0, 0, 0, 0, 0, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 0),
    (1, 1, 0, 0, 0, 1, 1, 0, 0, 1),
)

# Downlink association sets K: for UL subframe n, ACKs sent in n cover DL
# subframes n-k for k in DAS_TABLE[cfg][n] (TS 36.213 Table 10.1-1)
DAS_TABLE: tuple[tuple[tuple[int, ...], ...], ...] = (
    ((), (), (6,), (), (4,), (), (), (6,), (), (4,)),  # config 0
    ((), (), (7, 6), (4,), (), (), (), (7, 6), (4,), ()),  # config 1
    ((), (), (8, 7, 4, 6), (), (), (), (), (8, 7, 4, 6), (), ()),  # config 2
    ((), (), (7, 6, 11), (6, 5), (5, 4), (), (), (), (), ()),  # config 3
    ((), (), (12, 8, 7, 11), (6, 5, 4, 7), (), (), (), (), (), ()),  # config 4
    ((), (), (13, 12, 9, 8, 7, 5, 4, 11, 6), (), (), (), (), (), (), ()),  # 5
    ((), (), (7,), (7,), (5,), (), (), (7,), (7,), ()),  # config 6
)

# PUSCH delay: UL grant in DL subframe n schedules PUSCH in n + K_PUSCH[cfg][n]
# (TS 36.213 Table 8-2; 0 where n is not a grant opportunity)
K_PUSCH = (
    (4, 6, 0, 0, 0, 4, 6, 0, 0, 0),
    (0, 6, 0, 0, 4, 0, 6, 0, 0, 4),
    (0, 0, 0, 4, 0, 0, 0, 0, 4, 0),
    (4, 0, 0, 0, 0, 0, 0, 0, 4, 4),
    (0, 0, 0, 0, 0, 0, 0, 0, 4, 4),
    (0, 0, 0, 0, 0, 0, 0, 0, 4, 0),
    (7, 7, 0, 0, 0, 7, 7, 0, 0, 5),
)

# PHICH delay: PUSCH in UL subframe n is ACKed by PHICH in n + K_PHICH[cfg][n]
# (TS 36.213 §9.1.2)
K_PHICH = (
    (0, 0, 4, 7, 6, 0, 0, 4, 7, 6),
    (0, 0, 4, 6, 0, 0, 0, 4, 6, 0),
    (0, 0, 6, 0, 0, 0, 0, 6, 0, 0),
    (0, 0, 6, 6, 6, 0, 0, 0, 0, 0),
    (0, 0, 6, 6, 0, 0, 0, 0, 0, 0),
    (0, 0, 6, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 4, 6, 6, 0, 0, 4, 7, 0),
)


def sf_type(cfg: TddConfig | None, sf_idx: int) -> SfType:
    """Type of subframe ``sf_idx`` (mirrors `srslte_sfidx_tdd_type`,
    phy_common.c:111: unconfigured/FDD -> D)."""
    if cfg is None or not cfg.configured:
        return SfType.D
    return SF_TYPE_TABLE[cfg.sf_config][sf_idx % NOF_SF_X_FRAME]


def nof_dw(cfg: TddConfig) -> int:
    """DwPTS length in OFDM symbols (normal CP)."""
    return SS_SYMBOLS_TABLE[cfg.ss_config][0]


def nof_gp(cfg: TddConfig) -> int:
    return SS_SYMBOLS_TABLE[cfg.ss_config][1]


def nof_up(cfg: TddConfig) -> int:
    return SS_SYMBOLS_TABLE[cfg.ss_config][2]


def nof_dw_slot(cfg: TddConfig, slot: int, nsymb_per_slot: int = 7) -> int:
    """DwPTS symbols that fall in slot 0/1 of the special subframe
    (mirrors `srslte_sfidx_tdd_nof_dw_slot`, phy_common.c:120-136)."""
    n = nof_dw(cfg)
    if slot == 0:
        return min(n, nsymb_per_slot)
    return max(0, n - nsymb_per_slot)


def nof_harq(cfg: TddConfig | None) -> int:
    """Number of DL HARQ processes (FDD: 8)."""
    if cfg is None or not cfg.configured:
        return FDD_NOF_HARQ
    return NOF_HARQ_TABLE[cfg.sf_config]


def mi_value(cfg: TddConfig | None, sf_idx: int) -> int:
    """PHICH group scale factor m_i (FDD: 1)."""
    if cfg is None or not cfg.configured:
        return 1
    return MI_TABLE[cfg.sf_config][sf_idx % NOF_SF_X_FRAME]


def das_set(cfg: TddConfig, sf_idx: int) -> tuple[int, ...]:
    """Downlink association set for UL subframe sf_idx: the k values such
    that a PDSCH in subframe n-k is acknowledged in n."""
    return DAS_TABLE[cfg.sf_config][sf_idx % NOF_SF_X_FRAME]


def ack_tti(cfg: TddConfig | None, pdsch_tti: int) -> int:
    """TTI in which the ACK for a PDSCH received at ``pdsch_tti`` is sent.

    FDD: n+4. TDD: the unique UL subframe whose association set covers this
    DL subframe (TS 36.213 §10.1; inverse of `das_set`).
    """
    if cfg is None or not cfg.configured:
        return pdsch_tti + FDD_HARQ_DELAY_UL_MS
    for k_ahead in range(1, 14):
        tti = pdsch_tti + k_ahead
        if k_ahead in das_set(cfg, tti % NOF_SF_X_FRAME):
            return tti
    raise ValueError(f"no ACK opportunity for DL sf {pdsch_tti % 10} cfg {cfg.sf_config}")


def pusch_tti(cfg: TddConfig | None, grant_tti: int, ul_idx: int = 0) -> int:
    """TTI of the PUSCH scheduled by a UL grant (DCI0/PHICH) at grant_tti.

    FDD: n+4. TDD: n + k from Table 8-2; config 0 with UL-index MSB set
    uses k=7 (reference phy_common.cc:328-334).
    """
    if cfg is None or not cfg.configured:
        return grant_tti + FDD_HARQ_DELAY_UL_MS
    if cfg.sf_config == 0 and ul_idx == 1:
        return grant_tti + 7
    k = K_PUSCH[cfg.sf_config][grant_tti % NOF_SF_X_FRAME]
    if k == 0:
        raise ValueError(f"sf {grant_tti % 10} is not a UL-grant opportunity in cfg {cfg.sf_config}")
    return grant_tti + k


def phich_tti(cfg: TddConfig | None, pusch_tti_: int) -> int:
    """TTI in which the PHICH for a PUSCH sent at ``pusch_tti_`` arrives
    (TS 36.213 §9.1.2; FDD: n+4)."""
    if cfg is None or not cfg.configured:
        return pusch_tti_ + FDD_HARQ_DELAY_UL_MS
    k = K_PHICH[cfg.sf_config][pusch_tti_ % NOF_SF_X_FRAME]
    if k == 0:
        raise ValueError(f"sf {pusch_tti_ % 10} is not a UL subframe in cfg {cfg.sf_config}")
    return pusch_tti_ + k


def ul_pid(cfg: TddConfig | None, tti: int) -> int:
    """UL HARQ process id for a PUSCH at ``tti`` (reference
    phy_common.cc:211-260: configs 1-5 tie each PID to a UL subframe;
    configs 0/6 cycle with the SFN)."""
    if cfg is None or not cfg.configured:
        return tti % FDD_NOF_HARQ
    sf_idx = tti % 10
    sfn = tti // 10
    c = cfg.sf_config
    if c == 0:
        cycle = 7 - sfn % 7
        return (cycle + sf_idx - 2) % 7 if sf_idx < 5 else (cycle + sf_idx - 4) % 7
    if c == 1:
        return sf_idx - 2 if sf_idx < 5 else sf_idx - 5
    if c == 2:
        return 0 if sf_idx < 5 else 1
    if c in (3, 4, 5):
        return sf_idx - 2
    cycle = 6 - sfn % 6
    return (cycle + sf_idx - 2) % 6 if sf_idx < 5 else (cycle + sf_idx - 4) % 6


def ul_sf_mask(cfg: TddConfig) -> np.ndarray:
    """Boolean (10,) mask of UL subframes — handy as a static argument for
    batched per-frame device pipelines (subframe axis masked, not looped)."""
    return np.array([sf_type(cfg, i) == SfType.U for i in range(10)])


def dl_sf_mask(cfg: TddConfig, include_special: bool = True) -> np.ndarray:
    types = [sf_type(cfg, i) for i in range(10)]
    return np.array([t == SfType.D or (include_special and t == SfType.S) for t in types])
