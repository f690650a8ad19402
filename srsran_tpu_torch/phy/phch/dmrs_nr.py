"""NR PDSCH DM-RS, TS 38.211 §7.4.1.1 (role of
`lib/src/phy/ch_estimation/dmrs_pdsch.c` — the reference's only NR PHY
helper, part of the 5G-NR scaffolding).

Counterpart of `srsran_tpu/phy/phch/dmrs_nr.py`.  Covers what the reference
covers: mapping type A (single- and double-symbol, Tables 7.4.1.1.2-3/-4;
type B is rejected there too, dmrs_pdsch.c:198), configuration types 1 and
2, the §7.4.1.1.1 c_init seed, and put/get of the whole subframe's pilots.
The tables (symbol and subcarrier indices, QPSK pilots, one Gold-sequence
evaluation a symbol) are built on the host in numpy; `put_sf` and `get_sf`
run on torch tensors: a tensor grid stays on its own device, a numpy grid
goes to `device.resolve(device)` (None: the card).  The tables are cached
per (config, slot, device).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...device import as_samples, resolve, sized_table
from ..sequence import gold_sequence_signs

NRE = 12
MAX_NSYMB = 14
NOF_SLOTS_PER_SF = 2  # 15 kHz numerology, like the reference's use


@dataclasses.dataclass(frozen=True)
class DmrsPdschConfig:
    nof_prb: int = 52
    mapping_type: str = "A"  # only A, as in the reference
    typeA_pos: int = 2  # 2 | 3 (dmrs-TypeA-Position)
    additional_pos: int = 0  # 0..3 (dmrs-AdditionalPosition)
    length: int = 1  # 1 = single, 2 = double symbol
    duration: int = 14  # ld, scheduled symbols
    type: int = 1  # config type 1 (comb-2) | 2 (2-of-6 clusters)
    n_id: int = 0  # scrambling id
    n_scid: int = 0


def symbols_idx(cfg: DmrsPdschConfig) -> list[int]:
    """DMRS symbol indices (TS 38.211 Tables 7.4.1.1.2-3/-4)."""
    if cfg.mapping_type != "A":
        raise ValueError("PDSCH mapping type B not supported (as in the reference)")
    if cfg.typeA_pos != 2 and cfg.additional_pos == 3:
        raise ValueError("additional_pos=3 requires typeA_pos=2")
    if cfg.duration in (3, 4) and cfg.typeA_pos != 2:
        raise ValueError("ld of 3/4 requires typeA_pos=2")
    l0 = 3 if cfg.typeA_pos == 3 else 2
    d = cfg.duration
    if cfg.length == 2:  # double-symbol, Table 7.4.1.1.2-4
        if d < 4:
            raise ValueError("double-symbol DMRS needs ld >= 4")
        out = [l0, l0 + 1]
        if d < 10 or cfg.additional_pos == 0:
            return out
        return out + ([8, 9] if d < 13 else [10, 11])
    # single-symbol, Table 7.4.1.1.2-3
    if d < 3:
        raise ValueError("single-symbol DMRS needs ld >= 3")
    out = [l0]
    if d < 8 or cfg.additional_pos == 0:
        return out
    if d < 10:
        return out + [7]
    if d < 12:
        return out + ([6, 9] if cfg.additional_pos > 2 else [9])
    if d == 12:
        return out + {1: [9], 2: [6, 9]}.get(cfg.additional_pos, [5, 8, 11])
    return out + {1: [11], 2: [7, 11]}.get(cfg.additional_pos, [5, 8, 11])


def sc_idx(cfg: DmrsPdschConfig) -> np.ndarray:
    """DMRS subcarrier indices within the allocation (delta=0, ports 1000/
    1001-equivalent CDM group 0, as the reference hardcodes)."""
    if cfg.type == 1:
        base = np.arange(0, NRE, 4)
        k = np.stack([base, base + 2], -1).reshape(-1)
    else:
        base = np.arange(0, NRE, 6)
        k = np.stack([base, base + 1], -1).reshape(-1)
    return (k[None, :] + NRE * np.arange(cfg.nof_prb)[:, None]).reshape(-1)


def _seed(cfg: DmrsPdschConfig, slot_idx: int, symbol_idx: int) -> int:
    # TS 38.211 §7.4.1.1.1 (dmrs_pdsch.c:227-232), on Python ints
    return int(
        (((MAX_NSYMB * slot_idx + symbol_idx + 1) * (2 * cfg.n_id + 1)) * (1 << 17)
         + (2 * cfg.n_id + cfg.n_scid)) & 0x7FFFFFFF
    )


def _pilots(cfg: DmrsPdschConfig, tti: int, symbol: int) -> np.ndarray:
    slot_idx = (tti % 10) * NOF_SLOTS_PER_SF
    n = len(sc_idx(cfg))
    signs = gold_sequence_signs(_seed(cfg, slot_idx, symbol), 2 * n)
    return ((signs[0::2] + 1j * signs[1::2]) * math.sqrt(0.5)).astype(np.complex64)


def _tables_np(cfg: DmrsPdschConfig, sf: int):
    """(symbols (S, 1) int64, subcarriers (K,) int64, pilots (S, K)
    complex64) of subframe sf of the frame."""
    syms = symbols_idx(cfg)
    pilots = np.stack([_pilots(cfg, sf, s) for s in syms])
    return np.asarray(syms, np.int64)[:, None], sc_idx(cfg).astype(np.int64), pilots


# one entry per (config, subframe of the frame, device) in use
_tables = sized_table(256)


def _grid(grid, device) -> torch.Tensor:
    if isinstance(grid, torch.Tensor):
        return grid
    return as_samples(grid, resolve(device))


def put_sf(cfg: DmrsPdschConfig, tti: int, grid, device=None) -> torch.Tensor:
    """Write the DMRS into grid (..., nsymb, nof_prb*12) and return it.  A
    tensor grid is written in place on its own device; a numpy grid is
    copied to `device` (None: the card) and the copy is written."""
    grid = _grid(grid, device)
    syms, k, pilots = _tables(_tables_np, cfg, tti % 10, device=grid.device)
    grid[..., syms, k] = pilots
    return grid


def get_sf(cfg: DmrsPdschConfig, tti: int, grid, device=None) -> torch.Tensor:
    """Least-squares channel estimates at the DMRS REs of grid
    (..., nsymb, nof_prb*12): (..., nof_symbols, nof_sc) complex64, on the
    grid's device (a numpy grid goes to `device`, None: the card)."""
    grid = _grid(grid, device)
    syms, k, pilots = _tables(_tables_np, cfg, tti % 10, device=grid.device)
    return grid[..., syms, k] * pilots.conj()
