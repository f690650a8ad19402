"""UE uplink transmit facade — PUSCH and PUCCH generation with timing advance
and CFO.

Counterpart of `ue_ul_encode` of `srsran_tpu/phy/ue/ue_ul.py` for the
`pusch`, `pucch1`, `pucch2`, `pucch3`, `uci`, `ta_samples` and `cfo`
arguments: the host grid of `pusch_encode_np` (with UCI) and the PUCCH
blocks at their band-edge PRBs, then `ofdm_tx_sf` with the +0.5 subcarrier
shift.  The SRS argument and PRACH are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_tx_sf
from ..phch.pucch import (
    PucchConfig,
    _f1_covers,
    pucch_f1_prb,
    pucch_format1_encode_np,
    pucch_format2_encode_np,
    pucch_format3_encode_np,
)
from ..phch.pusch import UciCfg, UlGrant, pusch_encode_np


def _put_pucch(grid: np.ndarray, cell: Cell, sf_idx: int, cfg: PucchConfig, prb_local: np.ndarray):
    """Add a PRB-local (nsymb_sf, 12) block at the resource's PRB of each slot."""
    for slot in range(2):
        m = pucch_f1_prb(cfg.n_pucch, 2 * sf_idx + slot, cell.nof_prb, cfg.delta_shift,
                         covers=_f1_covers(cell))
        sl = slice(slot * cell.nsymb_per_slot, (slot + 1) * cell.nsymb_per_slot)
        grid[sl, m * 12 : (m + 1) * 12] += prb_local[sl]


def ue_ul_encode(cell: Cell, sf_idx: int, pusch: tuple[UlGrant, np.ndarray] | None = None,
                 pucch1: tuple[PucchConfig, list] | None = None,
                 pucch2: tuple[PucchConfig, np.ndarray] | None = None,
                 ta_samples: int = 0, cfo: float = 0.0, uci: UciCfg | None = None,
                 srs: tuple[int, int] | None = None,
                 pucch3: tuple[PucchConfig, np.ndarray, int] | None = None) -> np.ndarray:
    """Render one UL subframe → (sf_len,) complex64 samples (half-subcarrier
    shifted).  `uci` rides the PUSCH; `pucch1` / `pucch2` are (config,
    payload bits), `pucch3` (config, bits, rnti).  `ta_samples` advances the
    transmission (positive = earlier); `cfo` is a frequency offset in
    subcarriers."""
    if srs is not None:
        raise NotImplementedError("the SRS is not ported")
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    if pusch is not None:
        grant, tb = pusch
        grid += pusch_encode_np(cell, sf_idx, grant, tb, uci=uci)
    if pucch3 is not None:
        cfg3, bits3, rnti3 = pucch3
        _put_pucch(grid, cell, sf_idx, cfg3, pucch_format3_encode_np(cell, cfg3, sf_idx, bits3, rnti3))
    for item, enc in ((pucch1, pucch_format1_encode_np), (pucch2, pucch_format2_encode_np)):
        if item is not None:
            cfg, payload = item
            _put_pucch(grid, cell, sf_idx, cfg, enc(cell, cfg, sf_idx, payload))
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5)
    samples = ofdm_tx_sf(ofdm, torch.from_numpy(grid)).numpy()
    if cfo:
        n = np.arange(len(samples))
        samples = samples * np.exp(-2j * np.pi * cfo * n / cell.symbol_sz)
    if ta_samples:
        samples = np.roll(samples, -ta_samples)
    return samples.astype(np.complex64)
