"""UE uplink transmit facade — PUSCH generation with timing advance and CFO.

Counterpart of `ue_ul_encode` of `srsran_tpu/phy/ue/ue_ul.py` for the
`pusch`, `ta_samples` and `cfo` arguments: the host grid of
`pusch_encode_np`, then `ofdm_tx_sf` with the +0.5 subcarrier shift.  The
PUCCH, SRS, UCI and PRACH arguments are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_tx_sf
from ..phch.pusch import UlGrant, pusch_encode_np


def ue_ul_encode(cell: Cell, sf_idx: int, pusch: tuple[UlGrant, np.ndarray] | None = None,
                 ta_samples: int = 0, cfo: float = 0.0) -> np.ndarray:
    """Render one UL subframe → (sf_len,) complex64 samples (half-subcarrier
    shifted).  `ta_samples` advances the transmission (positive = earlier);
    `cfo` is a frequency offset in subcarriers."""
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    if pusch is not None:
        grant, tb = pusch
        grid += pusch_encode_np(cell, sf_idx, grant, tb)
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5)
    samples = ofdm_tx_sf(ofdm, torch.from_numpy(grid)).numpy()
    if cfo:
        n = np.arange(len(samples))
        samples = samples * np.exp(-2j * np.pi * cfo * n / cell.symbol_sz)
    if ta_samples:
        samples = np.roll(samples, -ta_samples)
    return samples.astype(np.complex64)
