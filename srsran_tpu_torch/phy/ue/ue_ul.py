"""UE uplink transmit facade — PUSCH, PUCCH, SRS and PRACH generation with
timing advance and CFO.

Counterpart of `srsran_tpu/phy/ue/ue_ul.py`.  `ue_ul_encode` builds the
grid on the host (`pusch_encode_np` with UCI, shortened on an SRS subframe;
the SRS; the PUCCH blocks at their band-edge PRBs), then runs `ofdm_tx_sf`
with the +0.5 subcarrier shift, the CFO rotation and the timing-advance roll
on the device.  `ue_prach_send` moves the host preamble of
`prach_generate_np` to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve
from ..chest.srs import put_srs_np
from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_tx_sf
from ..phch.prach import PrachConfig, prach_generate_np
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
                 pucch3: tuple[PucchConfig, np.ndarray, int] | None = None, *,
                 device=None) -> torch.Tensor:
    """Render one UL subframe → (sf_len,) complex64 samples (half-subcarrier
    shifted) on `device` (None: the card).  `uci` rides the PUSCH; `srs` =
    (prb_start, nof_prb) sounds the last SC-FDMA symbol, and a PUSCH in the
    same subframe then takes the shortened format (TS 36.211 §5.5.3.3);
    `pucch1` / `pucch2` are (config, payload bits), `pucch3` (config, bits,
    rnti).  `ta_samples` advances the transmission (positive = earlier);
    `cfo` is a frequency offset in subcarriers."""
    dev = resolve(device)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    if pusch is not None:
        grant, tb = pusch
        grid += pusch_encode_np(cell, sf_idx, grant, tb, uci=uci, shortened=srs is not None)
    if srs is not None:
        put_srs_np(grid, cell, srs[0], srs[1])
    if pucch3 is not None:
        cfg3, bits3, rnti3 = pucch3
        _put_pucch(grid, cell, sf_idx, cfg3, pucch_format3_encode_np(cell, cfg3, sf_idx, bits3, rnti3))
    for item, enc in ((pucch1, pucch_format1_encode_np), (pucch2, pucch_format2_encode_np)):
        if item is not None:
            cfg, payload = item
            _put_pucch(grid, cell, sf_idx, cfg, enc(cell, cfg, sf_idx, payload))
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5)
    samples = ofdm_tx_sf(ofdm, torch.from_numpy(grid).to(dev))
    if cfo:
        # float64 phase and product, as the reference's numpy rotation
        n = torch.arange(samples.shape[-1], device=dev, dtype=torch.float64)
        rot = torch.polar(torch.ones_like(n), (-2.0 * np.pi * cfo) * n / cell.symbol_sz)
        samples = (samples.to(torch.complex128) * rot).to(torch.complex64)
    if ta_samples:
        samples = torch.roll(samples, -ta_samples)
    return samples


def ue_prach_send(cell: Cell, cfg: PrachConfig, preamble_idx: int, ta_samples: int = 0, *,
                  device=None) -> torch.Tensor:
    """The preamble's (CP + sequence) complex64 samples, built on the host,
    advanced by `ta_samples` on `device` (None: the card)."""
    p = torch.from_numpy(prach_generate_np(cell, cfg, preamble_idx)).to(resolve(device))
    if ta_samples:
        p = torch.roll(p, -ta_samples)
    return p
