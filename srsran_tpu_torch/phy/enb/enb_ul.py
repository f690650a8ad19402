"""eNB uplink receive facade — UL FFT, PUSCH decode, PUCCH decode (PRACH is
`phch.prach.prach_detect`, the SRS `chest.srs.srs_estimate`).

Counterpart of `srsran_tpu/phy/enb/enb_ul.py` (`lib/src/phy/enb/enb_ul.c`,
enb_ul.h:66-86): the UL FFT with the -0.5 subcarrier shift, the DMRS channel
estimate and the per-UE channel decodes, on the device of the grid.  A
PUCCH resource's PRB-local block is cut out of each slot on the device; the
format-1 decode then runs on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_samples, resolve
from ..chest.chest_ul import chest_ul
from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_rx_sf
from ..phch.pucch import (
    PucchConfig,
    _f1_covers,
    pucch_f1_prb,
    pucch_format1_decode,
    pucch_format2_decode,
    pucch_format3_decode,
)
from ..phch.pusch import UciCfg, UlGrant, pusch_decode


def enb_ul_fft(cell: Cell, samples, *, device=None) -> torch.Tensor:
    """(nrx, sf_len) samples (numpy or a tensor) → (nrx, nsymb, nre)
    complex64 grid with the -0.5 subcarrier shift, on `device` (None: the
    card)."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    return ofdm_rx_sf(ofdm, as_samples(samples, resolve(device)))


def enb_ul_decode_pusch(cell: Cell, sf_idx: int, rx_grid, grant: UlGrant,
                        max_iterations: int = 5, softbuffers=None, uci: UciCfg | None = None,
                        shortened: bool = False, *, device=None):
    """Decode one PUSCH from a (nrx, nsymb, nre) grid on `device` (None: the
    card).  Returns (tb_bits, crc_ok, softbuffers, snr_db), and with `uci`
    (the expected UCI sizes) a 5th element, the decoded UCI dict."""
    dev = resolve(device)
    grid = as_samples(rx_grid, dev)
    ce, noise = chest_ul(grid, cell, grant.prb_start, grant.nof_prb)
    noise = torch.mean(noise)
    out = pusch_decode(grid, ce, noise, cell, sf_idx, grant, max_iterations, softbuffers,
                       uci=uci, shortened=shortened, device=dev)
    sig, noise_f = torch.stack([torch.mean(ce.abs() ** 2), noise]).cpu().tolist()
    snr_db = 10 * np.log10(sig / (noise_f + 1e-12))
    return (*out[:3], snr_db, *out[3:])


def enb_ul_decode_pucch(cell: Cell, sf_idx: int, rx_grid, cfg: PucchConfig, fmt: str,
                        nof_bits: int, rnti: int = 0, *, device=None):
    """Decode one PUCCH resource of antenna 0: fmt '1' | '2' | '3' (format
    3 needs `rnti` for its scrambling).  Every format sits at
    `pucch_f1_prb(n_pucch)` of each slot, as in the reference.  Returns
    (bits, metric): numpy for format 1, tensors on `device` (None: the card)
    for formats 2 and 3."""
    grid = as_samples(rx_grid, resolve(device))
    nsym = cell.nsymb_per_slot
    rows = []
    for slot in range(2):
        m = pucch_f1_prb(cfg.n_pucch, 2 * sf_idx + slot, cell.nof_prb, cfg.delta_shift,
                         covers=_f1_covers(cell))
        rows.append(grid[0, slot * nsym : (slot + 1) * nsym, m * 12 : (m + 1) * 12])
    prb_local = torch.cat(rows)  # (nsymb_sf, 12)
    if fmt == "1":
        return pucch_format1_decode(prb_local.cpu().numpy(), cell, cfg, sf_idx, nof_bits)
    if fmt == "3":
        return pucch_format3_decode(prb_local, cell, cfg, sf_idx, nof_bits, rnti=rnti)
    return pucch_format2_decode(prb_local, cell, cfg, sf_idx, nof_bits)
