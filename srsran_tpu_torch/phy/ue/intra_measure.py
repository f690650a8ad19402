"""Intra-frequency neighbour-cell search and measurement.

Counterpart of `srsran_tpu/phy/ue/intra_measure.py`
(`srsue/src/phy/scell/intra_measure.cc` + `scell_recv.cc`): one batched
correlation of the three PSS roots over the capture, per-root peaks,
each candidate's N_id_1 from the SSS, and CRS-based RSRP/RSRQ at its frame
timing — the inputs RRC needs for `new_cell_meas`.  The correlation, the
peak search, OFDM, SSS and the channel estimate run on the device; the
candidate loop reads back one peak at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve, table
from ..chest.chest_dl import chest_dl
from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_rx_sf
from ..sync.pss import pss_cfo_estimate, pss_correlate
from ..sync.sss import sss_detect
from .ue_sync import _pss_ref_conj, _read, apply_cfo, as_samples


@dataclasses.dataclass
class CellMeas:
    """One neighbour measurement (ue_interfaces.h phy_meas_t)."""

    pci: int
    rsrp_dbfs: float
    rsrq_db: float
    cfo: float
    peak_offset: int
    psr: float


def measure_cells(samples, nof_prb: int = 6, serving_pci: int | None = None,
                  threshold: float = 6.0, max_cells: int = 4, min_sss_metric: float = 4.0,
                  min_crs_snr_db: float = 3.0, *, device=None) -> list[CellMeas]:
    """Scan ≥ 6 ms of samples for neighbour cells on `device` (None: the
    card); returns measurements sorted by RSRP, strongest first.

    A candidate must pass the SSS detection metric and a CRS-coherence SNR
    gate: a PSS peak alone is not a cell (a wrong PCI's CRS decorrelates)."""
    x = as_samples(samples, resolve(device))
    cell0 = Cell(nof_prb=nof_prb, nof_ports=1, id=0)
    sz = cell0.symbol_sz
    corr_all = pss_correlate(x, sz) ** 2  # (3, n)
    avg = float(torch.mean(corr_all))
    ofdm = OfdmConfig.from_cell(cell0, normalize=True)
    pss_pos = ofdm.symbol_starts()[cell0.nsymb_per_slot - 1]
    k0 = cell0.nof_re_per_symbol // 2 - 31
    n = x.shape[-1]
    out: list[CellMeas] = []
    for n_id_2 in range(3):
        corr = corr_all[n_id_2].clone()
        for _ in range(max_cells):
            offset, peak = _read(torch.argmax(corr), torch.max(corr))
            offset = int(offset)
            psr = peak / (avg + 1e-12)
            if psr < threshold:
                break
            corr[max(0, offset - 64) : offset + 64] = 0.0  # null this peak
            if n - offset < sz:
                continue
            cfo = float(pss_cfo_estimate(x[offset : offset + sz], n_id_2, sz))
            sf_start = offset - pss_pos
            if sf_start < 0 or sf_start + cell0.sf_len > n:
                continue
            comp = apply_cfo(x[sf_start : sf_start + cell0.sf_len], cfo, sz, n0=sf_start)
            grid = ofdm_rx_sf(ofdm, comp)
            sss_re = grid[cell0.nsymb_per_slot - 2, k0 : k0 + 62]
            ce = grid[cell0.nsymb_per_slot - 1, k0 : k0 + 62] * table(
                _pss_ref_conj, n_id_2, device=x.device)
            nid1, sf_is_5, sss_metric = _read(*sss_detect(sss_re, n_id_2, ce=ce))
            if sss_metric < min_sss_metric:
                continue
            pci = 3 * int(nid1) + n_id_2
            if pci == serving_pci:
                continue
            # CRS-based RSRP/RSRQ at the detected timing (sf 0 or 5)
            ch = chest_dl(grid[None], Cell(nof_prb=nof_prb, nof_ports=1, id=pci),
                          5 if sf_is_5 else 0, nof_ports=1)
            rsrp, noise, rssi = _read(ch["rsrp"].mean(), ch["noise"].mean(),
                                      torch.mean(grid.abs() ** 2))
            if rsrp < noise * 10 ** (min_crs_snr_db / 10):
                continue  # CRS does not cohere at this PCI/timing
            rssi *= 12 * nof_prb
            out.append(CellMeas(
                pci=pci, rsrp_dbfs=10.0 * np.log10(rsrp + 1e-12),
                rsrq_db=10.0 * np.log10(nof_prb * rsrp / (rssi + 1e-12) + 1e-12),
                cfo=cfo, peak_offset=offset, psr=psr))
    best: dict[int, CellMeas] = {}  # the strongest measurement of each PCI
    for m in out:
        if m.pci not in best or m.rsrp_dbfs > best[m.pci].rsrp_dbfs:
            best[m.pci] = m
    return sorted(best.values(), key=lambda m: -m.rsrp_dbfs)
