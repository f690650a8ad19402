"""CRS-based fine synchronisation and cell validation.

Counterpart of `srsran_tpu/phy/sync/refsignal_dl_sync.py`
(`lib/src/phy/sync/refsignal_dl_sync.c`).  PSS/SSS find a cell; this
validates it by correlating the capture with the cell's own reference
signature, the 10 time-domain subframe replicas carrying its CRS (+ PSS/SSS
on subframes 0 and 5): a wrong PCI's CRS decorrelates, a real cell tracks.

On the device of the capture: the frame boundary from ONE FFT product of the
capture with the subframe-0 replica (`find_peak` :301-336), then every
subframe from the peak on through one batched `ofdm_rx_sf` and the CRS
products (RSRP, RSSI, CFO, the SSS strengths against the other sync
subframe's replica, the RSRP at the off-by-one subframe index), read back
in one copy.  The false-alarm gates of :448-470 run on the host, in the
reference's order.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..chest.refsignal_dl import crs_positions, crs_sequence_port, put_crs_np
from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_rx_sf, ofdm_tx_sf
from .pss import put_pss_grid
from .sss import put_sss_grid

# false-alarm thresholds (refsignal_dl_sync.c:37-45)
SSS_FALSE_RATIO_SEVERE = 2.0
SSS_FALSE_RATIO_MILD = 1.2
CFO_SPREAD_SEVERE_HZ = 1000.0
CFO_SPREAD_MILD_HZ = 100.0
RSRP_SPREAD_SEVERE_DB = 10.0
RSRP_SPREAD_MILD_DB = 5.0
RSRP_FALSE_SEVERE_DB = 2.0
RSRP_FALSE_MILD_DB = 5.0


@lru_cache(maxsize=16)
def _cell_sequences(cell: Cell) -> np.ndarray:
    """(10, sf_len) complex64 time-domain replicas: CRS (port 0) + PSS/SSS,
    modulated on the host."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    sync_sym = cell.nsymb_per_slot - 1  # PSS symbol (FDD: slot 0/10 last)
    grid = np.zeros((10, 1, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    for sf in range(10):
        put_crs_np(grid[sf], cell, sf)
        if sf in (0, 5):
            put_pss_grid(grid[sf, 0], cell.id % 3, cell.nof_prb, sync_sym)
            put_sss_grid(grid[sf, 0], cell.id // 3, cell.id % 3, sf, cell.nof_prb, sync_sym - 1)
    return ofdm_tx_sf(ofdm, torch.from_numpy(grid)).numpy()[:, 0]


def _crs_tables(cell: Cell):
    """(flat indices (4, 2*nof_prb) of the port-0 CRS in a subframe grid,
    conjugated CRS values of every subframe (10, 4, 2*nof_prb))."""
    syms, freqs = crs_positions(cell, 0)
    flat = (syms[:, None] * cell.nof_re_per_symbol + freqs).astype(np.int64)
    return flat, np.conj(np.stack([crs_sequence_port(cell, sf, 0) for sf in range(10)]))


@dataclasses.dataclass
class RefsignalSyncResult:
    found: bool
    false_alarm: bool
    peak_index: int       # sample index of the frame boundary (sf 0)
    rsrp_dbfs: float
    rssi_dbfs: float
    cfo_hz: float
    psr: float            # peak-to-rms of the correlation


def _measure(x: torch.Tensor, cell: Cell, peak: int) -> dict:
    """Per-subframe CRS measurements of every whole subframe from `peak`,
    on the capture's device, read back in one copy: rsrp, rssi and cfo per
    subframe; SSS true / false strength and the off-by-one RSRP per sync
    subframe."""
    dev = x.device
    sf_len, sz = cell.sf_len, cell.symbol_sz
    pos = np.arange(peak, x.shape[-1] - sf_len + 1, sf_len)
    sf_idx = np.arange(len(pos)) % 10
    win = x[torch.from_numpy(pos[:, None] + np.arange(sf_len)).to(dev)]
    grid = ofdm_rx_sf(OfdmConfig.from_cell(cell, normalize=True), win)  # (K, nsymb, nre)
    flat, refs = table(_crs_tables, cell, device=dev)
    pil = grid.reshape(len(pos), -1)[:, flat]  # (K, 4, npil)
    ls = pil * refs[torch.from_numpy(sf_idx).to(dev)]
    rsrp = torch.mean(ls, dim=(-1, -2)).abs() ** 2
    rssi = torch.mean(grid.abs() ** 2, dim=(-1, -2))
    # CFO: phase between the slot's two CRS symbols, 4 symbols apart
    cps = cell.cp_lengths_slot()
    z = torch.sum(ls[:, 1] * torch.conj(ls[:, 0]), -1) + torch.sum(ls[:, 3] * torch.conj(ls[:, 2]), -1)
    dt = 4 * (sz + cps[1]) / cell.srate
    cfo = torch.angle(z) / (2 * np.pi * dt)
    rows = [rsrp, rssi, cfo]
    sync = np.nonzero((sf_idx == 0) | (sf_idx == 5))[0]
    if len(sync):
        # SSS strength against the false hypothesis (the OTHER sync
        # subframe's replica: a frame-offset false peak correlates with it)
        sync_sym = cell.nsymb_per_slot - 2
        st = sum(cps[i] + sz for i in range(sync_sym)) + cps[sync_sym]
        w = x[torch.from_numpy(pos[sync, None] + st + np.arange(sz)).to(dev)]  # (S, sz)
        seqs = table(_cell_sequences, cell, device=dev)[:, st : st + sz]
        s_idx = sf_idx[sync]
        for r in (seqs[torch.from_numpy(s_idx).to(dev)], seqs[torch.from_numpy((s_idx + 5) % 10).to(dev)]):
            rows.append(torch.sum(torch.conj(r) * w, -1).abs() ** 2)
        # RSRP at the off-by-one subframe index ("false" CRS phase)
        lsf = pil[torch.from_numpy(sync).to(dev)] * refs[torch.from_numpy((s_idx + 1) % 10).to(dev)]
        rows.append(torch.mean(lsf, dim=(-1, -2)).abs() ** 2)
    flat = torch.cat([r.to(torch.float64) for r in rows]).cpu().tolist()
    names = ("rsrp", "rssi", "cfo", "sss_true", "sss_false", "rsrp_false")
    out = dict.fromkeys(names, [])
    at = 0
    for name, r in zip(names, rows):
        out[name], at = flat[at : at + r.numel()], at + r.numel()
    return out


def refsignal_dl_sync_run(samples, cell: Cell, threshold: float = 2.0, *,
                          device=None) -> RefsignalSyncResult:
    """Find and validate `cell` in ≥ 1 frame of samples (numpy or a tensor),
    on `device` (None: the card) — `srslte_refsignal_dl_sync_run`
    :367-470."""
    x = as_samples(samples, resolve(device))
    sf_len = cell.sf_len
    n = x.shape[-1]
    # --- stage 1: the frame boundary from the sf-0 replica ---
    nfft = int(2 ** np.ceil(np.log2(n + sf_len)))
    r_f = torch.conj(torch.fft.fft(table(_cell_sequences, cell, device=x.device)[0], nfft))
    corr = torch.fft.ifft(torch.fft.fft(x, nfft) * r_f).abs()[: n - sf_len + 1]
    peak_t = torch.argmax(corr)
    peak, top, rms = torch.stack([peak_t.to(torch.float64), corr[peak_t].to(torch.float64),
                                  torch.sqrt(torch.mean(corr**2)).to(torch.float64)]).cpu().tolist()
    peak = int(peak)
    psr = top / max(rms, 1e-12)
    if psr < threshold:
        return RefsignalSyncResult(False, False, -1, float("nan"), float("nan"), float("nan"), psr)

    # --- stage 2: per-subframe CRS measurements over the capture ---
    m = _measure(x, cell, peak)
    rsrps, cfos = m["rsrp"], m["cfo"]
    n_sync = len(m["sss_true"])
    sss_true, sss_false, rsrp_false = (float(sum(m[k])) for k in ("sss_true", "sss_false",
                                                                   "rsrp_false"))
    rsrp = float(np.mean(rsrps))
    rsrp_db = 10 * np.log10(rsrp + 1e-20)
    spread_db = 10 * np.log10(max(rsrps) + 1e-20) - 10 * np.log10(min(rsrps) + 1e-20)
    cfo = float(np.mean(cfos))
    cfo_spread = max(cfos) - min(cfos)

    # --- stage 3: false-alarm gates (refsignal_dl_sync.c:448-470) ---
    false_count = 0
    false_alarm = False
    if n_sync:
        if sss_true < sss_false * SSS_FALSE_RATIO_SEVERE * 0.5:
            false_alarm = True
        elif sss_true < sss_false * SSS_FALSE_RATIO_MILD:
            false_count += 1
        rsrp_f_db = 10 * np.log10(rsrp_false / n_sync + 1e-20)
        if rsrp_db - rsrp_f_db < RSRP_FALSE_SEVERE_DB:
            false_alarm = True
        elif rsrp_db - rsrp_f_db < RSRP_FALSE_MILD_DB:
            false_count += 1
    if cfo_spread > CFO_SPREAD_SEVERE_HZ:
        false_alarm = True
    elif cfo_spread > CFO_SPREAD_MILD_HZ:
        false_count += 1
    if spread_db > RSRP_SPREAD_SEVERE_DB:
        false_alarm = True
    elif spread_db > RSRP_SPREAD_MILD_DB:
        false_count += 1
    if false_count >= 2:
        false_alarm = True

    return RefsignalSyncResult(not false_alarm, false_alarm, peak, rsrp_db,
                               10 * np.log10(np.mean(m["rssi"]) + 1e-20), cfo, psr)
