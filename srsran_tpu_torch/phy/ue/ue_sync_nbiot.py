"""NB-IoT sample-level acquisition (counterpart of
`srsran_tpu/phy/ue/ue_sync_nbiot.py`: `ue_sync_nbiot.c` +
`ue_cell_search_nbiot.c` + `lib/examples/cell_search_nbiot.c`).

From raw baseband of the anchor carrier at 1.92 Msps (128-point FFT, one
180 kHz PRB): NPSS time-domain correlation gives the subframe-5 timing, the
NPSS's repeated-symbol structure gives the CFO, and only then are OFDM
grids demodulated for NSSS / MIB-NB through the grid-level chain
(`ue_nbiot.nbiot_ue_acquire`); plus the EARFCN scan loop.

The modulator (the transmitter of tests and examples) and the NPSS replica
are host copies; the correlation, the CFO estimate, the CFO correction and
the demodulator run on the device.  The NPSS search is one FFT correlation
folded over the 10 ms period, and its peak, peak-to-sidelobe ratio and the
CFO at that peak come back in one host read.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..sync.nbiot import NPSS_COVER, npss_freq_np
from ..sync.pss import PSS_TIE_RTOL

FFT = 128
SRATE = 1920000
SF_LEN = 1920
CP0, CP = 10, 9  # CP lengths at the 128-sample symbol (slot = 960)
SYM_STARTS = []  # per-subframe start of each symbol's useful part
_t = 0
for _l in range(14):
    _t += CP0 if _l % 7 == 0 else CP
    SYM_STARTS.append(_t)
    _t += FFT
assert _t == SF_LEN
NPSS_START = SYM_STARTS[3] - CP  # replica includes symbol 3's CP
NPSS_LEN = SF_LEN - NPSS_START
PERIOD = 10 * SF_LEN  # the NPSS repeats every frame


def _sc_map() -> np.ndarray:
    """FFT bins of the 12 anchor subcarriers (centered PRB)."""
    return np.arange(-6, 6) % FFT


def nbiot_modulate_np(grids: np.ndarray) -> np.ndarray:
    """(nsf, 14, 12) grids → (nsf*1920,) samples at 1.92 Msps."""
    nsf = grids.shape[0]
    out = np.zeros((nsf, SF_LEN), np.complex64)
    bins = _sc_map()
    for s in range(nsf):
        for l in range(14):
            f = np.zeros(FFT, np.complex64)
            f[bins] = grids[s, l]
            td = np.fft.ifft(f) * np.sqrt(FFT)
            cp = CP0 if l % 7 == 0 else CP
            st = SYM_STARTS[l]
            out[s, st - cp : st] = td[-cp:]
            out[s, st : st + FFT] = td
    return out.reshape(-1)


def nbiot_demodulate_np(samples: np.ndarray, offset: int = 0) -> np.ndarray:
    """`nbiot_demodulate` on the host: samples (aligned at a subframe
    boundary + `offset`) → (nsf, 14, 12) grids."""
    x = samples[offset:]
    nsf = len(x) // SF_LEN
    bins = _sc_map()
    out = np.zeros((nsf, 14, 12), np.complex64)
    for s in range(nsf):
        sf = x[s * SF_LEN : (s + 1) * SF_LEN]
        for l in range(14):
            st = SYM_STARTS[l]
            out[s, l] = (np.fft.fft(sf[st : st + FFT]) / np.sqrt(FFT))[bins]
    return out


def _demod_index() -> np.ndarray:
    """(14, FFT) sample index of each symbol's FFT window in a subframe."""
    return (np.asarray(SYM_STARTS)[:, None] + np.arange(FFT)[None, :]).astype(np.int64)


def nbiot_demodulate(samples: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Samples (aligned at a subframe boundary + `offset`) → (nsf, 14, 12)
    grids, on the samples' device: one gather of every symbol window and
    one batched 128-point FFT."""
    x = samples[offset:]
    nsf = x.shape[-1] // SF_LEN
    sf = x[: nsf * SF_LEN].reshape(nsf, SF_LEN)
    bins = torch.fft.fft(sf[:, table(_demod_index, device=samples.device)], dim=-1) / np.sqrt(FFT)
    return bins[..., table(_sc_map, device=samples.device)]


@lru_cache(maxsize=1)
def npss_time_np() -> np.ndarray:
    """Time-domain NPSS replica: symbols 3..13 of subframe 5 with CPs
    (`npss.c` builds the same by OFDM-modulating the NPSS grid)."""
    grid = np.zeros((1, 14, 12), np.complex64)
    seq = npss_freq_np()
    for i in range(11):
        grid[0, 3 + i, :11] = seq[i]
    sf = nbiot_modulate_np(grid)
    return sf[NPSS_START:SF_LEN].astype(np.complex64)


def _replica_spectrum(nfft: int) -> np.ndarray:
    return np.conj(np.fft.fft(npss_time_np(), nfft)).astype(np.complex64)


def _cfo_tables():
    """(11, FFT) offsets of the 11 NPSS symbols' useful parts from the
    replica's start, and the cover-code signs of the 10 neighbour pairs."""
    lag = FFT + CP
    offs = (CP + np.arange(11)[:, None] * lag + np.arange(FFT)[None, :]).astype(np.int64)
    return offs, (NPSS_COVER[:-1] * NPSS_COVER[1:]).astype(np.float32)


def _npss_sync(x: torch.Tensor):
    """NPSS timing and CFO of a capture (n,) on the device, as tensors:
    (peak: the first sample where the replica aligns — subframe 5's
    symbol-3 CP start — at its strongest occurrence; the peak-to-sidelobe
    ratio of the correlation folded over the 10 ms period (`npss.c`
    srslte_npss_synch_find + peak checking); the CFO in subcarriers from the
    lag-137 products of neighbouring NPSS symbols, signs compensated by the
    cover code (`ue_sync_nbiot.c` CFO tracking role))."""
    n = x.shape[-1]
    m = NPSS_LEN
    nfft = int(2 ** np.ceil(np.log2(n + m)))
    dev = x.device
    corr = torch.abs(torch.fft.ifft(torch.fft.fft(x, nfft) * table(_replica_spectrum, nfft, device=dev)))
    corr = corr[: n - m + 1]
    nper = corr.shape[0] // PERIOD
    folded = corr[: nper * PERIOD].reshape(nper, PERIOD).mean(dim=0) if nper >= 1 else corr
    length = folded.shape[0]
    peak = torch.argmax(folded)
    guard = FFT + CP
    dist = torch.remainder(torch.arange(length, device=dev) - peak + guard, length)
    side = torch.amax(torch.where(dist >= 2 * guard, folded, 0.0))
    psr = folded[peak] / torch.clamp(side, min=1e-12)
    # absolute position: the strongest single occurrence of the folded peak
    # (a partially captured first frame must not anchor the CFO estimator on
    # padding); occurrences within PSS_TIE_RTOL of the strongest tie and the
    # earliest wins (equal peaks of a periodic stream differ by rounding)
    cand = peak + PERIOD * torch.arange(max(nper, 1), device=dev)
    vals = torch.where(cand < corr.shape[0], corr[torch.clamp(cand, max=corr.shape[0] - 1)], -1.0)
    first = torch.argmax((vals >= torch.amax(vals) * (1 - PSS_TIE_RTOL)).to(torch.uint8))
    abs_peak = cand[first]
    return abs_peak, psr, _npss_cfo(x, abs_peak)


def _npss_cfo(x: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    offs, signs = table(_cfo_tables, device=x.device)
    n = x.shape[-1]
    pos = peak + offs  # (11, FFT)
    valid = pos[1:, -1] < n  # the reference stops at the first short symbol
    syms = x[torch.clamp(pos, max=n - 1)]
    z = torch.sum(torch.conj(syms[:-1]) * syms[1:], dim=-1) * signs
    z = torch.sum(torch.where(valid, z, 0.0))
    return torch.angle(z) / (2.0 * np.pi * (FFT + CP) / FFT)


def npss_find(samples: torch.Tensor):
    """(peak_pos, psr) of a capture on its device (see `_npss_sync`); one
    host read."""
    peak, psr, _cfo = _npss_sync(samples)
    out = torch.stack([peak.to(torch.float64), psr.to(torch.float64)]).cpu()
    return int(out[0]), float(out[1])


def npss_cfo_estimate(samples: torch.Tensor, peak: int) -> float:
    """CFO normalized to the 15 kHz subcarrier spacing from the NPSS at
    `peak` (see `_npss_sync`)."""
    return float(_npss_cfo(samples, torch.tensor(peak, device=samples.device)))


@dataclasses.dataclass
class NbiotSyncResult:
    cell: object          # ue_nbiot.NbiotCell
    timing: int           # sample index of the acquired frame's sf 0
    cfo: float            # normalized to 15 kHz
    psr: float
    grids: torch.Tensor   # (nsf, 14, 12) CFO-corrected aligned grids


def nbiot_acquire_raw(samples, min_psr: float = 3.0, *, device=None):
    """Full raw acquisition on `device` (None: the card): NPSS timing → CFO
    correct → demodulate aligned grids → NSSS cell id / frame phase →
    MIB-NB (`ue_cell_search_nbiot.c` + `ue_mib_nbiot.c` flow from samples).

    samples: numpy or a tensor, ≥ 21 ms (two NPSS occasions + NSSS).
    Returns NbiotSyncResult or None."""
    from .ue_nbiot import nbiot_ue_acquire

    device = resolve(device)
    x = as_samples(samples, device)
    if x.shape[-1] < 21 * SF_LEN:
        return None
    peak, psr, cfo = _npss_sync(x)
    peak, psr, cfo = torch.stack([peak.to(torch.float64), psr.to(torch.float64),
                                  cfo.to(torch.float64)]).cpu().tolist()
    if psr < min_psr:
        return None
    n = torch.arange(x.shape[-1], device=device, dtype=torch.float64)
    corr = x * torch.exp(-2j * np.pi * cfo * n / FFT).to(torch.complex64)
    # the replica aligns at subframe 5's symbol-3 CP; subframe 5 starts
    # NPSS_START earlier, the frame 5 subframes before that
    frame0 = int(peak) - NPSS_START - 5 * SF_LEN
    while frame0 < 0:
        frame0 += PERIOD
    grids = nbiot_demodulate(corr, frame0)
    if grids.shape[0] < 10:
        return None
    cell = nbiot_ue_acquire(grids, device=device)
    if cell is None:
        return None
    return NbiotSyncResult(cell, frame0, cfo, psr, grids)


def nbiot_cell_search_scan(capture_by_earfcn: dict, min_psr: float = 3.0, *, device=None):
    """EARFCN scan (the `cell_search_nbiot.c` example loop): raw acquisition
    on each carrier's capture; [(earfcn, NbiotSyncResult)] for every carrier
    with a cell."""
    found = []
    for earfcn, samples in capture_by_earfcn.items():
        res = nbiot_acquire_raw(samples, min_psr, device=device)
        if res is not None:
            found.append((earfcn, res))
    return found
