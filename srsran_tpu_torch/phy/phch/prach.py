"""PRACH: preamble generation and detection, TS 36.211 §5.7 (format 0).

Counterpart of `srsran_tpu/phy/phch/prach.py`.  Host numpy, as the
reference: `PrachConfig`, the Zadoff-Chu roots in logical order with the
cyclic shift of each of the 64 preambles (`_roots_and_shifts`), the root
spectra, the sizes at the cell's sample rate, the 839 PRACH bins inside the
800 us FFT (`_freq_map`) and the transmitter `prach_generate_np` (zero-padded
IFFT of the shifted root's spectrum, then the CP).

`prach_detect` runs on the device of its samples: FFT of the sequence
window, the 839 bins, a multiply by the conjugate root spectra, one
(R, 839) x (839, 839) IDFT product for every root at once, |.|², one
(64, n_cs) gather of every preamble's zone, the peak over the zone against
the root's mean power, and the threshold.  The tables move to a device once
per (cell, config).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..common import Cell
from .prach_data import NCS_UNRESTRICTED, ZC_ROOT_ORDER

NZC = 839
DELTA_F_RA = 1250.0  # PRACH subcarrier spacing [Hz]
TSEQ_S = 24576 / 30.72e6  # format 0 sequence duration (800 us)
TCP_S = 3168 / 30.72e6  # format 0 CP (103.13 us)


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    root_seq_index: int = 0  # RACH_ROOT_SEQUENCE (logical)
    zero_corr_zone: int = 1  # zeroCorrelationZoneConfig (unrestricted)
    freq_offset: int = 0  # prach-FrequencyOffset (PRB)
    nof_preambles: int = 64

    @property
    def n_cs(self) -> int:
        return NCS_UNRESTRICTED[self.zero_corr_zone]


@lru_cache(maxsize=64)
def _roots_and_shifts(cfg: PrachConfig):
    """Physical roots + per-preamble (root_idx, shift) for the preambles."""
    n_cs = cfg.n_cs
    shifts_per_root = NZC // n_cs if n_cs > 0 else 1
    pre = []
    roots = []
    logical = cfg.root_seq_index
    while len(pre) < cfg.nof_preambles:
        roots.append(ZC_ROOT_ORDER[logical % 838])
        for v in range(shifts_per_root):
            if len(pre) >= cfg.nof_preambles:
                break
            pre.append((len(roots) - 1, v * n_cs))
        logical += 1
    return tuple(roots), tuple(pre)


@lru_cache(maxsize=256)
def zc_freq_np(u: int) -> np.ndarray:
    """DFT of the root ZC sequence u, normalised by 1/sqrt(839)."""
    n = np.arange(NZC)
    x = np.exp(-1j * np.pi * u * n * (n + 1) / NZC)
    return np.fft.fft(x).astype(np.complex64) / np.sqrt(NZC)


def prach_nfft(cell: Cell) -> int:
    """Time samples of the 800 us sequence at the cell's sample rate."""
    return int(round(cell.srate * TSEQ_S))


def prach_cp_len(cell: Cell) -> int:
    return int(round(cell.srate * TCP_S))


@lru_cache(maxsize=64)
def _freq_map(cell: Cell, cfg: PrachConfig) -> np.ndarray:
    """Indices of the 839 PRACH bins inside the length-`prach_nfft` FFT,
    whose bins are 1.25 kHz apart: the first PRACH subcarrier sits 7.5 kHz
    (phi = 7 bins) above the edge of the 6 PRB at `freq_offset`."""
    nfft = prach_nfft(cell)
    k_0 = cfg.freq_offset * 12 - cell.nof_prb * 6  # in 15 kHz units, from DC
    k0_ra = int(k_0 * 12 + 7)
    return ((k0_ra + np.arange(NZC)) % nfft).astype(np.int32)


def prach_generate_np(cell: Cell, cfg: PrachConfig, preamble_idx: int) -> np.ndarray:
    """Host: the time-domain preamble (CP + sequence) at the cell's sample
    rate, complex64."""
    roots, pre = _roots_and_shifts(cfg)
    root_i, shift = pre[preamble_idx]
    u = roots[root_i]
    n = np.arange(NZC)
    x = np.exp(-1j * np.pi * u * ((n + shift) % NZC) * (((n + shift) % NZC) + 1) / NZC)
    xf = np.fft.fft(x) / np.sqrt(NZC)
    nfft = prach_nfft(cell)
    grid = np.zeros(nfft, np.complex64)
    grid[_freq_map(cell, cfg)] = xf.astype(np.complex64)
    seq = np.fft.ifft(grid) * np.sqrt(nfft)
    cp = prach_cp_len(cell)
    return np.concatenate([seq[-cp:], seq]).astype(np.complex64)


def _idft839() -> np.ndarray:
    n = np.arange(NZC)
    return (np.exp(2j * np.pi * np.outer(n, n) / NZC) / np.sqrt(NZC)).astype(np.complex64)


def _detect_tables(cell: Cell, cfg: PrachConfig):
    """(bins (839,), conjugate root spectra (R, 839), root of each preamble
    (64,), zone of each preamble (64, n_cs)).  A preamble with cyclic shift
    s and a delay of d ZC samples peaks at profile index (d - s) mod 839, so
    preamble v's zone is [839 - s, 839 - s + n_cs) and its delay the index
    in it."""
    roots, pre = _roots_and_shifts(cfg)
    rootmat = np.stack([np.conj(zc_freq_np(u)) for u in roots]).astype(np.complex64)
    root_idx = np.array([r for r, _ in pre], np.int64)
    zone_idx = np.stack([((NZC - s) % NZC + np.arange(cfg.n_cs)) % NZC
                         for _, s in pre]).astype(np.int64)
    return _freq_map(cell, cfg).astype(np.int64), rootmat, root_idx, zone_idx


def prach_detect(cell: Cell, cfg: PrachConfig, samples, threshold: float = 15.0, *,
                 device=None):
    """Detect preambles in a window that starts at the PRACH sequence (CP
    already skipped), on `device` (None: the card).

    samples: (..., >= nfft) time samples (numpy or a tensor).  Returns
    (metric (..., 64) float32, delay (..., 64) int32 in ZC samples,
    detected (..., 64) bool): metric is the zone's peak power over the root's
    mean power."""
    dev = resolve(device)
    x = as_samples(samples, dev)[..., : prach_nfft(cell)]
    fmap, rootmat, root_idx, zone_idx = table(_detect_tables, cell, cfg, device=dev)
    xf = torch.fft.fft(x, dim=-1)[..., fmap]
    prod = xf[..., None, :] * rootmat  # (..., R, 839)
    prof = torch.matmul(prod, table(_idft839, device=dev)).abs() ** 2
    mean_p = torch.mean(prof, dim=-1)  # (..., R)
    zprof = prof[..., root_idx[:, None], zone_idx]  # (..., 64, n_cs)
    metric = torch.amax(zprof, dim=-1) / mean_p[..., root_idx]
    delay = torch.argmax(zprof, dim=-1).to(torch.int32)  # the first peak, as jnp.argmax
    return metric, delay, metric > threshold
