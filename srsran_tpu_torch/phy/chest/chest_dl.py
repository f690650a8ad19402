"""Downlink channel estimation from CRS.

Counterpart of `srsran_tpu/phy/chest/chest_dl.py`: per port, LS estimates
at the pilots, then two small products

    ce(l, k) = sum_s Wt[l, s] * (Wf_s @ P_s)[k]

with Wf_s the frequency interpolation (+ 3-tap smoothing) matrix of CRS
symbol s — or, with ``algorithm="wiener"``, its fixed MMSE matrix — and Wt
the time interpolation matrix, plus the noise, RSRP and SNR estimates.
``last_symbol`` keeps only the CRS symbols before it (a TDD DwPTS).  The matrices are host-built and cast to complex64 once per
(cell, subframe, config, port, device): `torch.einsum` needs matching
dtypes, and the products must stay in full fp32 (TF32 off on the card).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import Cell
from .refsignal_dl import crs_positions, crs_sequence_port


@dataclasses.dataclass(frozen=True)
class ChestDlConfig:
    smooth_len: int = 3  # freq smoothing kernel length (0 = off)
    time_interp: bool = True  # False = average over CRS symbols
    algorithm: str = "interpolate"  # interpolate | wiener (ref chest_dl.h:78-82)
    wiener_delay_spread: float = 0.07  # assumed max delay, fraction of symbol


def _freq_interp_matrix(pilot_pos: np.ndarray, nre: int) -> np.ndarray:
    """(nre, npilots) linear interp/extrapolation weights."""
    npil = len(pilot_pos)
    w = np.zeros((nre, npil), np.float32)
    for k in range(nre):
        if k <= pilot_pos[0]:
            i0, i1 = 0, 1
        elif k >= pilot_pos[-1]:
            i0, i1 = npil - 2, npil - 1
        else:
            i1 = int(np.searchsorted(pilot_pos, k))
            i0 = i1 - 1
            if pilot_pos[i1] == k:
                w[k, i1] = 1.0
                continue
        t = (k - pilot_pos[i0]) / (pilot_pos[i1] - pilot_pos[i0])
        w[k, i0] = 1.0 - t
        w[k, i1] = t
    return w


def _smooth_matrix(npil: int, length: int) -> np.ndarray:
    """(npil, npil) triangular smoothing with edge renormalization."""
    if length <= 1:
        return np.eye(npil, dtype=np.float32)
    half = length // 2
    kern = np.array([half - abs(i - half) + 1 for i in range(2 * half + 1)], np.float32)
    kern /= kern.sum()
    w = np.zeros((npil, npil), np.float32)
    for i in range(npil):
        for j, c in enumerate(kern):
            jj = i + j - half
            if 0 <= jj < npil:
                w[i, jj] += c
        w[i] /= w[i].sum()
    return w


def _time_interp_matrix(ref_syms: np.ndarray, nsymb: int, interp: bool) -> np.ndarray:
    """(nsymb, n_ref_syms) weights: linear interp (clamped extrapolation)."""
    n = len(ref_syms)
    w = np.zeros((nsymb, n), np.float32)
    if not interp:
        w[:, :] = 1.0 / n
        return w
    for l in range(nsymb):
        if l <= ref_syms[0]:
            w[l, 0] = 1.0
        elif l >= ref_syms[-1]:
            w[l, n - 1] = 1.0
        else:
            i1 = int(np.searchsorted(ref_syms, l))
            i0 = i1 - 1
            if ref_syms[i1] == l:
                w[l, i1] = 1.0
            else:
                t = (l - ref_syms[i0]) / (ref_syms[i1] - ref_syms[i0])
                w[l, i0] = 1.0 - t
                w[l, i1] = t
    return w


@lru_cache(maxsize=128)
def _wiener_matrices(cell: Cell, cfg: ChestDlConfig, port: int, sf_idx: int):
    """Frequency-domain Wiener interpolation matrices per CRS symbol.

    MMSE estimator W = R_dp (R_pp + s2 I)^-1 under a uniform power-delay
    profile over [0, tau_max] (wiener_dl.c's runtime-correlation Wiener in
    a fixed form): correlation between subcarriers df apart is
    sinc(df*tau) * exp(-j*pi*df*tau).  The noise-dependent inverse is
    folded in for a fixed design SNR of 20 dB.
    """
    _, freqs = crs_positions(cell, port)
    nre = cell.nof_re_per_symbol
    tau = cfg.wiener_delay_spread
    s2 = 10 ** (-20 / 10)  # design SNR 20 dB

    def corr(dk):
        return np.sinc(dk * tau) * np.exp(-1j * np.pi * dk * tau)

    ws = []
    for s in range(len(freqs)):
        p = freqs[s].astype(np.float64)
        k = np.arange(nre, dtype=np.float64)
        r_pp = corr(p[:, None] - p[None, :]) + s2 * np.eye(len(p))
        r_dp = corr(k[:, None] - p[None, :])
        ws.append((r_dp @ np.linalg.inv(r_pp)).astype(np.complex64))
    return np.stack(ws)


@lru_cache(maxsize=256)
def _chest_tables(cell: Cell, sf_idx: int, cfg: ChestDlConfig, port: int,
                  last_symbol: int | None = None):
    """Precompute (syms, freqs, ref_conj, Wf (4, nre, npil), Wt (nsymb, 4)).

    ``last_symbol`` drops CRS symbols at/after it (TDD special subframes,
    where only the DwPTS carries reference signals)."""
    syms, freqs = crs_positions(cell, port)
    seq = crs_sequence_port(cell, sf_idx, port)  # (nref, 2*nprb)
    if last_symbol is not None:
        keep = syms < last_symbol
        syms, freqs, seq = syms[keep], freqs[keep], seq[keep]
    nre = cell.nof_re_per_symbol
    wf = []
    for s in range(len(syms)):
        m = _freq_interp_matrix(freqs[s], nre)
        if cfg.smooth_len > 1:
            m = m @ _smooth_matrix(freqs.shape[1], cfg.smooth_len)
        wf.append(m)
    wf = np.stack(wf)  # (4, nre, npil)
    wt = _time_interp_matrix(syms.astype(np.float64), cell.nsymb_per_sf, cfg.time_interp)
    return syms, freqs, np.conj(seq), wf, wt


def _device_tables(cell: Cell, sf_idx: int, cfg: ChestDlConfig, port: int,
                   last_symbol: int | None = None):
    """`_chest_tables` with int64 indices and complex64 matrices; Wf is the
    Wiener matrices' prefix of the kept CRS symbols under
    ``algorithm="wiener"`` (symbol indices ascend, so a last_symbol cut
    keeps a prefix)."""
    syms, freqs, ref_conj, wf, wt = _chest_tables(cell, sf_idx, cfg, port, last_symbol)
    if cfg.algorithm == "wiener":
        wf = _wiener_matrices(cell, cfg, port, sf_idx)[: len(syms)]
    return (syms.astype(np.int64)[:, None], freqs.astype(np.int64), ref_conj,
            wf.astype(np.complex64), wt.astype(np.complex64))


def chest_dl(grid: torch.Tensor, cell: Cell, sf_idx: int,
             cfg: ChestDlConfig = ChestDlConfig(), nof_ports: int | None = None,
             last_symbol: int | None = None):
    """Estimate the DL channel from CRS.

    grid: (..., nsymb_sf, nre) complex64 received resource grid.
    Returns dict with:
      ce     (..., nof_ports, nsymb_sf, nre) complex64
      noise  (..., nof_ports) float32 — noise power estimate
      rsrp   (..., nof_ports) float32
      snr    (..., nof_ports) float32
    """
    nof_ports = nof_ports or min(cell.nof_ports, 2)
    ces, noises, rsrps = [], [], []
    for p in range(nof_ports):
        syms, freqs, ref_conj, wf, wt = table(
            _device_tables, cell, sf_idx, cfg, p, last_symbol, device=grid.device)
        # LS estimates at pilots: (..., 4, npil)
        ls = grid[..., syms, freqs] * ref_conj
        # freq interp+smooth or Wiener MMSE: (..., 4, nre); time interp:
        # (..., nsymb, nre)
        per_sym = torch.einsum("snp,...sp->...sn", wf, ls)
        ces.append(torch.einsum("ls,...sn->...ln", wt, per_sym))
        # noise: high-pass residual of raw LS pilots, var/1.5 per
        # [-0.5, 1, -0.5] kernel on white noise
        resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
        noises.append(torch.mean(resid.abs() ** 2, dim=(-1, -2)) / 1.5)
        rsrps.append(torch.mean(ls.abs() ** 2, dim=(-1, -2)))
    ce = torch.stack(ces, dim=-3).to(torch.complex64)
    noise = torch.stack(noises, dim=-1)
    rsrp = torch.stack(rsrps, dim=-1)
    snr = rsrp / torch.clamp(noise, min=1e-12)
    return dict(ce=ce, noise=noise, rsrp=rsrp, snr=snr)
