"""Sidelink (D2D/C-V2X) synchronization signals: PSSS and SSSS,
TS 36.211 §9.7 (counterpart of `srsran_tpu/phy/sync/sidelink.py`).

PSSS: length-62 ZC with root 26 for N_sl_id 0-167 and 37 for 168-335,
transmitted twice, on symbols 1 and 2 of slot 0 of the sync subframe.
SSSS: the LTE SSS s/c/z construction (the port's `sss._base_sequences`
and `sss._m0m1`) with (id1, id2) = (N_sl_id % 168, N_sl_id // 168) on
symbols 4 and 5 of slot 1.  Sidelink uses the UL half-subcarrier shift
(SC-FDMA grid).

Sequences and the time-domain replicas are host tables; the correlation
(one FFT of the capture, both roots) and the 336-hypothesis SSSS product
run on the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..common import Cell
from ..ofdm import OfdmConfig, ofdm_tx_sf
from .sss import _base_sequences, _m0m1

PSSS_LEN = 62


@lru_cache(maxsize=4)
def psss_seq_np(root_idx: int) -> np.ndarray:
    """(62,) PSSS ZC sequence, root 26 (idx 0) or 37 (idx 1) — note the
    sign convention (e^{-jπu·/63}) of psss.c."""
    u = [26.0, 37.0][root_idx]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    n2 = np.arange(31, 62)
    b = np.exp(-1j * np.pi * u * (n2 + 2) * (n2 + 1) / 63.0)
    return np.concatenate([a, b]).astype(np.complex64)


@lru_cache(maxsize=512)
def ssss_seq_np(n_sl_id: int, tm12: bool = True) -> np.ndarray:
    """(62,) SSSS ±1 sequence (ssss.c srslte_ssss_generate)."""
    id1, id2 = n_sl_id % 168, n_sl_id // 168
    s_t, c_t, z_t = _base_sequences()
    m0, m1 = _m0m1(id1)
    n = np.arange(31)
    s0 = s_t[(n + m0) % 31]
    s1 = s_t[(n + m1) % 31]
    c0 = c_t[(n + id2) % 31]
    c1 = c_t[(n + id2 + 3) % 31]
    z1_m0 = z_t[(n + (m0 % 8)) % 31]
    z1_m1 = z_t[(n + (m1 % 8)) % 31]
    d = np.zeros(62)
    if tm12:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d.astype(np.float32)


def put_sl_sync_grid(grid: np.ndarray, cell: Cell, n_sl_id: int, tm12: bool = True):
    """Insert PSSS (slot-0 symbols 1,2) + SSSS (slot-1 symbols 4,5) into a
    (nsymb_sf, nre) grid."""
    nre = cell.nof_re_per_symbol
    k0 = nre // 2 - 31
    psss = psss_seq_np(0 if n_sl_id < 168 else 1)
    for l in (1, 2):
        grid[l, k0 : k0 + PSSS_LEN] = psss
    ssss = ssss_seq_np(n_sl_id, tm12)
    for l in (4, 5):
        grid[cell.nsymb_per_slot + l, k0 : k0 + PSSS_LEN] = ssss
    return grid


@lru_cache(maxsize=16)
def _psss_replica_time(root_idx: int, nof_prb: int, standard_rates: bool = True) -> np.ndarray:
    """One PSSS symbol's time-domain waveform (with the UL 0.5-subcarrier
    shift), for correlation; rendered by the port's modulator on the CPU."""
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=0, use_standard_rates=standard_rates)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    k0 = cell.nof_re_per_symbol // 2 - 31
    grid[1, k0 : k0 + PSSS_LEN] = psss_seq_np(root_idx)
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5)
    t = ofdm_tx_sf(ofdm, torch.from_numpy(grid)).numpy()
    starts = ofdm.symbol_starts()
    return t[starts[1] : starts[2]].astype(np.complex64)


def _replica_spectra(nof_prb: int, standard_rates: bool, nfft: int) -> np.ndarray:
    """(2, nfft) spectra of the time-reversed conjugate replicas."""
    reps = [np.conj(_psss_replica_time(r, nof_prb, standard_rates)[::-1]) for r in range(2)]
    return np.fft.fft(np.stack(reps), nfft).astype(np.complex64)


def psss_find(samples, nof_prb: int = 6, standard_rates: bool = True, *, device=None):
    """Correlate both PSSS roots over a capture (numpy or a tensor, moved to
    `device`: None is the card); one FFT of the capture, one host read.

    Returns (root_idx, offset_of_symbol1, peak/avg metric)."""
    x = as_samples(samples, resolve(device))
    n = x.shape[-1]
    m = len(_psss_replica_time(0, nof_prb, standard_rates))
    nfft = int(2 ** np.ceil(np.log2(n + m)))
    h = table(_replica_spectra, nof_prb, standard_rates, nfft, device=x.device)
    corr = torch.abs(torch.fft.ifft(torch.fft.fft(x, nfft) * h, dim=-1))[:, m - 1 : m - 1 + n]
    peak = torch.amax(corr, dim=-1)
    # PSSS repeats on two adjacent symbols -> two equal peaks; take the
    # EARLIEST within 5% of the max (= the symbol-1 copy)
    off = torch.argmax((corr >= 0.95 * peak[:, None]).to(torch.uint8), dim=-1)
    metric = peak / (torch.mean(corr, dim=-1) + 1e-12)
    res = torch.stack([metric.to(torch.float64), off.to(torch.float64)]).cpu().numpy()
    root = 0 if res[0, 0] >= res[0, 1] else 1
    return root, int(res[1, root]), float(res[0, root])


@lru_cache(maxsize=2)
def _ssss_hypotheses(max_id: int) -> np.ndarray:
    return np.stack([ssss_seq_np(i) for i in range(max_id)]).astype(np.complex64)


def ssss_detect(ssss_re: torch.Tensor, max_id: int = 336):
    """Resolve N_sl_id from (62,) equalized SSSS REs via one hypothesis
    product: (best, confidence) tensors on their device."""
    hyp = table(_ssss_hypotheses, max_id, device=ssss_re.device)
    corr = torch.abs(hyp @ ssss_re.to(torch.complex64))
    best = torch.argmax(corr)
    return best, corr[best] / (torch.linalg.vector_norm(ssss_re) * np.sqrt(62.0))
