"""PSS generation and detection, TS 36.211 §6.11.1.

Counterpart of `srsran_tpu/phy/sync/pss.py`.  Host side: the frequency
domain Zadoff-Chu sequence, its placement in a subframe grid and the
time-domain replica of each root.  Device side, on the device of the
samples: the correlation against all three roots as one batched FFT product
(`pss_correlate`), the peak (`pss_find`) and the CFO from the two half
symbols (`pss_cfo_estimate`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import sized_table, table

PSS_ROOTS = (25, 29, 34)  # u for N_id_2 = 0, 1, 2
PSS_LEN = 62


@lru_cache(maxsize=8)
def pss_freq_np(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS d_u(n), length 62 (TS 36.211 §6.11.1.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    n2 = np.arange(31, 62)
    b = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63.0)
    return np.concatenate([a, b]).astype(np.complex64)


def put_pss_grid(grid: np.ndarray, n_id_2: int, nof_prb: int, symbol: int):
    """Place the PSS into a (nsymb, nre) grid at `symbol`, on the 62
    subcarriers around DC."""
    k0 = nof_prb * 12 // 2 - 31
    grid[symbol, k0 : k0 + 62] = pss_freq_np(n_id_2)
    return grid


@lru_cache(maxsize=32)
def pss_time_np(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica of length fft_size, unit energy: d[0..30] on
    subcarriers -31..-1, d[31..61] on +1..+31."""
    d = pss_freq_np(n_id_2)
    grid = np.zeros(fft_size, np.complex64)
    grid[1:32] = d[31:62]
    grid[fft_size - 31 :] = d[0:31]
    t = np.fft.ifft(grid) * fft_size
    return (t / np.sqrt(np.sum(np.abs(t) ** 2))).astype(np.complex64)


def _replicas(fft_size: int) -> np.ndarray:
    return np.stack([pss_time_np(i, fft_size) for i in range(3)])


def _replica_spectra(fft_size: int, nfft: int) -> np.ndarray:
    """(3, nfft) conjugated spectra of the three replicas, zero-padded."""
    return np.conj(np.fft.fft(_replicas(fft_size), nfft, axis=-1)).astype(np.complex64)


# one entry per (FFT size, padded length): a few powers of two per cell
_spectra_table = sized_table(16)


def pss_correlate(samples: torch.Tensor, fft_size: int = 128) -> torch.Tensor:
    """|correlation| of samples (..., n) complex64 with the three replicas:
    (..., 3, n) float32; peak index i means the replica starts at sample i.
    One FFT of length the next power of two of n + fft_size."""
    n = samples.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + fft_size)))
    rep_f = _spectra_table(_replica_spectra, fft_size, nfft, device=samples.device)
    x_f = torch.fft.fft(samples, nfft, dim=-1)
    corr = torch.fft.ifft(x_f[..., None, :] * rep_f, dim=-1)
    return corr[..., :n].abs()


# relative distance from the maximum within which PSS metrics tie (`pss_find`)
PSS_TIE_RTOL = 1e-5


def pss_find(samples: torch.Tensor, fft_size: int = 128):
    """The best (n_id_2, offset, peak, avg) of a sample window, tensors of
    shape (...,) on the device of the samples; the first maximum wins a tie.
    peak / avg is the detection metric (a proxy of the peak-to-sidelobe).

    A tie is a metric within `PSS_TIE_RTOL` of the maximum: the PSS
    occasions of a periodic noise-free stream are equal in exact arithmetic
    but differ by a few ULP of the FFT correlation, and the earliest must
    win as it would there (a later one drops the subframes before it)."""
    c = pss_correlate(samples, fft_size)
    flat = c.reshape(c.shape[:-2] + (-1,))
    top = torch.amax(flat, dim=-1, keepdim=True)
    arg = torch.argmax((flat >= top * (1 - PSS_TIE_RTOL)).to(torch.uint8), dim=-1)
    n = c.shape[-1]
    peak = torch.gather(flat, -1, arg[..., None])[..., 0]
    return arg // n, arg % n, peak, torch.mean(c, dim=(-1, -2))


def pss_cfo_estimate(samples: torch.Tensor, n_id_2: int, fft_size: int = 128) -> torch.Tensor:
    """CFO in subcarrier spacings from samples (..., fft_size) that start at
    the PSS symbol: the phase between the two half-symbol correlations with
    the replica (pss.c srslte_pss_cfo_compute)."""
    r = table(_replicas, fft_size, device=samples.device)[n_id_2]
    half = fft_size // 2
    prod = samples * torch.conj(r)
    y0 = torch.sum(prod[..., :half], dim=-1)
    y1 = torch.sum(prod[..., half:], dim=-1)
    return torch.angle(torch.conj(y0) * y1) / np.pi
