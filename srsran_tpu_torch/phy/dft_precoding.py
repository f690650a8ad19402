"""Transform (DFT) precoding for SC-FDMA, TS 36.211 §5.3.3.

Counterpart of `srsran_tpu/phy/dft_precoding.py`.  Sizes are 12*n with n
composed of factors 2/3/5, so instead of non-power-of-2 FFT plans a
precomputed (M, M) DFT matrix multiplies each symbol batch: one complex64
`torch.matmul` (M ≤ 1200).  The matrix moves to a device once per
(M, direction); at 1152 x 1152 it holds 10.6 MB, so the cache is bounded.

Where the transform length is data (one allocation width per TTI of a
window), `idft_bluestein` and `dft_bluestein` compute the same transforms by
Bluestein's chirp convolution at one fixed power-of-two FFT size.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def valid_nof_prb(n: int) -> bool:
    """n must factor into 2/3/5 (TS 36.211 §5.3.3)."""
    if n < 1:
        return False
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


@lru_cache(maxsize=16)
def _dft_matrix(m: int, inverse: bool) -> np.ndarray:
    n = np.arange(m)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(n, n) / m) / np.sqrt(m)
    return w.astype(np.complex64)


@lru_cache(maxsize=16)
def _dft_matrix_on(m: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dft_matrix(m, inverse)).to(device)


def dft_precode(symbols: torch.Tensor) -> torch.Tensor:
    """(..., nsym, M) → DFT along the last axis (normalized by 1/sqrt(M))."""
    return torch.matmul(symbols, _dft_matrix_on(symbols.shape[-1], False, symbols.device))


def dft_predecode(symbols: torch.Tensor) -> torch.Tensor:
    """The inverse transform (IDFT), used at the receiver."""
    return torch.matmul(symbols, _dft_matrix_on(symbols.shape[-1], True, symbols.device))


def idft_bluestein(x: torch.Tensor, m, n_fft: int = 4096) -> torch.Tensor:
    """IDFT along the last axis with the length m as data (Bluestein).

    Bluestein's identity nk = (n² + k² - (n-k)²)/2 turns the length-m IDFT
    into a chirp multiply, one linear convolution at a fixed power-of-two FFT
    size, and a chirp multiply; the chirps are elementwise functions of m.

    x: (..., M_MAX) complex64, data in columns [0, m), anything beyond is
    ignored.  m: an int, or an integer tensor that broadcasts against
    x.shape[:-1] (one length per row: pass (W, 1) for x of (W, nsym, M_MAX)).
    Returns (..., M_MAX): the IDFT in [0, m), zeros beyond, normalized by
    1/sqrt(m) like `_dft_matrix(m, True)`.  n_fft must be >= 2*M_MAX - 1."""
    M = x.shape[-1]
    if n_fft < 2 * M - 1:
        raise ValueError(f"idft_bluestein: n_fft={n_fft} is below 2*{M} - 1")
    dev = x.device
    m = torch.as_tensor(m, device=dev).to(torch.int32).clamp(min=1)[..., None]
    m_f = m.to(torch.float32)

    def chirp(t):
        # exp(+j*pi*t²/m) with the square reduced mod 2m in int32, so the
        # phase stays small and exact in float32 (t²/m reaches ~1e5 rad)
        phase = (np.float32(np.pi) * ((t * t) % (2 * m)).to(torch.float32)) / m_f
        return torch.complex(torch.cos(phase), torch.sin(phase))

    k = torch.arange(M, device=dev, dtype=torch.int32)
    in_mask = k < m
    ck = chirp(k)
    u = torch.where(in_mask, x, 0.0) * ck
    lag = torch.arange(n_fft, device=dev, dtype=torch.int32)
    lag = torch.where(lag < M, lag, lag - n_fft)  # circular placement of the lags
    w = torch.where(lag.abs() < M, torch.conj(chirp(lag)), 0.0)
    conv = torch.fft.ifft(torch.fft.fft(u, n=n_fft, dim=-1) * torch.fft.fft(w, dim=-1), dim=-1)
    out = ck * conv[..., :M] / torch.sqrt(m_f)
    return torch.where(in_mask, out, 0.0).to(torch.complex64)


def dft_bluestein(x: torch.Tensor, m, n_fft: int = 4096) -> torch.Tensor:
    """Forward DFT with the length m as data: DFT = conj(IDFT(conj(x))) under
    the symmetric 1/sqrt(m) normalization."""
    return torch.conj(idft_bluestein(torch.conj(x), m, n_fft)).resolve_conj()
