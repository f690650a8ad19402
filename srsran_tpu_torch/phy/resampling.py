"""Resampling: linear interpolation, FFT interpolate/decimate with
overlap-save blocks, decimating FIR, arbitrary-ratio polyphase.

Counterpart of `srsran_tpu/phy/resampling.py` (`lib/src/phy/resampling/`:
`interp.h:40-110`, `resampler.c:109-189`, `decim.c`, `resample_arb.c`).
Each function runs in torch on the device of its input (`torch.fft` is
cuFFT on the card); blocks batch over a leading axis.  The FFT resampler
expresses one overlap-save block as device math; `resample_fft_blocks`
takes each block's `halo` from its neighbours on one device (across
devices that halo is an exchange between them, which belongs to the
port's later multi-device slice).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import sized_table, table

# `resample_arb`'s plans on the device: (n_out, ntaps) indices and
# coefficients per input length and rate, a few MB each at a frame
_arb_table = sized_table(8)


def interp_linear(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Linear interpolation by integer ratio (`srslte_interp_linear_*`).

    (..., n) → (..., n*ratio); the last segment extrapolates.
    """
    n = x.shape[-1]
    nxt = torch.cat([x[..., 1:], 2 * x[..., -1:] - x[..., -2:-1]], dim=-1)
    t = torch.arange(ratio, dtype=torch.float32, device=x.device) / ratio
    out = x[..., :, None] * (1 - t) + nxt[..., :, None] * t
    return out.reshape(x.shape[:-1] + (n * ratio,))


def resample_fft(x: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Whole-buffer FFT resampling by rational p/q (len*p % q must be 0).

    Frequency-domain zero-pad (p>q) or truncate (p<q); the reference's
    `srslte_resampler_fft` on one block.
    """
    n = x.shape[-1]
    m = n * p // q
    xf = torch.fft.fft(x, dim=-1)
    yf = torch.zeros(x.shape[:-1] + (m,), dtype=xf.dtype, device=x.device)
    half = min(n, m) // 2
    yf[..., :half] = xf[..., :half]
    yf[..., m - half:] = xf[..., n - half:]
    return (torch.fft.ifft(yf, dim=-1) * (m / n)).to(torch.complex64)


def resample_fft_blocks(x_blocks: torch.Tensor, p: int, q: int, halo: int = 64) -> torch.Tensor:
    """Blockwise overlap-save FFT resampling.

    x_blocks: (..., nblocks, blk) contiguous stream split into equal
    blocks.  Each block is extended by `halo` samples from its neighbours
    (the edge blocks by their own edge samples), resampled, and the halo
    region discarded.
    """
    blk = x_blocks.shape[-1]
    assert (blk + 2 * halo) * p % q == 0 and blk * p % q == 0
    left = torch.cat([x_blocks[..., :1, :halo], x_blocks[..., :-1, blk - halo:]], dim=-2)
    right = torch.cat([x_blocks[..., 1:, :halo], x_blocks[..., -1:, blk - halo:]], dim=-2)
    y = resample_fft(torch.cat([left, x_blocks, right], dim=-1), p, q)
    h_out = halo * p // q
    return y[..., h_out: h_out + blk * p // q]


@lru_cache(maxsize=32)
def _lowpass_fir(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def _decim_taps(ntaps: int, cutoff: float) -> np.ndarray:
    """The FIR reversed, complex64, as the sliding-window product takes it."""
    return _lowpass_fir(ntaps, cutoff)[::-1].astype(np.complex64)


def decimate(x: torch.Tensor, factor: int, ntaps: int = 33) -> torch.Tensor:
    """Anti-aliased decimation (`srslte_decim_c`): FIR ("same" length),
    then every `factor`-th sample."""
    h_rev = table(_decim_taps, ntaps, 0.5 / factor, device=x.device)
    pad = ntaps // 2
    xe = torch.nn.functional.pad(x, (pad, ntaps - 1 - pad))
    win = xe.unfold(-1, ntaps, 1)  # (..., n, ntaps)
    y = torch.einsum("...nt,t->...n", win, h_rev)
    return y[..., ::factor]


@lru_cache(maxsize=16)
def _arb_polyphase_bank(nphases: int, ntaps: int, cutoff: float) -> np.ndarray:
    """(nphases+1, ntaps) fractional-delay filter bank: row p holds a
    windowed-sinc interpolation kernel at delay p/nphases (the analog of
    `srslte_resample_arb_polyfilt`, resample_arb.c:29 — generated instead
    of tabulated).  Row nphases == row 0 delayed one full sample, so phase
    interpolation never wraps."""
    center = ntaps // 2 - 1
    beta = 8.0
    half = ntaps / 2
    bank = np.zeros((nphases + 1, ntaps), np.float64)
    for p in range(nphases + 1):
        u = np.arange(ntaps) - center - p / nphases
        # continuous Kaiser window evaluated at the fractional delay
        w = np.where(
            np.abs(u) <= half,
            np.i0(beta * np.sqrt(np.maximum(0.0, 1 - (u / half) ** 2))) / np.i0(beta),
            0.0,
        )
        h = np.sinc(u * 2 * cutoff) * w
        bank[p] = h / h.sum()  # unit DC gain per phase
    return bank.astype(np.float32)


def _arb_plan(n: int, rate: float, nphases: int, ntaps: int):
    """(window index (n_out, ntaps) int64, blended coefficients (n_out,
    ntaps) float32) of `resample_arb` on an n-sample input."""
    n_out = int(np.floor(n * rate))
    bank = _arb_polyphase_bank(nphases, ntaps, 0.5 * min(1.0, rate))
    t = np.arange(n_out, dtype=np.float64) / rate
    idx = np.floor(t).astype(np.int32)
    mu = (t - idx) * nphases
    p0 = np.floor(mu).astype(np.int32)
    frac = (mu - p0).astype(np.float32)
    coef = bank[p0] * (1.0 - frac)[:, None] + bank[p0 + 1] * frac[:, None]
    return (idx[:, None] + np.arange(ntaps)[None, :]).astype(np.int64), coef.astype(np.float32)


def resample_arb(x: torch.Tensor, rate: float, nphases: int = 32, ntaps: int = 8) -> torch.Tensor:
    """Arbitrary-ratio polyphase resampler (`resample_arb.c`): output k is
    the input at time k/rate, interpolated by an 8-tap fractional-delay
    filter with linear blending between the 32 bank phases (the kernel's
    cutoff scaled by the rate when decimating).

    One gather of (n_out, ntaps) windows and one product against the
    blended coefficients: no shift register, no per-sample loop.
    x: (..., n) → (..., floor(n*rate)).
    """
    win_idx, coef = _arb_table(_arb_plan, x.shape[-1], float(rate), nphases, ntaps, device=x.device)
    center = ntaps // 2 - 1
    xe = torch.nn.functional.pad(x, (center, ntaps - center))
    return torch.einsum("...kt,kt->...k", xe[..., win_idx], coef.to(x.dtype)).to(x.dtype)
