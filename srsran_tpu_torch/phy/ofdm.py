"""OFDM demodulation (CP strip + FFT) and modulation, TS 36.211 §6.12.

Counterpart of `srsran_tpu/phy/ofdm.py` (receive side): per symbol, skip
the CP, FFT(N), optional window-offset phase compensation, then pick the
bins with the DC bin skipped — ``out[:nre/2] = bins[N-nre/2:]``,
``out[nre/2:] = bins[1:1+nre/2]`` — and optionally scale by 1/sqrt(N).

The 14 symbol windows are one gather with a cached (nsymb, N) index table;
the FFT is one batched `torch.fft.fft` over every symbol and leading axis.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..device import table
from .common import CP, Cell, cp_len_ext, cp_len_norm, symbol_sz as _symbol_sz


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    nof_prb: int
    cp: CP = CP.NORM
    symbol_sz: int = 0  # 0 → derive from nof_prb
    normalize: bool = False
    freq_shift_f: float = 0.0  # in subcarrier units (UL: ±0.5)
    rx_window_offset: float = 0.0  # fraction of CP [0, 1)
    use_standard_rates: bool = True

    def __post_init__(self):
        if self.symbol_sz == 0:
            object.__setattr__(
                self, "symbol_sz", _symbol_sz(self.nof_prb, self.use_standard_rates)
            )

    @classmethod
    def from_cell(cls, cell: Cell, **kw) -> "OfdmConfig":
        return cls(
            nof_prb=cell.nof_prb,
            cp=cell.cp,
            use_standard_rates=cell.use_standard_rates,
            **kw,
        )

    @property
    def nof_re(self) -> int:
        return self.nof_prb * 12

    @property
    def nsymb_slot(self) -> int:
        return self.cp.nsymb

    @property
    def slot_sz(self) -> int:
        return self.symbol_sz * 15 // 2

    @property
    def sf_sz(self) -> int:
        return self.symbol_sz * 15

    @property
    def window_offset_n(self) -> int:
        if self.rx_window_offset <= 0:
            return 0
        cp2 = (
            cp_len_norm(1, self.symbol_sz)
            if self.cp == CP.NORM
            else cp_len_ext(self.symbol_sz)
        )
        return int(round(cp2 * min(self.rx_window_offset, 1.0)))

    def symbol_starts(self) -> tuple[int, ...]:
        """Start sample (post-CP FFT window) of each symbol in the subframe."""
        n = self.symbol_sz
        starts = []
        for slot in range(2):
            t = slot * self.slot_sz
            for l in range(self.nsymb_slot):
                t += cp_len_norm(l, n) if self.cp == CP.NORM else cp_len_ext(n)
                starts.append(t)
                t += n
        return tuple(starts)


@lru_cache(maxsize=128)
def _phase_tables(cfg: OfdmConfig):
    """Host-precomputed (freq_shift, window_offset) phase ramps.

    The half-subcarrier shift is referenced to each symbol's FFT window
    start (phase zero at the window start)."""
    n = cfg.symbol_sz
    shift = None
    if cfg.freq_shift_f != 0.0:
        t = np.arange(cfg.sf_sz, dtype=np.float64)
        starts = cfg.symbol_starts()
        ref = np.zeros(cfg.sf_sz, dtype=np.float64)
        # each symbol's region spans from its CP start to the next CP start
        cp_starts = []
        prev_end = 0
        for s in starts:
            cp_starts.append(prev_end)
            prev_end = s + n
        for i, cs in enumerate(cp_starts):
            end = cfg.sf_sz if i == len(cp_starts) - 1 else cp_starts[i + 1]
            ref[cs:end] = starts[i]
        shift = np.exp(2j * np.pi * cfg.freq_shift_f * (t - ref) / n).astype(np.complex64)
    woff = None
    if cfg.window_offset_n:
        k = np.arange(n, dtype=np.float64)
        woff = np.exp(2j * np.pi * cfg.window_offset_n * k / n).astype(np.complex64)
    return shift, woff


def _window_index(cfg: OfdmConfig) -> np.ndarray:
    """(nsymb_sf, N) sample index of every FFT window in the subframe."""
    starts = np.asarray(cfg.symbol_starts()) - cfg.window_offset_n
    return (starts[:, None] + np.arange(cfg.symbol_sz)[None, :]).astype(np.int64)


def ofdm_rx_sf(cfg: OfdmConfig, samples: torch.Tensor) -> torch.Tensor:
    """Demodulate one subframe: (..., sf_sz) complex64 → (..., nsymb_sf, nof_re)
    (the reference's `_ofdm_rx_sf_impl`)."""
    n = cfg.symbol_sz
    nre = cfg.nof_re
    dev = samples.device
    shift, woff = table(_phase_tables, cfg, device=dev)
    if shift is not None:
        samples = samples * shift
    x = samples[..., table(_window_index, cfg, device=dev)]  # (..., nsymb_sf, N)
    bins = torch.fft.fft(x, dim=-1)
    if woff is not None:
        bins = bins * woff
    # negative-frequency half then positive half, skipping the DC bin
    grid = torch.cat([bins[..., n - nre // 2 :], bins[..., 1 : 1 + nre // 2]], dim=-1)
    if cfg.normalize:
        grid = grid * (1.0 / np.sqrt(n))
    return grid.to(torch.complex64)



def ofdm_tx_sf(cfg: OfdmConfig, grid: torch.Tensor) -> torch.Tensor:
    """Modulate one subframe: (..., nsymb_sf, nof_re) complex64 grid →
    (..., sf_sz) complex64 (the reference's `_ofdm_tx_sf_impl`)."""
    n = cfg.symbol_sz
    nre = cfg.nof_re
    nsym = 2 * cfg.nsymb_slot
    bins = grid.new_zeros(grid.shape[:-2] + (nsym, n), dtype=torch.complex64)
    bins[..., 1 : 1 + nre // 2] = grid[..., nre // 2 :]
    bins[..., n - nre // 2 :] = grid[..., : nre // 2]
    sym = torch.fft.ifft(bins, dim=-1) * n  # the reference IFFT is unnormalized
    if cfg.normalize:
        sym = sym * (1.0 / np.sqrt(n))
    pieces = []
    for i, l in enumerate(list(range(cfg.nsymb_slot)) * 2):
        cp = cp_len_norm(l, n) if cfg.cp == CP.NORM else cp_len_ext(n)
        pieces += [sym[..., i, n - cp :], sym[..., i, :]]
    out = torch.cat(pieces, dim=-1)
    shift, _ = table(_phase_tables, cfg, device=grid.device)
    if shift is not None:
        out = out * shift
    return out.to(torch.complex64)
