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
    def nsymb_sf(self) -> int:
        return 2 * self.cp.nsymb

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
    nsym = cfg.nsymb_sf
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


def ofdm_tx_sf_np(cfg: OfdmConfig, grid: np.ndarray) -> np.ndarray:
    """`ofdm_tx_sf` in numpy, for a waveform made on the host (the
    reference's PUCCH-only UL subframes of its windowed control plane)."""
    n = cfg.symbol_sz
    nre = cfg.nof_re
    bins = np.zeros(grid.shape[:-2] + (cfg.nsymb_sf, n), np.complex64)
    bins[..., 1 : 1 + nre // 2] = grid[..., nre // 2 :]
    bins[..., n - nre // 2 :] = grid[..., : nre // 2]
    sym = np.fft.ifft(bins, axis=-1) * n
    if cfg.normalize:
        sym = sym * (1.0 / np.sqrt(n))
    pieces = []
    for i, l in enumerate(list(range(cfg.nsymb_slot)) * 2):
        cp = cp_len_norm(l, n) if cfg.cp == CP.NORM else cp_len_ext(n)
        pieces += [sym[..., i, n - cp :], sym[..., i, :]]
    out = np.concatenate(pieces, axis=-1)
    shift, _ = _phase_tables(cfg)
    if shift is not None:
        out = out * shift
    return out.astype(np.complex64)


# ---------------------------------------------------------------------------
# MBSFN mixed-CP subframes (ofdm.c:429-443 ofdm_rx_slot_mbsfn,
# ofdm.c:543-560 ofdm_tx_slot_mbsfn)
# ---------------------------------------------------------------------------


def mbsfn_guard_len(non_mbsfn_region: int, symbol_sz: int) -> int:
    """SRSLTE_NON_MBSFN_REGION_GUARD_LENGTH (phy_common.h:162-165): the gap
    that realigns the normal-CP control region to the extended-CP grid."""
    if non_mbsfn_region == 1:
        return cp_len_ext(symbol_sz) - cp_len_norm(0, symbol_sz)
    return (
        2 * cp_len_ext(symbol_sz)
        - cp_len_norm(0, symbol_sz)
        - cp_len_norm(1, symbol_sz)
    )


def _mbsfn_layout(cfg: OfdmConfig, non_mbsfn_region: int):
    """Per-symbol (cp_len, fft_window_start) for the 12-symbol mixed
    subframe: slot 0 = non_mbsfn_region normal-CP symbols + guard +
    extended-CP symbols; slot 1 = a regular extended-CP slot."""
    n = cfg.symbol_sz
    layout = []
    t = 0
    for i in range(6):  # slot 0 (mbsfn layout)
        if i == non_mbsfn_region:
            t += mbsfn_guard_len(non_mbsfn_region, n)
        cp = cp_len_norm(i, n) if i < non_mbsfn_region else cp_len_ext(n)
        layout.append((cp, t + cp))
        t += cp + n
    t = cfg.slot_sz
    for _ in range(6):  # slot 1 (pure extended CP)
        cp = cp_len_ext(n)
        layout.append((cp, t + cp))
        t += cp + n
    return layout


def _mbsfn_window_index(cfg: OfdmConfig, non_mbsfn_region: int) -> np.ndarray:
    """(12, N) sample index of every FFT window of the mixed subframe."""
    starts = np.array([s for _cp, s in _mbsfn_layout(cfg, non_mbsfn_region)])
    return (starts[:, None] + np.arange(cfg.symbol_sz)[None, :]).astype(np.int64)


def _mbsfn_tx_index(cfg: OfdmConfig, non_mbsfn_region: int) -> tuple:
    """(dst, src): the subframe sample each (symbol, CP-extended sample)
    lands on, and its flat index in the (12, N) IFFT output; the guard is
    never written."""
    n = cfg.symbol_sz
    dst, src = [], []
    for i, (cp, start) in enumerate(_mbsfn_layout(cfg, non_mbsfn_region)):
        dst.append(np.arange(start - cp, start + n))
        src.append(i * n + np.concatenate([np.arange(n - cp, n), np.arange(n)]))
    return np.concatenate(dst).astype(np.int64), np.concatenate(src).astype(np.int64)


def ofdm_rx_sf_mbsfn(cfg: OfdmConfig, samples: torch.Tensor, non_mbsfn_region: int = 2) -> torch.Tensor:
    """Demodulate an MBSFN subframe: (..., sf_sz) → (..., 12, nof_re); the 12
    windows are one gather and one FFT.

    The first `non_mbsfn_region` output symbols are the normal-CP control
    region (CRS/PDCCH of the host cell); the rest is the extended-CP MBSFN
    region.  `cfg.cp` must be CP.EXT (grid indexing is extended-CP)."""
    n = cfg.symbol_sz
    nre = cfg.nof_re
    x = samples[..., table(_mbsfn_window_index, cfg, non_mbsfn_region, device=samples.device)]
    bins = torch.fft.fft(x, dim=-1)
    grid = torch.cat([bins[..., n - nre // 2 :], bins[..., 1 : 1 + nre // 2]], dim=-1)
    if cfg.normalize:
        grid = grid * (1.0 / np.sqrt(n))
    return grid.to(torch.complex64)


def ofdm_tx_sf_mbsfn(cfg: OfdmConfig, grid: torch.Tensor, non_mbsfn_region: int = 2) -> torch.Tensor:
    """Modulate an MBSFN subframe: (..., 12, nof_re) → (..., sf_sz).

    The guard between the control and MBSFN regions stays exactly zero, as
    in the reference (the TX output buffer is pre-zeroed and skipped)."""
    n = cfg.symbol_sz
    nre = cfg.nof_re
    batch = grid.shape[:-2]
    bins = grid.new_zeros(batch + (12, n), dtype=torch.complex64)
    bins[..., 1 : 1 + nre // 2] = grid[..., nre // 2 :]
    bins[..., n - nre // 2 :] = grid[..., : nre // 2]
    sym = torch.fft.ifft(bins, dim=-1) * n
    if cfg.normalize:
        sym = sym * (1.0 / np.sqrt(n))
    dst, src = table(_mbsfn_tx_index, cfg, non_mbsfn_region, device=grid.device)
    out = sym.new_zeros(batch + (cfg.sf_sz,))
    out[..., dst] = sym.reshape(batch + (12 * n,))[..., src]
    return out.to(torch.complex64)
