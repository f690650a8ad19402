"""Host copy of `srsran_tpu/runtime/plots.py`, held to it by `tests/test_torch_stack.py`.

Diagnostic plots: the srsGUI analog (reference: srsgui plots driven
from `srsue/src/phy/sf_worker.cc:43-50,265-268` under ENABLE_GUI).

The reference opens live Qt scopes for the PDSCH constellation and the
channel response.  Here the same scopes render headlessly to PNG (the
framework runs on headless TPU hosts), rate-limited like the GUI's
per-frame update.  Single-series engineering plots: one hue, recessive
grid, no legend.
"""

from __future__ import annotations

import time

import numpy as np

_INK = "#333333"
_MUTED = "#999999"
_SERIES = "#3b6fb6"  # one mid-lightness hue; magnitude plots stay single-hue


def _axes(title: str, xlabel: str, ylabel: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4), dpi=110)
    ax.set_title(title, color=_INK, fontsize=11)
    ax.set_xlabel(xlabel, color=_MUTED, fontsize=9)
    ax.set_ylabel(ylabel, color=_MUTED, fontsize=9)
    ax.grid(True, color="#e5e5e5", linewidth=0.6)
    ax.tick_params(colors=_MUTED, labelsize=8)
    for s in ax.spines.values():
        s.set_color("#cccccc")
    return fig, ax


def plot_constellation(symbols, path: str, title: str = "PDSCH constellation"):
    """Equalized symbols → I/Q scatter (the scope_ constellation plot)."""
    import matplotlib.pyplot as plt

    sym = np.asarray(symbols).reshape(-1)
    fig, ax = _axes(title, "I", "Q")
    ax.scatter(sym.real, sym.imag, s=4, color=_SERIES, alpha=0.5, linewidths=0)
    lim = max(1.0, float(np.percentile(np.abs(sym), 99)) * 1.3)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_channel(ce, path: str, title: str = "Channel magnitude"):
    """Channel estimate (…, nre) → |H| across subcarriers (dB)."""
    import matplotlib.pyplot as plt

    h = np.asarray(ce)
    mag = 20 * np.log10(np.abs(h).reshape(-1, h.shape[-1]).mean(axis=0) + 1e-12)
    fig, ax = _axes(title, "subcarrier", "|H| (dB)")
    ax.plot(mag, color=_SERIES, linewidth=1.6)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_psd(samples, srate_hz: float, path: str, title: str = "Spectrum", nfft: int = 1024):
    """Welch-style averaged power spectral density of an I/Q stream."""
    import matplotlib.pyplot as plt

    x = np.asarray(samples).reshape(-1)
    n = (len(x) // nfft) * nfft
    if n == 0:
        raise ValueError("too few samples for one FFT frame")
    frames = x[:n].reshape(-1, nfft) * np.hanning(nfft)
    psd = np.fft.fftshift(np.mean(np.abs(np.fft.fft(frames, axis=-1)) ** 2, axis=0))
    psd_db = 10 * np.log10(psd / psd.max() + 1e-12)
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / srate_hz)) / 1e6
    fig, ax = _axes(title, "frequency (MHz)", "PSD (dB)")
    ax.plot(f, psd_db, color=_SERIES, linewidth=1.2)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


class LiveScope:
    """Rate-limited scope: call update(...) per TTI; renders at most every
    `period_s` seconds (the GUI's frame pacing), overwriting `path`."""

    def __init__(self, path: str, kind: str = "constellation", period_s: float = 1.0, **kw):
        self.path = path
        self.kind = kind
        self.period_s = period_s
        self.kw = kw
        self._last = 0.0
        self.frames = 0

    def update(self, data, srate_hz: float | None = None) -> bool:
        now = time.monotonic()
        if now - self._last < self.period_s:
            return False
        self._last = now
        if self.kind == "constellation":
            plot_constellation(data, self.path, **self.kw)
        elif self.kind == "channel":
            plot_channel(data, self.path, **self.kw)
        elif self.kind == "psd":
            plot_psd(data, srate_hz or 1.92e6, self.path, **self.kw)
        else:
            raise ValueError(self.kind)
        self.frames += 1
        return True
