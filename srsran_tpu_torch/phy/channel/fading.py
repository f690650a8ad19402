"""Multipath fading emulator and the single impairment models.

Counterpart of `srsran_tpu/phy/channel/fading.py` (`lib/src/phy/channel/
fading.c`): the TS 36.101 Annex B.2 tap-delay-line profiles (EPA/EVA/ETU),
per-tap Rayleigh fading by sum of sinusoids, applied as one FFT product per
block (the channel frozen over the block, evolving with its start time);
AWGN, the radio-link-failure gate, the fractional delay and the
high-speed-train Doppler trajectory.

The sum-of-sinusoids parameters are host numpy, drawn exactly as the
reference draws them from the configuration's seed, so the taps are the
reference's.  `awgn` takes a `torch.Generator` where the reference takes a
JAX key: the two draw different noise, with the same statistics.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import resolve, table

# excess tap delay [ns], relative power [dB] — TS 36.101 B.2.1
DELAY_PROFILES = {
    "epa": (
        (0, 30, 70, 90, 110, 190, 410),
        (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8),
    ),
    "eva": (
        (0, 30, 150, 310, 370, 710, 1090, 1730, 2510),
        (0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9),
    ),
    "etu": (
        (0, 50, 120, 200, 230, 500, 1600, 2300, 5000),
        (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0),
    ),
    "none": ((0,), (0.0,)),
}

N_SINUSOIDS = 16  # sum-of-sinusoids components per tap


@dataclasses.dataclass(frozen=True)
class FadingConfig:
    model: str = "epa"  # epa|eva|etu|none
    doppler_hz: float = 5.0
    srate: float = 1.92e6
    seed: int = 0

    @property
    def taps(self):
        return DELAY_PROFILES[self.model]


@lru_cache(maxsize=64)
def _sos_params(cfg: FadingConfig):
    """Random sum-of-sinusoids parameters per tap (host, from cfg.seed):
    (freqs (ntaps, N), theta (ntaps, N), phi (ntaps, N), amp (ntaps,),
    delays [s] (ntaps,)), float32."""
    delays, powers = cfg.taps
    ntaps = len(delays)
    rng = np.random.default_rng(cfg.seed)
    theta = rng.uniform(0, 2 * np.pi, (ntaps, N_SINUSOIDS))
    phi = rng.uniform(0, 2 * np.pi, (ntaps, N_SINUSOIDS))
    # Jakes: f_i = fd * cos(alpha_i)
    alpha = (2 * np.pi * np.arange(N_SINUSOIDS) + rng.uniform(0, 2 * np.pi, (ntaps, 1))) / N_SINUSOIDS
    freqs = cfg.doppler_hz * np.cos(alpha)
    amp = 10.0 ** (np.asarray(powers) / 20.0)
    amp = amp / np.sqrt(np.sum(amp**2))
    return (
        freqs.astype(np.float32),
        theta.astype(np.float32),
        phi.astype(np.float32),
        amp.astype(np.float32),
        np.asarray(delays, np.float32) * 1e-9,
    )


def _times(t, device) -> torch.Tensor:
    """Times as float32: a tensor stays on its device, anything else goes to
    `device` (None: the card)."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    return torch.as_tensor(t, dtype=torch.float32, device=resolve(device))


def tap_gains(cfg: FadingConfig, t_seconds, *, device=None) -> torch.Tensor:
    """Complex tap gains at the given times: t (...,) → (..., ntaps)
    complex64, on the device of t (a tensor) or on `device` (None: the card)."""
    t = _times(t_seconds, device)
    freqs, theta, phi, amp, _ = table(_sos_params, cfg, device=t.device)
    w = 2 * np.pi * freqs  # (ntaps, N)
    wt = w * t[..., None, None]
    re = torch.sum(torch.cos(wt + theta), dim=-1)
    im = torch.sum(torch.sin(wt + phi), dim=-1)
    # var(sum of N random-phase cosines) = N/2 per quadrature → E|g|^2 = 1
    g = torch.complex(re, im) / np.sqrt(N_SINUSOIDS)
    return g * amp


def _fftfreq(n: int, d: float) -> np.ndarray:
    return np.fft.fftfreq(n, d).astype(np.float32)


def freq_response(cfg: FadingConfig, t_seconds, nfft: int, *, device=None) -> torch.Tensor:
    """The channel's frequency response at time(s) t: (..., nfft) complex64,
    on the frequency axis of np.fft.fftfreq(nfft, 1/srate)."""
    g = tap_gains(cfg, t_seconds, device=device)  # (..., ntaps)
    delays = table(_sos_params, cfg, device=g.device)[4]
    f = table(_fftfreq, nfft, 1.0 / cfg.srate, device=g.device)
    phase = torch.exp((-2j * np.pi) * f[:, None] * delays[None, :])  # (nfft, ntaps)
    return torch.einsum("...t,ft->...f", g, phase)


def apply_fading(cfg: FadingConfig, samples: torch.Tensor, t0_seconds=0.0):
    """Block fading of (..., n) complex64 samples on their device (the
    channel frozen over the block, at time t0).  Returns (faded samples,
    H (..., n))."""
    h = freq_response(cfg, t0_seconds, samples.shape[-1], device=samples.device)
    y = torch.fft.ifft(torch.fft.fft(samples, dim=-1) * h, dim=-1)
    return y.to(torch.complex64), h


def awgn(generator: torch.Generator, samples: torch.Tensor, snr_db, signal_power=None) -> torch.Tensor:
    """Add complex AWGN at the given SNR (ch_awgn.c), drawn from `generator`
    on the samples' device: noise power = signal power · 10^(-snr/10), the
    signal power measured over the block unless given."""
    p = torch.mean(samples.abs() ** 2) if signal_power is None else torch.as_tensor(
        signal_power, dtype=torch.float32, device=samples.device)
    n0 = p * 10.0 ** (-snr_db / 10.0)
    # complex normal with unit total variance (E|z|^2 = 1)
    noise = torch.randn(samples.shape, dtype=torch.complex64, device=samples.device,
                        generator=generator)
    return (samples + noise * torch.sqrt(n0)).to(torch.complex64)


@dataclasses.dataclass(frozen=True)
class RlfConfig:
    """Radio-link-failure burst gater (channel/rlf.c): the signal is zeroed
    for `t_off_ms` every `t_on_ms + t_off_ms`."""

    t_on_ms: int = 10000
    t_off_ms: int = 2000


def apply_rlf(cfg: RlfConfig, samples: torch.Tensor, t_ms) -> torch.Tensor:
    period = cfg.t_on_ms + cfg.t_off_ms
    gate = (_times(t_ms, samples.device) % period) < cfg.t_on_ms
    return samples * gate.to(samples.dtype)


def apply_delay(samples: torch.Tensor, delay_samples: float) -> torch.Tensor:
    """Fractional delay by a frequency-domain phase ramp (delay.c), on the
    samples' device."""
    f = table(_fftfreq, samples.shape[-1], 1.0, device=samples.device)
    ramp = torch.exp((-2j * np.pi) * f * delay_samples)
    return torch.fft.ifft(torch.fft.fft(samples, dim=-1) * ramp, dim=-1).to(torch.complex64)


def hst_doppler_shift(fd_hz: float, period_s: float, t_s, *, device=None) -> torch.Tensor:
    """High-speed-train Doppler trajectory (TS 36.101 B.3; hst.c): a
    cosine-shaped shift of ±fd over the period, float32 on the device of t
    (a tensor) or on `device` (None: the card)."""
    x = (_times(t_s, device) % period_s) / period_s
    return fd_hz * torch.cos(2 * np.pi * x)
