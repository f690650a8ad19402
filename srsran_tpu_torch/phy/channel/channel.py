"""Composed, config-driven channel emulator.

Counterpart of `srsran_tpu/phy/channel/channel.py` (`lib/src/phy/channel/
channel.cc`, config `channel.h:43-79`): fading, high-speed-train Doppler,
delay drift, radio-link-failure gating and AWGN chained from one
`ChannelConfig`, with a clock advanced by each call as the reference's
per-subframe `srslte_channel_*_execute` chain.  A `Channel` lives on one
device (None: the card) with its own seeded `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import as_samples, resolve
from .fading import (
    FadingConfig,
    RlfConfig,
    apply_delay,
    apply_fading,
    apply_rlf,
    awgn,
    hst_doppler_shift,
)


@dataclasses.dataclass
class DelayConfig:
    """Periodic delay drift (delay.c; ue.conf.example [channel.dl.delay])."""

    min_us: float = 0.0
    max_us: float = 0.0
    period_s: float = 3600.0


@dataclasses.dataclass
class HstConfig:
    """High-speed-train Doppler profile (hst.c)."""

    fd_hz: float = 0.0
    period_s: float = 7.2


@dataclasses.dataclass
class ChannelConfig:
    """The [channel.*] config section (channel.h:43-79)."""

    enable: bool = True
    fading: FadingConfig | None = None
    awgn_snr_db: float | None = None
    delay: DelayConfig | None = None
    hst: HstConfig | None = None
    rlf: RlfConfig | None = None
    srate: float = 1.92e6
    seed: int = 0


class Channel:
    """The impairments of one `ChannelConfig` with a time cursor advanced by
    each block (channel.cc), on `device` (None: the card)."""

    def __init__(self, cfg: ChannelConfig, *, device=None):
        self.cfg = cfg
        self.t = 0.0
        self.device = resolve(device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def run(self, samples) -> torch.Tensor:
        """Apply the configured impairments to one block of (..., n) samples
        (numpy or a tensor), moved to the channel's device."""
        cfg = self.cfg
        out = as_samples(samples, self.device)
        n = out.shape[-1]
        dt = n / cfg.srate
        if not cfg.enable:
            self.t += dt
            return out
        if cfg.fading is not None:
            out, _ = apply_fading(cfg.fading, out, t0_seconds=self.t)
        if cfg.hst is not None and cfg.hst.fd_hz:
            shift = hst_doppler_shift(cfg.hst.fd_hz, cfg.hst.period_s, self.t, device=self.device)
            ph = (2j * np.pi) * shift * torch.arange(n, device=self.device) / cfg.srate
            out = out * torch.exp(ph)
        if cfg.delay is not None and cfg.delay.max_us > 0:
            # triangular drift between min and max over the period
            frac = (self.t % cfg.delay.period_s) / cfg.delay.period_s
            tri = 2 * frac if frac < 0.5 else 2 * (1 - frac)
            d_us = cfg.delay.min_us + (cfg.delay.max_us - cfg.delay.min_us) * tri
            out = apply_delay(out, d_us * 1e-6 * cfg.srate)
        if cfg.rlf is not None:
            out = apply_rlf(cfg.rlf, out, self.t * 1e3)
        if cfg.awgn_snr_db is not None:
            out = awgn(self.generator, out, cfg.awgn_snr_db)
        self.t += dt
        return out
