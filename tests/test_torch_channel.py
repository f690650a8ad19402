"""The port's channel emulator (`srsran_tpu_torch/phy/channel/{fading,
channel}.py`) against the JAX reference on the CPU, on the same numpy
inputs made from a seed.

Tolerances: the sum-of-sinusoids parameters (the taps) bit-identical; tap
gains, frequency responses, `apply_fading`, `apply_delay`, the HST Doppler
trajectory, the RLF gate and a `Channel` without AWGN within 2e-6 of the
largest magnitude.  `awgn` draws from a `torch.Generator` where the
reference draws from a JAX key, so its noise is held to its statistics: the
SNR it makes within 0.1 dB over 10⁵ samples, zero mean, equal power in I and
Q, and the same draw again from the same seed.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import srsran_tpu.phy.channel.channel as r_ch
import srsran_tpu.phy.channel.fading as r_fad
import srsran_tpu_torch.phy.channel.channel as t_ch
import srsran_tpu_torch.phy.channel.fading as t_fad
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)

CPU = "cpu"
ATOL = 2e-6


def close(got, ref, rel=ATOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30))


def signal(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("model", ["epa", "eva", "etu", "none"])
def test_taps_and_responses(model):
    ref = r_fad.FadingConfig(model=model, doppler_hz=70.0, srate=7.68e6, seed=11)
    cfg = from_reference(ref)
    assert cfg == t_fad.FadingConfig(model=model, doppler_hz=70.0, srate=7.68e6, seed=11)
    assert t_fad.DELAY_PROFILES == r_fad.DELAY_PROFILES
    for a, b in zip(t_fad._sos_params(cfg), r_fad._sos_params(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    t = np.array([0.0, 0.013, 0.25, 1.5], np.float32)
    close(t_fad.tap_gains(cfg, torch.from_numpy(t)).numpy(), r_fad.tap_gains(ref, t))
    close(t_fad.freq_response(cfg, 0.004, 512, device=CPU).numpy(),
          r_fad.freq_response(ref, 0.004, 512))
    x = signal(1, 2, 3840)
    got, h = t_fad.apply_fading(cfg, torch.from_numpy(x), 0.021)
    want, h_ref = r_fad.apply_fading(ref, x, 0.021)
    close(h.numpy(), h_ref)
    close(got.numpy(), want)


def test_delay_hst_and_rlf():
    x = signal(2, 1920)
    for d in (0.0, 3.0, 7.25, -2.5):
        close(t_fad.apply_delay(torch.from_numpy(x), d).numpy(), r_fad.apply_delay(x, d))
    ts = np.linspace(0.0, 20.0, 97).astype(np.float32)
    close(t_fad.hst_doppler_shift(750.0, 7.2, torch.from_numpy(ts)).numpy(),
          r_fad.hst_doppler_shift(750.0, 7.2, ts))
    rlf_r = r_fad.RlfConfig(t_on_ms=30, t_off_ms=10)
    rlf = from_reference(rlf_r)
    for t_ms in (0.0, 29.0, 31.5, 45.0):
        np.testing.assert_array_equal(t_fad.apply_rlf(rlf, torch.from_numpy(x), t_ms).numpy(),
                                      np.asarray(r_fad.apply_rlf(rlf_r, x, t_ms)))


def test_channel_run_without_noise():
    """Fading, HST Doppler, delay drift and RLF chained, the clock carried
    across eight blocks."""
    ref = r_ch.ChannelConfig(fading=r_fad.FadingConfig(model="eva", doppler_hz=300.0, srate=1.92e6,
                                                        seed=5),
                             hst=r_ch.HstConfig(fd_hz=900.0, period_s=0.05),
                             delay=r_ch.DelayConfig(min_us=1.0, max_us=4.0, period_s=0.006),
                             rlf=r_fad.RlfConfig(t_on_ms=5, t_off_ms=2), srate=1.92e6, seed=3)
    cfg = from_reference(ref)
    assert isinstance(cfg.fading, t_fad.FadingConfig) and isinstance(cfg.hst, t_ch.HstConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    rc, tc = r_ch.Channel(ref), t_ch.Channel(cfg, device=CPU)
    for i in range(8):
        x = signal(10 + i, 1920)
        got = tc.run(x)
        close(got.numpy(), np.asarray(rc.run(x)))
        assert tc.t == rc.t
    off = t_ch.Channel(dataclasses.replace(cfg, enable=False), device=CPU)
    np.testing.assert_array_equal(off.run(x).numpy(), x)


def test_awgn_statistics():
    """The noise makes the SNR asked for; the reference's does too."""
    x = signal(4, 100_000) * 0.3
    gen = torch.Generator(device=CPU).manual_seed(9)
    for snr in (0.0, 10.0, 23.0):
        y = t_fad.awgn(gen, torch.from_numpy(x), snr).numpy()
        n = y - x
        got = 10 * np.log10(np.mean(np.abs(x) ** 2) / np.mean(np.abs(n) ** 2))
        ref_n = np.asarray(r_fad.awgn(jax.random.PRNGKey(1), x, snr)) - x
        want = 10 * np.log10(np.mean(np.abs(x) ** 2) / np.mean(np.abs(ref_n) ** 2))
        assert abs(got - snr) < 0.1 and abs(want - snr) < 0.1, (got, want)
        p = np.mean(np.abs(n) ** 2)
        assert abs(np.mean(n)) < 0.02 * np.sqrt(p)
        assert abs(np.mean(n.real ** 2) / np.mean(n.imag ** 2) - 1) < 0.03
    y = t_fad.awgn(gen, torch.from_numpy(x), 5.0, signal_power=2.0).numpy()
    assert abs(10 * np.log10(2.0 / np.mean(np.abs(y - x) ** 2)) - 5.0) < 0.1
    a, b = (t_ch.Channel(t_ch.ChannelConfig(awgn_snr_db=12.0, seed=4), device=CPU).run(x)
            for _ in range(2))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
