"""`srsran_tpu_torch/phy/resampling.py` against the JAX reference, on the CPU.

The resampling cases of `tests/test_resampling_io.py` on the port (tone
frequencies, block/full agreement, the arbitrary-ratio resampler's error
bounds, batching), and parity with the reference on the same numpy inputs:
every function within 1e-5 (absolute, on unit-amplitude inputs; both run
complex64 FFTs and products, in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.resampling as r_res
import srsran_tpu_torch.phy.resampling as t_res
from srsran_tpu_torch.phy.resampling import (
    decimate,
    interp_linear,
    resample_arb,
    resample_fft,
    resample_fft_blocks,
)

torch.set_num_threads(1)

ATOL = 1e-5


def tone(n, f, fs):
    return np.exp(2j * np.pi * f * np.arange(n) / fs).astype(np.complex64)


def noise(shape, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(np.complex64)


def t(x):
    return torch.from_numpy(x)


# --- tests/test_resampling_io.py on the port --------------------------------------


def test_interp_linear():
    y = interp_linear(t(np.array([0.0, 1.0, 2.0], np.complex64)), 2).numpy()
    np.testing.assert_allclose(y.real, [0, 0.5, 1, 1.5, 2, 2.5], atol=1e-6)


def test_resample_fft_tone():
    fs = 1.92e6
    x = tone(1920, 100e3, fs)
    y = resample_fft(t(x), 2, 1).numpy()  # 2x upsample
    f_peak = np.argmax(np.abs(np.fft.fft(y))) / len(y) * (2 * fs)
    assert abs(f_peak - 100e3) < 1e3
    np.testing.assert_allclose(resample_fft(t(y), 1, 2).numpy(), x, atol=1e-2)


def test_resample_blocks_matches_full():
    n = 4096
    x = sum(tone(n, f, 1.92e6) for f in (50e3, -120e3, 333e3)).astype(np.complex64)
    full = resample_fft(t(x), 2, 1).numpy()
    blk = resample_fft_blocks(t(x.reshape(4, 1024)), 2, 1, halo=128).numpy().reshape(-1)
    # the interior matches closely (edges differ by design)
    err = np.abs(blk[2048 + 256: 4096 + 2048 - 256] - full[2048 + 256: 4096 + 2048 - 256])
    assert np.max(err) < 0.05, np.max(err)


def test_decimate_tone():
    fs = 7.68e6
    y = decimate(t(tone(7680, 200e3, fs)), 4).numpy()
    assert len(y) == 1920
    f_peak = np.argmax(np.abs(np.fft.fft(y))) / len(y) * (fs / 4)
    assert abs(f_peak - 200e3) < 2e3


def test_resample_arb_tone_accuracy():
    n, f = 4096, 0.03
    x = np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)
    for rate, bound_db in ((1.2345, -70), (0.75, -70), (1.92 / 1.5, -70), (0.5, -40)):
        y = resample_arb(t(x), rate).numpy()
        assert len(y) == int(np.floor(n * rate))
        ref = np.exp(2j * np.pi * f * np.arange(len(y)) / rate)
        sl = slice(32, len(y) - 32)
        err = float(np.mean(np.abs(y[sl] - ref[sl]) ** 2))
        assert 10 * np.log10(err) < bound_db, (rate, 10 * np.log10(err))


def test_resample_arb_batched():
    x = noise((3, 512), 0)
    y = resample_arb(t(x), 1.5).numpy()
    assert y.shape == (3, 768)
    np.testing.assert_allclose(y[1], resample_arb(t(x[1]), 1.5).numpy(), rtol=1e-5, atol=1e-5)


# --- against the reference ----------------------------------------------------------


def same(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,ratio", [((100,), 2), ((3, 64), 4), ((2, 2, 33), 3)])
def test_interp_linear_against_reference(shape, ratio):
    x = noise(shape, ratio)
    same(interp_linear(t(x), ratio), r_res.interp_linear(jnp.asarray(x), ratio))


@pytest.mark.parametrize("n,p,q", [(1920, 2, 1), (3840, 1, 2), (1536, 4, 3), (2048, 3, 4)])
def test_resample_fft_against_reference(n, p, q):
    x = noise((2, n), n)
    same(resample_fft(t(x), p, q), r_res.resample_fft(jnp.asarray(x), p, q))


@pytest.mark.parametrize("nb,blk,p,q,halo", [(4, 1024, 2, 1, 128), (6, 512, 1, 2, 64), (3, 768, 4, 3, 96)])
def test_resample_fft_blocks_against_reference(nb, blk, p, q, halo):
    x = noise((nb, blk), blk)
    same(resample_fft_blocks(t(x), p, q, halo), r_res.resample_fft_blocks(jnp.asarray(x), p, q, halo))


@pytest.mark.parametrize("shape,factor,ntaps", [((7680,), 4, 33), ((2, 1920), 2, 33), ((3, 960), 3, 17)])
def test_decimate_against_reference(shape, factor, ntaps):
    x = noise(shape, factor)
    same(decimate(t(x), factor, ntaps), r_res.decimate(jnp.asarray(x), factor, ntaps))


@pytest.mark.parametrize("shape,rate", [((4096,), 1.2345), ((2, 1000), 0.75), ((1920,), 1.28), ((3, 512), 0.5)])
def test_resample_arb_against_reference(shape, rate):
    x = noise(shape, int(rate * 100))
    same(resample_arb(t(x), rate), r_res.resample_arb(jnp.asarray(x), rate))
    cutoff = 0.5 * min(1.0, rate)
    np.testing.assert_array_equal(t_res._arb_polyphase_bank(32, 8, cutoff),
                                  r_res._arb_polyphase_bank(32, 8, cutoff))
