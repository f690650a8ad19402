"""Each device module of the port against its JAX counterpart, on the same
numpy inputs made from a seed (JAX on the CPU, torch on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.chest.chest_dl as r_chest
import srsran_tpu.phy.common as r_common
import srsran_tpu.phy.crc as r_crc
import srsran_tpu.phy.fec.rate_match as r_rm
import srsran_tpu.phy.fec.turbo as r_turbo
import srsran_tpu.phy.mimo as r_mimo
import srsran_tpu.phy.modem as r_modem
import srsran_tpu.phy.ofdm as r_ofdm
import srsran_tpu.phy.phch.pdsch as r_pdsch
import srsran_tpu.phy.phch.sch as r_sch
import srsran_tpu.phy.scrambling as r_scr
import srsran_tpu_torch.phy.chest.chest_dl as t_chest
import srsran_tpu_torch.phy.crc as t_crc
import srsran_tpu_torch.phy.fec.rate_match as t_rm
import srsran_tpu_torch.phy.fec.turbo as t_turbo
import srsran_tpu_torch.phy.mimo as t_mimo
import srsran_tpu_torch.phy.modem as t_modem
import srsran_tpu_torch.phy.ofdm as t_ofdm
import srsran_tpu_torch.phy.phch.sch as t_sch
import srsran_tpu_torch.phy.scrambling as t_scr
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("prb,shift,woff", [(6, 0.0, 0.0), (25, 0.0, 0.0), (6, 0.5, 0.0), (25, 0.0, 0.3)])
def test_ofdm_rx(prb, shift, woff):
    """FFT by pocketfft (torch) and ducc (XLA) in complex64 differ only by
    summation order: rtol/atol 1e-4 on unit-variance bins."""
    cfg_ref = r_ofdm.OfdmConfig(nof_prb=prb, normalize=True, freq_shift_f=shift,
                                rx_window_offset=woff)
    cfg = from_reference(cfg_ref)
    assert cfg.symbol_starts() == cfg_ref.symbol_starts()
    for a, b in zip(t_ofdm._phase_tables(cfg), r_ofdm._phase_tables(cfg_ref)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    x = cplx(np.random.default_rng(prb), (2, 1, cfg.sf_sz))
    ref = np.asarray(r_ofdm.ofdm_rx_sf(cfg_ref, jnp.asarray(x)))
    got = t_ofdm.ofdm_rx_sf(cfg, t(x)).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prb,ports,smooth,interp", [(6, 1, 3, True), (25, 2, 3, True), (25, 1, 0, False)])
def test_chest_dl(prb, ports, smooth, interp):
    """Einsum order differs (complex64): rtol 1e-5, atol 1e-5 on O(1) values."""
    cell_ref = r_common.Cell(nof_prb=prb, id=13, nof_ports=ports)
    cfg_ref = r_chest.ChestDlConfig(smooth_len=smooth, time_interp=interp)
    grid = cplx(np.random.default_rng(prb + ports), (2, 1, 14, prb * 12))
    ref = r_chest.chest_dl(jnp.asarray(grid), cell_ref, 2, cfg_ref, nof_ports=ports)
    got = t_chest.chest_dl(t(grid), from_reference(cell_ref), 2, from_reference(cfg_ref),
                           nof_ports=ports)
    for key in ("ce", "noise", "rsrp", "snr"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-5)


def test_chest_dl_wiener_not_ported():
    """The "wiener" branch, once not ported, now against the reference: the
    fixed MMSE matrices, in a full subframe and cut at a DwPTS's
    last_symbol; products of complex64: rtol 1e-5, atol 1e-5."""
    cell_ref = r_common.Cell(nof_prb=15, id=5, nof_ports=2)
    cfg_ref = r_chest.ChestDlConfig(algorithm="wiener")
    grid = cplx(np.random.default_rng(78), (2, 14, 180))
    for last in (None, 9):
        ref = r_chest.chest_dl(jnp.asarray(grid), cell_ref, 6, cfg_ref, nof_ports=2, last_symbol=last)
        got = t_chest.chest_dl(t(grid), from_reference(cell_ref), 6, from_reference(cfg_ref),
                               nof_ports=2, last_symbol=last)
        for key in ("ce", "noise", "rsrp", "snr"):
            assert got[key].shape == ref[key].shape, key
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mod", list(r_modem.Mod))
def test_demod_soft(mod):
    """Elementwise float32 arithmetic; thresholds rounded alike: atol 1e-6."""
    sym = cplx(np.random.default_rng(int(mod)), (3, 200), 0.8)
    ref = np.asarray(r_modem.demod_soft(mod, jnp.asarray(sym)))
    got = t_modem.demod_soft(t_modem.Mod(int(mod)), t(sym)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("nrx", [1, 2])
def test_predecode_single_mrc(nrx):
    """Complex64 products and a sum over <= 2 antennas: rtol 1e-5."""
    rng = np.random.default_rng(nrx)
    y, h = cplx(rng, (2, nrx, 300)), cplx(rng, (2, nrx, 300))
    noise = np.float32(0.05)
    rx, rcsi = r_mimo.predecode_single_mrc(jnp.asarray(y), jnp.asarray(h), noise)
    x, csi = t_mimo.predecode_single_mrc(t(y), t(h), noise)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(csi.numpy(), np.asarray(rcsi), rtol=1e-5)


def test_scramble_soft():
    rng = np.random.default_rng(5)
    llr = rng.standard_normal((2, 500)).astype(np.float32)
    signs = (1 - 2 * rng.integers(0, 2, 500)).astype(np.float32)
    np.testing.assert_array_equal(t_scr.scramble_soft(t(llr), t(signs)).numpy(),
                                  np.asarray(r_scr.scramble_soft(jnp.asarray(llr), signs)))


@pytest.mark.parametrize("poly", [r_common.LTE_CRC24A, r_common.LTE_CRC24B, r_common.LTE_CRC16, r_common.LTE_CRC8])
def test_crc_compute_and_ok(poly):
    """GF(2) sums stay below 2^24 in float32: exact."""
    rng = np.random.default_rng(poly & 0xFF)
    bits = rng.integers(0, 2, (4, 1000)).astype(np.uint8)
    np.testing.assert_array_equal(t_crc.crc_compute(t(bits), poly).numpy(),
                                  np.asarray(r_crc.crc_compute(jnp.asarray(bits), poly)))
    with_crc = np.stack([r_crc.crc_attach_np(b, poly) for b in bits])
    with_crc[1, 3] ^= 1
    np.testing.assert_array_equal(t_crc.crc_ok(t(with_crc), poly).numpy(),
                                  np.asarray(r_crc.crc_ok(jnp.asarray(with_crc), poly)))
    assert t_crc.crc_ok(t(with_crc), poly).tolist() == [True, False, True, True]


@pytest.mark.parametrize("k,e,rv,f", [(40, 120, 0, 0), (512, 1000, 2, 8), (512, 3000, 1, 0),
                                      (3200, 12000, 3, 56)])
def test_turbo_rate_match_rx(k, e, rv, f):
    """e > 3(K+4) repeats positions; summing repetitions in another order
    differs in the last ulp: atol 1e-5 on unit-variance LLRs."""
    llr = np.random.default_rng(k + e).standard_normal((2, e)).astype(np.float32)
    ref = np.asarray(r_rm.turbo_rate_match_rx(jnp.asarray(llr), k, rv, n_filler=f))
    got = t_rm.turbo_rate_match_rx(t(llr), k, rv, n_filler=f).numpy()
    assert got.shape == (2, 3, k + 4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_dstream_tails_and_beta_tail():
    """Same float32 adds in the same order: atol 1e-6."""
    d_tail = np.random.default_rng(1).standard_normal((3, 3, 4)).astype(np.float32)
    ref = r_turbo.dstream_tails(jnp.asarray(d_tail))
    got = t_turbo.dstream_tails(t(d_tail))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t_turbo._beta_tail(got[0], got[1]).numpy(),
                               np.asarray(r_turbo._beta_tail(ref[0], ref[1])), atol=1e-6)


def test_from_reference_configs():
    ref_objs = [
        r_common.Cell(nof_prb=25, nof_ports=2, id=7, cp=r_common.CP.EXT),
        r_pdsch.DlGrant(prb=(0, 1, 2), mod=r_modem.Mod.QAM64, tbs=504, rv=2, rnti=77),
        r_chest.ChestDlConfig(smooth_len=0, time_interp=False),
        r_ofdm.OfdmConfig(nof_prb=15, normalize=True, rx_window_offset=0.25),
        r_sch.TbCoding(tbs=6208, g=15000, qm=4, rv=1),
    ]
    for obj in ref_objs:
        port = from_reference(obj)
        assert type(port).__name__ == type(obj).__name__
        assert type(port).__module__.startswith("srsran_tpu_torch.")
        # every field of the port's class carries the reference's value
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(obj, f.name), f.name
    assert isinstance(from_reference(ref_objs[1]).mod, t_modem.Mod)
    assert from_reference(ref_objs[4]).e_sizes() == ref_objs[4].e_sizes()
    with pytest.raises(TypeError):
        from_reference(object())


@pytest.mark.parametrize("tbs,g,qm", [(504, 1656, 2), (6208, 15000, 4)])
def test_dlsch_decode_device(tbs, g, qm):
    """Segmentation with C > 1 and filler bits (tbs 6208: C=2, F=56, two K):
    decoded TB bits and CRC verdicts identical to the reference."""
    rng = np.random.default_rng(tbs)
    cfg_ref = r_sch.TbCoding(tbs=tbs, g=g, qm=qm)
    tbs_bits = rng.integers(0, 2, (2, tbs)).astype(np.uint8)
    coded = np.stack([r_sch.dlsch_encode_np(b, cfg_ref) for b in tbs_bits])
    llr = ((2.0 * coded - 1.0) * 2.5 + 1.6 * rng.standard_normal(coded.shape)).astype(np.float32)
    llr[1, :300] = 0.0  # an erased stretch
    ref_tb, ref_ok = jax.jit(jax.vmap(lambda row: r_sch.dlsch_decode_device(row, cfg_ref, 6)))(
        jnp.asarray(llr))
    tb, ok = t_sch.dlsch_decode_device(t(llr), from_reference(cfg_ref), 6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(ref_tb))
    assert ok.dtype == torch.bool and ok.tolist() == np.asarray(ref_ok).tolist()

