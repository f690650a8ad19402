"""The port's UE DL SISO subframe decode against the JAX reference's
`ue_dl_subframe` (jitted and vmapped on the CPU, scan MAP backend), on the
same two noisy subframes made by the reference's own transmitter."""

import jax
import numpy as np
import pytest
import torch

from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.fec.cbsegm import cbsegm
from srsran_tpu.phy.modem import Mod
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
from srsran_tpu.pipeline import ue_dl_subframe as ref_ue_dl_subframe
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.pipeline import ue_dl_subframe

torch.set_num_threads(1)


# (PRB, modulation, tbs, noise amplitude): 6 PRB QPSK with one codeblock;
# 25 PRB QAM16 and QAM64 with tbs picked for C=2, F=56 and two K sizes
CASES = [(6, Mod.QPSK, 504, 0.3), (25, Mod.QAM16, 6208, 0.08), (25, Mod.QAM64, 9024, 0.04)]


def check_against_reference(cell, grant, amp, rng):
    """Two noisy subframes of one grant through the reference and the port:
    identical TB bits and crc_ok, snr_db within 1e-3 dB, every TB passes."""
    tbs = grant.tbs
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    grid = pdsch_encode_np(cell, 2, 1, grant, tb)
    put_crs_np(grid, cell, 2)
    tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))[0]
    shape = (2, 1, tx.size)
    rx = (tx[None, None] + amp * (rng.standard_normal(shape)
                                  + 1j * rng.standard_normal(shape))).astype(np.complex64)

    ref_fn = jax.jit(jax.vmap(ref_ue_dl_subframe(cell, 2, 1, grant, max_iterations=6)))
    ref_tb, ref_ok, ref_snr = (np.asarray(v) for v in ref_fn(rx))
    fn = ue_dl_subframe(from_reference(cell), 2, 1, from_reference(grant), 6, device="cpu")
    got_tb, got_ok, got_snr = fn(torch.from_numpy(rx))

    assert got_tb.shape == (2, tbs) and got_tb.dtype == torch.uint8
    np.testing.assert_array_equal(got_tb.numpy(), ref_tb)
    assert got_ok.dtype == torch.bool
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    # snr_db from FFT + einsum sums in another order: 1e-3 dB
    np.testing.assert_allclose(got_snr.numpy(), ref_snr, atol=1e-3)
    assert got_ok.all() and (got_tb.numpy() == tb).all()


@pytest.mark.parametrize("prb,mod,tbs,amp", CASES)
def test_ue_dl_subframe_matches_reference(prb, mod, tbs, amp):
    rng = np.random.default_rng(prb * 100 + int(mod))
    if prb == 25:
        s = cbsegm(tbs)
        assert s.C > 1 and s.F > 0 and s.K_minus != s.K_plus
    check_against_reference(Cell(nof_prb=prb, id=7), DlGrant(prb=tuple(range(prb)), mod=mod, tbs=tbs),
                            amp, rng)


def test_ue_dl_subframe_off_the_standard_rates():
    """25 PRB on the 384-point grid of the reduced sample rate
    (`use_standard_rates=False`)."""
    cell = Cell(nof_prb=25, id=7, use_standard_rates=False)
    assert cell.symbol_sz == 384
    check_against_reference(cell, DlGrant(prb=tuple(range(25)), mod=Mod.QAM16, tbs=6208), 0.08,
                            np.random.default_rng(2501))


def test_ue_dl_subframe_checks_its_inputs():
    cell = from_reference(Cell(nof_prb=6))
    grant = from_reference(DlGrant(prb=tuple(range(6)), tbs=504))
    fn = ue_dl_subframe(cell, 2, 1, grant, device="cpu")
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 1, cell.sf_len), dtype=torch.complex64, device="meta"))
    with pytest.raises(NotImplementedError):
        ue_dl_subframe(cell, 2, 1, from_reference(DlGrant(prb=(0,), tbs=16, tx_scheme="cdd")),
                       device="cpu")


# --- the carrier pipeline (`multi_carrier_ue_dl`) --------------------------------


def carrier_tx(cell, sf_idx, grant, rng, amp=0.0):
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
    put_crs_np(grid, cell, sf_idx)
    tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))[0]
    noise = amp * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
    return tb, (tx + noise).astype(np.complex64)


def test_multi_carrier_sharded():
    """`tests/test_pipeline.py::test_multi_carrier_sharded` on the port: 8
    carriers over an 8-position mesh of the CPU against the reference over
    JAX's 8 virtual devices; identical TBs and verdicts, total_ok 8, and
    the meshless form identical too."""
    from jax.sharding import Mesh

    from srsran_tpu.pipeline import multi_carrier_ue_dl as ref_multi
    from srsran_tpu_torch.parallel import carrier_mesh
    from srsran_tpu_torch.pipeline import multi_carrier_ue_dl

    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    grant = DlGrant(prb=tuple(range(6)), mod=Mod.QPSK, tbs=408)
    tb, tx = carrier_tx(cell, 1, grant, np.random.default_rng(0))
    samples = np.tile(tx[None, None], (8, 1, 1))
    ref_tb, ref_ok, ref_total = ref_multi(cell, 1, 1, grant, mesh=Mesh(np.array(jax.devices()), ("carriers",)))(samples)
    mesh = carrier_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"carriers": 8, "samples": 1}
    fn = multi_carrier_ue_dl(from_reference(cell), 1, 1, from_reference(grant), mesh=mesh)
    got_tb, got_ok, total = fn(torch.from_numpy(samples))
    assert int(total) == int(ref_total) == 8 and total.dtype == torch.int32
    assert got_tb.shape == (8, grant.tbs)
    np.testing.assert_array_equal(got_tb.numpy(), np.asarray(ref_tb))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(got_tb[3].numpy(), tb)
    plain = multi_carrier_ue_dl(from_reference(cell), 1, 1, from_reference(grant), device="cpu")
    for a, b in zip(plain(torch.from_numpy(samples)), (got_tb, got_ok, total)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not split"):
        fn(torch.from_numpy(samples[:5]))
    with pytest.raises(ValueError, match="positions name the devices"):
        multi_carrier_ue_dl(from_reference(cell), 1, 1, from_reference(grant), mesh=mesh, device="cpu")


def test_weak_scaling_correctness():
    """The correctness half of `tests/test_scaling.py::
    test_weak_scaling_correctness_and_curve` (its host-throughput assertion
    is not ported: it failed under load; `chip_smoke.py` prints the curve on
    the card): n carriers of one noisy 15 PRB QAM16 subframe over n positions,
    n = 1, 2, 4, 8, against the reference over n virtual devices."""
    from jax.sharding import Mesh

    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.pipeline import multi_carrier_ue_dl as ref_multi
    from srsran_tpu_torch.parallel import carrier_mesh
    from srsran_tpu_torch.pipeline import multi_carrier_ue_dl

    rng = np.random.default_rng(0)
    cell = Cell(nof_prb=15, nof_ports=1, id=11)
    grant = DlGrant(prb=tuple(range(15)), mod=Mod.QAM16, tbs=dl_tbs(8, 15))
    tb, rx1 = carrier_tx(cell, 2, grant, rng, amp=0.02)
    for n in (1, 2, 4, 8):
        s = np.tile(rx1[None, None, :], (n, 1, 1))
        ref_tb, ref_ok, ref_total = ref_multi(
            cell, 2, 1, grant, mesh=Mesh(np.asarray(jax.devices()[:n]), ("carriers",)))(s)
        fn = multi_carrier_ue_dl(from_reference(cell), 2, 1, from_reference(grant),
                                 mesh=carrier_mesh(devices=["cpu"] * n))
        got_tb, got_ok, total = fn(torch.from_numpy(s))
        assert int(total) == int(ref_total) == n
        np.testing.assert_array_equal(got_tb.numpy(), np.asarray(ref_tb))
        np.testing.assert_array_equal(got_tb[n - 1].numpy(), tb)
