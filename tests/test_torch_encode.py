"""The port's device transmitter against the JAX reference on the CPU: the
closed-form turbo encoder for every codeblock size, the closed-form
modulation mapper, and `enb_dl_subframe_encode` as a whole.

Encoded bits must be equal.  Symbols of `modulate` are the same float32
operations in the same order: equal.  Time-domain samples pass an IFFT that
sums in another order than XLA's: 2e-6 absolute on samples of ~0.02-1
magnitude (the tolerance of the port's `ofdm_tx_sf` test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.fec.turbo as r_turbo
import srsran_tpu.phy.modem as r_modem
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.fec.cbsegm import CB_SIZES
from srsran_tpu.phy.modem import Mod
from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_re_indices
from srsran_tpu.phy.phch.sch import TbCoding, dlsch_encode_np
from srsran_tpu.pipeline import enb_dl_subframe_encode as ref_encode
import srsran_tpu_torch.phy.fec.turbo as t_turbo
import srsran_tpu_torch.phy.modem as t_modem
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.phy.modem import demod_soft
from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_rx_sf
from srsran_tpu_torch.phy.phch.pdsch import pdsch_cinit
from srsran_tpu_torch.phy.sequence import gold_sequence
from srsran_tpu_torch.pipeline import enb_dl_subframe_encode, ue_dl_subframe

torch.set_num_threads(1)

assert len(CB_SIZES) == 188


@pytest.mark.parametrize("k", CB_SIZES)
def test_turbo_encode_device_equals_host_encoder(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (3, k)).astype(np.uint8)
    bits[2] = 1  # the longest carries of the cumulative XOR
    d = t_turbo.turbo_encode_device(torch.from_numpy(bits), k)
    assert d.shape == (3, 3, k + 4) and d.dtype == torch.uint8
    for i in range(3):
        np.testing.assert_array_equal(d[i].numpy(), r_turbo.turbo_encode_np(bits[i]))


@pytest.mark.parametrize("k", [40, 1056, 6144])
def test_turbo_encode_device_equals_reference_device_encoder(k):
    bits = np.random.default_rng(k + 1).integers(0, 2, (4, k)).astype(np.uint8)
    ref = np.asarray(r_turbo.turbo_encode_device(jnp.asarray(bits), k))
    np.testing.assert_array_equal(t_turbo.turbo_encode_device(torch.from_numpy(bits), k).numpy(), ref)
    p, a = t_turbo._rsc_parity_closed_form(torch.from_numpy(bits))
    r_p, r_a = r_turbo._rsc_parity_closed_form(jnp.asarray(bits))
    np.testing.assert_array_equal(p.numpy(), np.asarray(r_p))
    np.testing.assert_array_equal(a.numpy(), np.asarray(r_a))
    with pytest.raises(ValueError):
        t_turbo.turbo_encode_device(torch.from_numpy(bits), k + 8)


@pytest.mark.parametrize("mod", list(Mod))
def test_modulate_equals_reference(mod):
    m = mod.bits_per_symbol
    rng = np.random.default_rng(int(mod))
    every = np.array([[(i >> (m - 1 - j)) & 1 for j in range(m)] for i in range(2**m)], np.uint8)
    bits = np.concatenate([every.reshape(-1), rng.integers(0, 2, 24 * m).astype(np.uint8)])
    bits = np.stack([bits, bits[::-1]])  # a leading batch axis
    ref = np.asarray(r_modem.modulate(mod, jnp.asarray(bits)))
    got = t_modem.modulate(t_modem.Mod(int(mod)), torch.from_numpy(bits.copy()))
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # the table is rounded once from float64, the closed form twice in
    # float32: two ulps of the largest level (1.08)
    np.testing.assert_allclose(got[0, : 2**m].numpy(), r_modem.constellation_np(mod),
                               rtol=0, atol=2.4e-7)


# (PRB, modulation, tbs): one codeblock with 4 filler bits; two of K=3136
# with 20 filler bits and CRC24B; two of K=4608 at QAM64
ENCODE_CASES = [(6, Mod.QPSK, 500), (25, Mod.QAM16, 6180), (25, Mod.QAM64, 9144)]


@pytest.mark.parametrize("prb,mod,tbs", ENCODE_CASES)
def test_enb_dl_subframe_encode_matches_reference(prb, mod, tbs):
    rng = np.random.default_rng(tbs)
    cell = Cell(nof_prb=prb, nof_ports=1, id=301)
    grant = DlGrant(prb=tuple(range(prb)), mod=mod, tbs=tbs, rnti=0x46)
    tbs_all = rng.integers(0, 2, (3, tbs)).astype(np.uint8)
    ref = np.asarray(jax.jit(jax.vmap(ref_encode(cell, 2, 1, grant)))(tbs_all))
    t_cell, t_grant = from_reference(cell), from_reference(grant)
    fn = enb_dl_subframe_encode(t_cell, 2, 1, t_grant, device="cpu")
    got = fn(torch.from_numpy(tbs_all))
    assert got.shape == ref.shape == (3, 1, cell.sf_len) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)

    # the coded bits behind the samples: the receiver's hard decisions before
    # descrambling equal the host encoder's codeword
    idx = pdsch_re_indices(cell, 2, 1, grant.prb)
    coding = TbCoding(tbs=tbs, g=len(idx) * grant.qm, qm=grant.qm)
    grid = ofdm_rx_sf(OfdmConfig.from_cell(t_cell, normalize=True), got[:, 0])
    sym = grid.reshape(3, -1)[:, torch.from_numpy(idx.astype(np.int64))]
    hard = (demod_soft(t_grant.mod, sym) > 0).numpy().astype(np.uint8)
    seq = gold_sequence(pdsch_cinit(grant.rnti, 2, cell.id), coding.g)
    for i in range(3):
        np.testing.assert_array_equal(hard[i] ^ seq, dlsch_encode_np(tbs_all[i], coding))

    # loopback: the port's receiver gives the TBs back
    rx = got + 0.01 * torch.from_numpy(
        (rng.standard_normal(got.shape) + 1j * rng.standard_normal(got.shape)).astype(np.complex64))
    tb, ok, _snr = ue_dl_subframe(t_cell, 2, 1, t_grant, 4, device="cpu")(rx)
    assert ok.all()
    np.testing.assert_array_equal(tb.numpy(), tbs_all)


def test_enb_dl_subframe_encode_keeps_the_reference_limits():
    cell = from_reference(Cell(nof_prb=25, nof_ports=2, id=1))
    ok = from_reference(DlGrant(prb=tuple(range(25)), mod=Mod.QAM16, tbs=6200))
    fn = enb_dl_subframe_encode(cell, 0, 2, ok, device="cpu")
    out = fn(torch.zeros((1, 6200), dtype=torch.uint8))
    assert out.shape == (1, 2, cell.sf_len)  # both ports carry their CRS
    assert float(out[0, 1].abs().max()) > 0
    with pytest.raises(ValueError):  # codeblocks of two sizes
        enb_dl_subframe_encode(cell, 0, 2, from_reference(
            DlGrant(prb=tuple(range(25)), mod=Mod.QAM16, tbs=6208)), device="cpu")
    with pytest.raises(ValueError):
        enb_dl_subframe_encode(cell, 0, 2, from_reference(
            DlGrant(prb=tuple(range(25)), mod=Mod.QAM16, tbs=6200, tx_scheme="diversity")),
            device="cpu")
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 6200), dtype=torch.uint8, device="meta"))
