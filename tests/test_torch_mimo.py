"""The port's MIMO module and 2-port decodes against the JAX reference on the
CPU at small sizes: the same numpy inputs, made from a seed, go through the
reference function and its counterpart.

Tolerances: the precoders are the same float32 operations (1e-6 absolute on
unit-power symbols).  The predecoders sum and divide complex64 values in
another order than XLA: relative 2e-5 on well-conditioned channels.  Decoded
TB bits and crc_ok must be identical and snr_db within 1e-4 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.mimo as r_mimo
from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.modem import Mod
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, DlGrant2, pdsch_encode2_np, pdsch_encode_np
from srsran_tpu.pipeline import ue_dl_subframe as ref_ue_dl_subframe
from srsran_tpu.pipeline import ue_dl_subframe_mimo as ref_ue_dl_subframe_mimo
import srsran_tpu_torch.phy.mimo as t_mimo
import srsran_tpu_torch.phy.phch.pdsch as t_pdsch
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.pipeline import ue_dl_subframe, ue_dl_subframe_mimo

torch.set_num_threads(1)

# the 2x2 channel of the reference's bench rows
H_BENCH = np.array([[1.0 + 0.1j, 0.25 - 0.55j], [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
RTOL = 2e-5


def cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref, rtol=RTOL):
    """|got - ref| <= rtol * max|ref|: relative to the array's scale."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


# --- layer mapping and precoding (host) ----------------------------------------


@pytest.mark.parametrize("nof_layers", [1, 2, 3, 4])
def test_layermap_one_codeword(nof_layers):
    x = cplx(np.random.default_rng(nof_layers), 3, 24)
    ref = np.asarray(r_mimo.layermap([jnp.asarray(x)], nof_layers))
    got = t_mimo.layermap([x], nof_layers)
    np.testing.assert_array_equal(got, ref)
    back = t_mimo.layerdemap(t(got), 1)[0]
    np.testing.assert_array_equal(back.numpy(), np.asarray(r_mimo.layerdemap(jnp.asarray(ref), 1)[0]))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("nof_layers", [2, 3, 4])
def test_layermap_two_codewords(nof_layers):
    rng = np.random.default_rng(10 + nof_layers)
    n0, n1 = nof_layers // 2, nof_layers - nof_layers // 2
    cws = [cplx(rng, 12 * n0), cplx(rng, 12 * n1)]
    ref = np.asarray(r_mimo.layermap([jnp.asarray(c) for c in cws], nof_layers))
    got = t_mimo.layermap(cws, nof_layers)
    np.testing.assert_array_equal(got, ref)
    for back, cw in zip(t_mimo.layerdemap(t(got), 2), cws):
        np.testing.assert_array_equal(back.numpy(), cw)
    with pytest.raises(ValueError):
        t_mimo.layermap(cws + cws[:1], nof_layers)


def test_codebooks_equal_reference():
    for nl, n_pmi in ((1, 4), (2, 3)):
        for pmi in range(n_pmi):
            np.testing.assert_array_equal(t_mimo._codebook_2x2(pmi, nl), r_mimo._codebook_2x2(pmi, nl))
    for idx in range(16):
        for nl in (1, 2, 3, 4):
            got, ref = t_mimo._codebook_4(idx, nl), r_mimo._codebook_4(idx, nl)
            assert got.dtype == ref.dtype == np.complex64 and got.shape == (4, nl)
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,args", [
    ("precode_diversity2", ()), ("precode_diversity4", ()), ("precode_cdd2", ()),
    ("precode_spatialmux", (0,)), ("precode_spatialmux", (1,)), ("precode_spatialmux", (2,)),
    ("precode_spatialmux4", (5,)), ("precode_spatialmux4", (14,)),
])
def test_precoders_equal_reference(name, args):
    rng = np.random.default_rng(3)
    x = cplx(rng, 2, 48) if "diversity" in name else cplx(rng, 2, 2, 48)
    ref = np.asarray(getattr(r_mimo, name)(jnp.asarray(x), *args))
    got = getattr(t_mimo, name)(x, *args)
    assert got.dtype == np.complex64
    close(got, ref, 1e-6)
    assert t_mimo.precode_single(x) is x


def test_precode_spatialmux_one_layer():
    x = cplx(np.random.default_rng(4), 1, 36)
    for pmi in range(4):
        close(t_mimo.precode_spatialmux(x, pmi),
              np.asarray(r_mimo.precode_spatialmux(jnp.asarray(x), pmi)), 1e-6)


# --- predecoding (device) ---------------------------------------------------------


def channel(rng, b, nrx, nports, m, bench=False):
    """A channel that varies slowly over the REs around a well-conditioned
    mean: the bench matrix or a random unitary-like one."""
    if bench:
        base = H_BENCH[None, :, :, None]
    else:
        q, _ = np.linalg.qr(cplx(rng, max(nrx, nports), max(nrx, nports)))
        base = q[None, :nrx, :nports, None].astype(np.complex64)
    return (base + 0.05 * cplx(rng, b, nrx, nports, m)).astype(np.complex64)


def test_predecode_single_mrc():
    rng = np.random.default_rng(5)
    y, h = cplx(rng, 3, 2, 60), cplx(rng, 3, 2, 60)
    noise = np.array([0.01, 0.02, 0.05], np.float32)
    ref = jax.vmap(r_mimo.predecode_single_mrc)(y, h, noise)
    got = t_mimo.predecode_single_mrc(t(y), t(h), t(noise)[:, None])
    for g_, r_ in zip(got, ref):
        close(g_.numpy(), r_)


def test_predecode_diversity2_inverts_precode():
    rng = np.random.default_rng(6)
    h = channel(rng, 3, 2, 2, 60)
    x = cplx(rng, 3, 60)
    ports = t_mimo.precode_diversity2(x)  # (3, 2, 60)
    # the pair shares one channel: repeat the even RE's
    h_pair = np.repeat(h[..., ::2], 2, axis=-1)
    y = np.einsum("brpm,bpm->brm", h_pair, ports).astype(np.complex64)
    ref = r_mimo.predecode_diversity2(jnp.asarray(y), jnp.asarray(h_pair))
    got = t_mimo.predecode_diversity2(t(y), t(h_pair))
    for g_, r_ in zip(got, ref):
        close(g_.numpy(), r_)
    close(got[0].numpy(), x, 1e-4)
    with pytest.raises(ValueError):
        t_mimo.predecode_diversity2(t(y[..., :59]), t(h_pair[..., :59]))


@pytest.mark.parametrize("bench", [True, False])
@pytest.mark.parametrize("nof_layers,pmi", [(2, 1), (2, 0), (2, 2), (2, None), (1, 0), (1, 3)])
def test_predecode_zf_mmse(nof_layers, pmi, bench):
    rng = np.random.default_rng(7 + nof_layers)
    h = channel(rng, 3, 2, 2, 120, bench)
    y = cplx(rng, 3, 2, 120)
    noise = np.array([0.002, 0.01, 0.03], np.float32)  # per subframe
    ref = jax.vmap(lambda y_, h_, n_: r_mimo.predecode_zf_mmse(y_, h_, nof_layers, n_, pmi=pmi))(
        y, h, noise)
    got = t_mimo.predecode_zf_mmse(t(y), t(h), nof_layers, t(noise)[:, None], pmi=pmi)
    assert got[0].shape == (3, nof_layers, 120) and got[1].dtype == torch.float32
    for g_, r_ in zip(got, ref):
        close(g_.numpy(), r_)


def test_predecode_zf_mmse_recovers_layers():
    rng = np.random.default_rng(8)
    h = channel(rng, 2, 2, 2, 48, bench=True)
    layers = cplx(rng, 2, 2, 48)
    ports = t_mimo.precode_spatialmux(layers, 1)
    y = np.einsum("brpm,bpm->brm", h, ports).astype(np.complex64)
    x, _ = t_mimo.predecode_zf_mmse(t(y), t(h), 2, 0.0, pmi=1)
    close(x.numpy(), layers, 1e-4)


@pytest.mark.parametrize("nof_layers", [1, 2])
def test_select_pmi(nof_layers):
    rng = np.random.default_rng(9)
    h = channel(rng, 4, 2, 2, 72)
    ref = r_mimo.select_pmi(jnp.asarray(h), nof_layers, 1e-2)
    got = t_mimo.select_pmi(t(h), nof_layers, 1e-2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    close(got[1].numpy(), ref[1])
    close(got[2].numpy(), ref[2], 1e-4)


def test_predecode_diversity4_inverts_precode():
    rng = np.random.default_rng(11)
    h = np.repeat(channel(rng, 1, 2, 4, 12), 4, axis=-1)[0]  # (2, 4, 48), constant per group
    x = cplx(rng, 48)
    y = np.einsum("rpm,pm->rm", h, t_mimo.precode_diversity4(x)).astype(np.complex64)
    ref = r_mimo.predecode_diversity4(jnp.asarray(y), jnp.asarray(h))
    got = t_mimo.predecode_diversity4(t(y), t(h))
    for g_, r_ in zip(got, ref):
        close(g_.numpy(), r_)
    close(got[0].numpy(), x, 1e-4)
    # a leading batch axis gives the same per subframe
    got_b = t_mimo.predecode_diversity4(t(np.stack([y, 2 * y])), t(np.stack([h, h])))
    close(got_b[0][0].numpy(), got[0].numpy(), 1e-6)
    assert got_b[1].shape == (2, 48)


def test_predecode_cdd2():
    rng = np.random.default_rng(12)
    h = channel(rng, 1, 2, 2, 48, bench=True)[0]
    layers = cplx(rng, 2, 48)
    y = np.einsum("rpm,pm->rm", h, t_mimo.precode_cdd2(layers)).astype(np.complex64)
    ref = r_mimo.predecode_cdd2(jnp.asarray(y), jnp.asarray(h), 0.01)
    got = t_mimo.predecode_cdd2(t(y), t(h), 0.01)
    for g_, r_ in zip(got, ref):
        close(g_.numpy(), r_)
    close(t_mimo.predecode_cdd2(t(y), t(h), 0.0)[0].numpy(), layers, 1e-4)


@pytest.mark.parametrize("nof_layers,idx", [(2, 3), (3, 7), (4, 12)])
def test_predecode_spatialmux4(nof_layers, idx):
    rng = np.random.default_rng(13 + nof_layers)
    h = channel(rng, 2, 4, 4, 36)
    layers = cplx(rng, 2, nof_layers, 36)
    y = np.einsum("brpm,bpm->brm", h, t_mimo.precode_spatialmux4(layers, idx)).astype(np.complex64)
    ref = r_mimo.predecode_spatialmux4(jnp.asarray(y), jnp.asarray(h), nof_layers, idx, 0.01)
    got = t_mimo.predecode_spatialmux4(t(y), t(h), nof_layers, idx, 0.01)
    # LU solves of 4x4 systems in another pivot order: 1e-4
    for g_, r_ in zip(got, ref):
        close(g_.numpy(), r_, 1e-4)
    close(t_mimo.predecode_spatialmux4(t(y), t(h), nof_layers, idx, 0.0)[0].numpy(), layers, 1e-3)


# --- host transmitter ---------------------------------------------------------------


@pytest.mark.parametrize("tx_scheme,nof_layers,ports", [
    ("port0", 1, 1), ("diversity", 1, 2), ("spatialmux", 1, 2), ("spatialmux", 2, 2),
    ("cdd", 2, 2), ("diversity4", 1, 4)])
def test_pdsch_encode_np_equals_reference(tx_scheme, nof_layers, ports):
    rng = np.random.default_rng(14)
    cell = Cell(nof_prb=6, nof_ports=ports, id=5)
    grant = DlGrant(prb=(1, 2, 3, 4), mod=Mod.QAM16, tbs=600, tx_scheme=tx_scheme,
                    nof_layers=nof_layers, pmi=1 if tx_scheme == "spatialmux" else 0)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    ref = pdsch_encode_np(cell, 3, 2, grant, tb)
    got = t_pdsch.pdsch_encode_np(from_reference(cell), 3, 2, from_reference(grant), tb)
    assert got.shape == ref.shape == (ports, 14, 72) and got.dtype == np.complex64
    close(got, ref, 1e-6)
    with pytest.raises(NotImplementedError):
        t_pdsch.pdsch_encode_np(from_reference(cell), 3, 2,
                                t_pdsch.DlGrant(prb=(1,), tbs=16, tx_scheme="beamforming"), tb[:16])


@pytest.mark.parametrize("tx_scheme,nof_layers,ports,pmi", [
    ("spatialmux", 2, 2, 1), ("cdd", 2, 2, 0), ("spatialmux4", 3, 4, 6), ("spatialmux4", 4, 4, 9)])
def test_pdsch_encode2_np_equals_reference(tx_scheme, nof_layers, ports, pmi):
    rng = np.random.default_rng(15)
    cell = Cell(nof_prb=6, nof_ports=ports, id=9)
    grant = DlGrant2(prb=(0, 1, 2, 3, 4, 5), mod1=Mod.QPSK, tbs1=328, mod2=Mod.QAM64, tbs2=1800,
                     pmi=pmi, tx_scheme=tx_scheme, nof_layers=nof_layers)
    tb1, tb2 = (rng.integers(0, 2, n).astype(np.uint8) for n in (grant.tbs1, grant.tbs2))
    ref = pdsch_encode2_np(cell, 4, 1, grant, tb1, tb2)
    got = t_pdsch.pdsch_encode2_np(from_reference(cell), 4, 1, from_reference(grant), tb1, tb2)
    assert got.shape == ref.shape and got.dtype == np.complex64
    close(got, ref, 1e-6)


# --- the 2-port decodes as a whole ----------------------------------------------------


def through_channel(grid, cell, sf_idx, rng, amp, nb=2):
    """(nb, 2, sf_len) noisy subframes of a 2-port grid behind the bench channel."""
    put_crs_np(grid, cell, sf_idx)
    tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))
    rx = np.einsum("rp,pt->rt", H_BENCH, tx)
    shape = (nb,) + rx.shape
    return (rx[None] + amp * (rng.standard_normal(shape)
                              + 1j * rng.standard_normal(shape))).astype(np.complex64)


@pytest.mark.parametrize("tx_scheme,nof_layers,mod,tbs,amp", [
    ("diversity", 1, Mod.QAM16, 2216, 0.05), ("spatialmux", 1, Mod.QAM64, 4392, 0.02),
    ("spatialmux", 2, Mod.QAM16, 6200, 0.02)])
def test_ue_dl_subframe_two_ports_matches_reference(tx_scheme, nof_layers, mod, tbs, amp):
    rng = np.random.default_rng(16 + nof_layers)
    cell = Cell(nof_prb=15, nof_ports=2, id=21)
    grant = DlGrant(prb=tuple(range(15)), mod=mod, tbs=tbs, tx_scheme=tx_scheme,
                    nof_layers=nof_layers, pmi=1)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    rx = through_channel(pdsch_encode_np(cell, 2, 1, grant, tb), cell, 2, rng, amp)

    ref_fn = jax.jit(jax.vmap(ref_ue_dl_subframe(cell, 2, 1, grant, max_iterations=6)))
    ref_tb, ref_ok, ref_snr = (np.asarray(v) for v in ref_fn(rx))
    fn = ue_dl_subframe(from_reference(cell), 2, 1, from_reference(grant), 6, device="cpu")
    got_tb, got_ok, got_snr = fn(t(rx))
    np.testing.assert_array_equal(got_tb.numpy(), ref_tb)
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_allclose(got_snr.numpy(), ref_snr, atol=1e-4)
    assert got_ok.all() and (got_tb.numpy() == tb).all()


@pytest.mark.parametrize("mod1,tbs1,mod2,tbs2,amp", [
    (Mod.QAM16, 3240, Mod.QAM16, 3240, 0.02),   # one (K, poly) group
    (Mod.QAM64, 9144, Mod.QPSK, 1800, 0.02),    # tbs1 != tbs2: C=2 with CRC24B, and C=1
])
def test_ue_dl_subframe_mimo_matches_reference(mod1, tbs1, mod2, tbs2, amp):
    rng = np.random.default_rng(tbs1 + tbs2)
    cell = Cell(nof_prb=15, nof_ports=2, id=33)
    grant = DlGrant2(prb=tuple(range(15)), mod1=mod1, tbs1=tbs1, mod2=mod2, tbs2=tbs2, pmi=1)
    tb1, tb2 = (rng.integers(0, 2, n).astype(np.uint8) for n in (tbs1, tbs2))
    rx = through_channel(pdsch_encode2_np(cell, 2, 1, grant, tb1, tb2), cell, 2, rng, amp)

    ref_fn = jax.jit(jax.vmap(ref_ue_dl_subframe_mimo(cell, 2, 1, grant, max_iterations=6)))
    (r_tb1, r_ok1), (r_tb2, r_ok2), r_snr = ref_fn(rx)
    fn = ue_dl_subframe_mimo(from_reference(cell), 2, 1, from_reference(grant), 6, device="cpu")
    (g_tb1, g_ok1), (g_tb2, g_ok2), g_snr = fn(t(rx))
    for got, ref, sent in ((g_tb1, r_tb1, tb1), (g_tb2, r_tb2, tb2)):
        assert got.dtype == torch.uint8 and got.shape == (2, sent.size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got.numpy() == sent).all()
    np.testing.assert_array_equal(g_ok1.numpy(), np.asarray(r_ok1))
    np.testing.assert_array_equal(g_ok2.numpy(), np.asarray(r_ok2))
    assert g_ok1.all() and g_ok2.all()
    np.testing.assert_allclose(g_snr.numpy(), np.asarray(r_snr), atol=1e-4)


def test_ue_dl_subframe_mimo_checks_its_inputs():
    cell = from_reference(Cell(nof_prb=6, nof_ports=2))
    grant = t_pdsch.DlGrant2(prb=tuple(range(6)), mod1=Mod.QPSK, tbs1=328, mod2=Mod.QPSK, tbs2=328)
    fn = ue_dl_subframe_mimo(cell, 2, 1, grant, device="cpu")
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 2, cell.sf_len), dtype=torch.complex64, device="meta"))
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 1, cell.sf_len), dtype=torch.complex64))
