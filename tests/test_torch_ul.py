"""The port's uplink (PUSCH) modules and decodes against the JAX reference on
the CPU at small sizes: the same numpy inputs, made from a seed, go through
the reference function and its counterpart.

Host tables and encoded bits must be equal.  Complex64 products that sum in
another order than XLA (DFT matrices, the smoothing product, the FFT):
relative 2e-5 of the array's largest magnitude.  Decoded TB bits and crc_ok
must be identical, snr_db within 1e-4 dB, and a HARQ softbuffer within 2e-6
relative to its largest LLR.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.chest.chest_ul as r_chest_ul
import srsran_tpu.phy.chest.refsignal_ul as r_rs_ul
import srsran_tpu.phy.chest.ul_rs_data as r_rs_data
import srsran_tpu.phy.dft_precoding as r_dft
import srsran_tpu.phy.phch.pusch as r_pusch
import srsran_tpu.phy.phch.ra as r_ra
import srsran_tpu.phy.ue.ue_ul as r_ue_ul
import srsran_tpu.pipeline_dynamic as r_pd
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.modem import Mod
from srsran_tpu.pipeline import enb_ul_subframe as ref_enb_ul_subframe
import srsran_tpu_torch.phy.chest.chest_ul as t_chest_ul
import srsran_tpu_torch.phy.chest.refsignal_ul as t_rs_ul
import srsran_tpu_torch.phy.chest.ul_rs_data as t_rs_data
import srsran_tpu_torch.phy.dft_precoding as t_dft
import srsran_tpu_torch.phy.phch.pusch as t_pusch
import srsran_tpu_torch.phy.phch.ra as t_ra
import srsran_tpu_torch.phy.ue.ue_ul as t_ue_ul
import srsran_tpu_torch.pipeline_dynamic as t_pd
from srsran_tpu_torch.convert import from_reference, softbuffer_from_reference
from srsran_tpu_torch.pipeline import enb_ul_subframe

torch.set_num_threads(1)

RTOL = 2e-5


def cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


# --- host tables -------------------------------------------------------------------


def test_ul_rs_tables_equal_reference():
    assert t_rs_data.PHI_M12 == r_rs_data.PHI_M12 and t_rs_data.PHI_M24 == r_rs_data.PHI_M24
    for u in (0, 7, 29):
        for m_sc in (12, 24, 36, 72, 300, 1152):
            got, ref = t_rs_ul.base_sequence(u, m_sc), r_rs_ul.base_sequence(u, m_sc)
            assert got.dtype == np.complex64
            np.testing.assert_array_equal(got, ref)
    for n in (36, 100, 1200):
        assert t_rs_ul._largest_prime_below(n) == r_rs_ul._largest_prime_below(n)


@pytest.mark.parametrize("cp", [0, 1])
def test_pusch_dmrs_and_symbols_equal_reference(cp):
    from srsran_tpu.phy.common import CP
    cell = Cell(nof_prb=25, id=41, cp=CP(cp))
    t_cell = from_reference(cell)
    assert t_rs_ul.dmrs_symbol_in_slot(t_cell) == r_rs_ul.dmrs_symbol_in_slot(cell)
    for nprb, cs, slot in ((1, 0, 0), (2, 3, 1), (20, 5, 0)):
        np.testing.assert_array_equal(t_rs_ul.pusch_dmrs(t_cell, nprb, cs, slot),
                                      r_rs_ul.pusch_dmrs(cell, nprb, cs, slot))
    for shortened in (False, True):
        assert t_pusch.pusch_symbols_data(t_cell, shortened) == \
            r_pusch.pusch_symbols_data(cell, shortened)


def test_ul_mcs_tables_equal_reference():
    for mcs in range(29):
        assert int(t_ra.ul_mcs_to_mod(mcs)) == int(r_ra.ul_mcs_to_mod(mcs))
        assert t_ra.ul_mcs_to_itbs(mcs) == r_ra.ul_mcs_to_itbs(mcs)
    with pytest.raises(ValueError):
        t_ra.ul_mcs_to_mod(29)


def test_interleaver_and_cinit_equal_reference():
    for g, qm in ((12 * 12 * 2, 2), (12 * 36 * 4, 4), (12 * 60 * 6, 6)):
        idx = t_pusch._interleaver_indices(g, qm)
        np.testing.assert_array_equal(idx, r_pusch._interleaver_indices(g, qm))
        inv = t_pusch._deinterleaver_indices(g, qm)
        # the reference's receive scatter, as a gather
        v = np.arange(g, dtype=np.float32)
        np.testing.assert_array_equal(np.asarray(jnp.zeros(g).at[idx].set(v)), v[inv])
        pad = t_pd._ul_deint_gather(g, qm, g + 100)
        np.testing.assert_array_equal(np.append(v, np.zeros(101, np.float32))[pad][:g], v[inv])
        assert (pad[g:] == g + 100).all()
    with pytest.raises(ValueError):
        t_pusch._interleaver_indices(100, 4)
    assert t_pusch.pusch_cinit(0x46, 7, 301) == r_pusch.pusch_cinit(0x46, 7, 301)


def test_dft_precoding_equals_reference():
    for n in range(1, 111):
        assert t_dft.valid_nof_prb(n) == r_dft.valid_nof_prb(n)
    assert not t_dft.valid_nof_prb(0)
    rng = np.random.default_rng(0)
    for m in (12, 60, 300):
        for inv in (False, True):
            np.testing.assert_array_equal(t_dft._dft_matrix(m, inv), r_dft._dft_matrix(m, inv))
        x = cplx(rng, 2, 12, m)
        close(t_dft.dft_precode(torch.from_numpy(x)).numpy(), r_dft.dft_precode(jnp.asarray(x)))
        close(t_dft.dft_predecode(torch.from_numpy(x)).numpy(), r_dft.dft_predecode(jnp.asarray(x)))
        back = t_dft.dft_predecode(t_dft.dft_precode(torch.from_numpy(x)))
        close(back.numpy(), x, 1e-5)


# --- transmitter, channel estimate ---------------------------------------------------


def ul_grant(nprb, mcs, start=1, rv=0):
    tbs = r_ra.tbs_lookup(r_ra.ul_mcs_to_itbs(mcs), nprb)
    return r_pusch.UlGrant(prb_start=start, nof_prb=nprb, mod=r_ra.ul_mcs_to_mod(mcs), tbs=tbs,
                           rv=rv, rnti=0x46)


@pytest.mark.parametrize("nprb,mcs", [(2, 4), (12, 14), (20, 22)])
def test_pusch_encode_and_ue_ul_encode_equal_reference(nprb, mcs):
    rng = np.random.default_rng(nprb)
    cell = Cell(nof_prb=25, id=17)
    grant = ul_grant(nprb, mcs, start=3)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    t_cell, t_grant = from_reference(cell), from_reference(grant)
    assert isinstance(t_grant, t_pusch.UlGrant) and t_grant.qm == grant.qm
    close(t_pusch.pusch_encode_np(t_cell, 4, t_grant, tb),
          r_pusch.pusch_encode_np(cell, 4, grant, tb))
    for kw in ({}, {"ta_samples": 5, "cfo": 0.02}):
        got = t_ue_ul.ue_ul_encode(t_cell, 4, pusch=(t_grant, tb), **kw, device="cpu")
        ref = np.asarray(r_ue_ul.ue_ul_encode(cell, 4, pusch=(grant, tb), **kw))
        close(got, ref)
    assert not t_ue_ul.ue_ul_encode(t_cell, 4, device="cpu").any()
    # UCI rides the PUSCH since the control plane was ported, the SRS (with
    # the shortened PUSCH) since the eNB UL chain was
    uci = r_pusch.UciCfg(cqi_bits=(1, 0, 1, 1), ack=(1,))
    close(t_pusch.pusch_encode_np(t_cell, 4, t_grant, tb, uci=from_reference(uci)),
          r_pusch.pusch_encode_np(cell, 4, grant, tb, uci=uci))
    close(t_ue_ul.ue_ul_encode(t_cell, 4, pusch=(t_grant, tb), srs=(0, 4), device="cpu"),
          np.asarray(r_ue_ul.ue_ul_encode(cell, 4, pusch=(grant, tb), srs=(0, 4))))


def test_chest_ul_matches_reference():
    rng = np.random.default_rng(2)
    cell = Cell(nof_prb=25, id=17)
    grant = ul_grant(20, 12, start=2)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    grid = r_pusch.pusch_encode_np(cell, 3, grant, tb)
    rx_grid = np.stack([awgn(rng, (0.8 - 0.3j) * grid, 0.05), awgn(rng, (0.2 + 0.9j) * grid, 0.05)])
    rx_grid = np.stack([rx_grid, 0.5 * rx_grid])  # (B=2, nrx=2, nsymb, nre)
    r_ce, r_noise = jax.vmap(lambda g: r_chest_ul.chest_ul(g, cell, 2, 20))(rx_grid)
    ce, noise = t_chest_ul.chest_ul(torch.from_numpy(rx_grid), from_reference(cell), 2, 20)
    assert ce.shape == (2, 2, 14, 240) and ce.dtype == torch.complex64
    close(ce.numpy(), r_ce)
    close(noise.numpy(), r_noise)
    # the estimate finds the two antennas' gains
    assert abs(complex(ce[0, 0].mean()) - (0.8 - 0.3j)) < 0.02
    np.testing.assert_array_equal(t_chest_ul.time_interp_weights(from_reference(cell))[[0, 3, 10, 13]],
                                  np.array([[1, 0], [1, 0], [0, 1], [0, 1]], np.float32))


# --- enb_ul_subframe as a whole ----------------------------------------------------------


@pytest.mark.parametrize("prb,nprb,start,mcs,amp", [
    (6, 4, 1, 6, 0.2),       # QPSK, one codeblock
    (25, 20, 2, 16, 0.05),   # 16QAM, tbs 6200: two codeblocks, CRC24B
    (25, 24, 1, 24, 0.02),   # 64QAM, the allocation reaches the band edge
])
def test_enb_ul_subframe_matches_reference(prb, nprb, start, mcs, amp):
    rng = np.random.default_rng(prb + mcs)
    cell = Cell(nof_prb=prb, id=301)
    grant = ul_grant(nprb, mcs, start=start)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    tx = np.asarray(r_ue_ul.ue_ul_encode(cell, 2, pusch=(grant, tb)))
    rx = awgn(rng, np.tile(tx[None, None, :], (2, 2, 1)) * np.array([1.0, 0.6j])[None, :, None], amp)

    ref_fn = jax.jit(jax.vmap(ref_enb_ul_subframe(cell, 2, grant, max_iterations=6)))
    ref_tb, ref_ok, ref_snr = (np.asarray(v) for v in ref_fn(rx))
    fn = enb_ul_subframe(from_reference(cell), 2, from_reference(grant), 6, device="cpu")
    got_tb, got_ok, got_snr = fn(torch.from_numpy(rx))
    assert got_tb.shape == (2, grant.tbs) and got_tb.dtype == torch.uint8
    np.testing.assert_array_equal(got_tb.numpy(), ref_tb)
    assert got_ok.dtype == torch.bool
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_allclose(got_snr.numpy(), ref_snr, atol=1e-4)
    assert got_ok.all() and (got_tb.numpy() == tb).all()


def test_enb_ul_subframe_checks_its_inputs():
    cell = from_reference(Cell(nof_prb=6))
    fn = enb_ul_subframe(cell, 2, from_reference(ul_grant(4, 6)), device="cpu")
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 1, cell.sf_len), dtype=torch.complex64, device="meta"))


# --- DynamicEnbUl ----------------------------------------------------------------------


def test_dynamic_ul_stage_b_matches_reference():
    """Stage B alone: the port's LLR vector and noise against the reference's
    jitted stage, for an allocation at the upper band edge of its bucket."""
    rng = np.random.default_rng(5)
    cell = Cell(nof_prb=25, id=17)
    grant = ul_grant(9, 13, start=16)  # PRB 16..24 of 25 in the 16-PRB bucket
    m_max, m_sc, qm = 12 * 16, 12 * 9, grant.qm
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    tx = np.asarray(r_ue_ul.ue_ul_encode(cell, 5, pusch=(grant, tb)))
    rx = awgn(rng, np.stack([tx, 0.7j * tx]), 0.05)
    g = 12 * m_sc * qm
    signs = r_pd.gold_sequence_signs(r_pusch.pusch_cinit(grant.rnti, 5, cell.id), 12 * m_max * qm)

    grid_ri = r_pd._build_stage_a_ul(cell)(jnp.asarray(np.stack([rx.real, rx.imag], -1)))
    r_llr, r_noise = r_pd._build_stage_b_ul(cell, m_max, grant.mod, qm)(
        grid_ri, jnp.int32(grant.prb_start * 12), jnp.int32(m_sc),
        r_pd._ul_dmrs_conj_dev(cell, grant.nof_prb, m_max), r_pd._idft_padded_dev(m_sc, m_max),
        jnp.asarray(signs), r_pd._ul_deint_scatter_dev(g, qm, r_pd.G_MAX))

    t_cell = from_reference(cell)
    grid = t_pd._build_stage_a_ul(t_cell)(torch.from_numpy(rx))
    close(grid.numpy(), np.asarray(grid_ri[..., 0] + 1j * grid_ri[..., 1]).astype(np.complex64))
    llr, noise = t_pd._build_stage_b_ul(t_cell, m_max, t_pd.Mod(int(grant.mod)), qm, "cpu")(
        grid, grant.prb_start * 12, m_sc,
        torch.from_numpy(t_pd._ul_dmrs_conj(t_cell, grant.nof_prb, m_max)),
        torch.from_numpy(t_pd._idft_padded(m_sc, m_max)), torch.from_numpy(signs),
        torch.from_numpy(t_pd._ul_deint_gather(g, qm, t_pd.G_MAX)))
    assert llr.shape == (t_pd.G_MAX,) and llr.dtype == torch.float32
    close(llr.numpy(), r_llr)
    close(noise.numpy(), r_noise)
    assert not llr[g:].any()


def _valid_pusch_l(n):
    return t_dft.valid_nof_prb(n)


def test_dynamic_ul_grant_mix_matches_reference():
    """A seeded PUSCH grant mix (MCS x valid allocations x subframes) through
    both `DynamicEnbUl`s: same TB bits, crc_ok, iteration counts and stage
    keys, every TB the sent one."""
    rng = np.random.default_rng(4)
    cell = Cell(nof_prb=25, id=17)
    ref_enb = r_pd.DynamicEnbUl(cell)
    enb = t_pd.DynamicEnbUl(from_reference(cell), device="cpu")
    assert enb.PRB_BUCKETS == ref_enb.PRB_BUCKETS
    ls = [l for l in range(1, 24) if _valid_pusch_l(l)]
    built_at = []
    for i in range(10):
        sf_idx, mcs = int(rng.integers(0, 10)), int(rng.integers(0, 24))
        l = int(rng.choice(ls))
        grant = ul_grant(l, mcs, start=int(rng.integers(1, 25 - l)))
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        tx = np.asarray(r_ue_ul.ue_ul_encode(cell, sf_idx, pusch=(grant, tb)))
        rx = awgn(rng, tx[None], 0.04)
        r_tb, r_ok, r_soft, r_it = ref_enb.decode(rx, sf_idx, grant)
        g_tb, g_ok, g_soft, g_it = enb.decode(rx, sf_idx, from_reference(grant))
        assert g_ok and r_ok, (i, sf_idx, mcs, l)
        assert g_it == r_it
        np.testing.assert_array_equal(g_tb, np.asarray(r_tb))
        np.testing.assert_array_equal(g_tb, tb)
        close(g_soft.numpy(), np.asarray(r_soft), 2e-6)
        built_at.append(enb.total_compiles)
    assert {k: enb.stats[k] for k in enb.stats} == ref_enb.stats
    assert enb.stats["compiles_a"] == 1 and enb.stats["compiles_b"] <= 6
    assert enb.total_compiles == ref_enb.total_compiles == built_at[-1]


def test_dynamic_ul_harq_combining_matches_reference():
    """UL HARQ: rv 0 fails alone at low SNR, the rv 2 retransmission combines
    with the softbuffer — the port's own and the reference's, converted."""
    rng = np.random.default_rng(6)
    cell = Cell(nof_prb=25, id=3)
    ref_enb = r_pd.DynamicEnbUl(cell, max_iterations=4)
    enb = t_pd.DynamicEnbUl(from_reference(cell), max_iterations=4, device="cpu")
    g0 = ul_grant(20, 19)
    g2 = dataclasses.replace(g0, rv=2)
    tb = rng.integers(0, 2, g0.tbs).astype(np.uint8)
    rx0 = awgn(rng, np.asarray(r_ue_ul.ue_ul_encode(cell, 2, pusch=(g0, tb)))[None], 0.33)
    rx2 = awgn(rng, np.asarray(r_ue_ul.ue_ul_encode(cell, 3, pusch=(g2, tb)))[None], 0.33)

    _, r_ok0, r_soft, _ = ref_enb.decode(rx0, 2, g0)
    _, g_ok0, g_soft, _ = enb.decode(rx0, 2, from_reference(g0))
    assert not g_ok0 and not r_ok0
    close(g_soft.numpy(), np.asarray(r_soft), 2e-6)
    r_tb, r_ok2, r_soft2, r_it = ref_enb.decode(rx2, 3, g2, softbuffer=r_soft)
    for soft in (g_soft, softbuffer_from_reference(r_soft, "cpu")):
        g_tb, g_ok2, g_soft2, g_it = enb.decode(rx2, 3, from_reference(g2), softbuffer=soft)
        assert g_ok2 and r_ok2 and g_it == r_it
        np.testing.assert_array_equal(g_tb, tb)
        close(g_soft2.numpy(), np.asarray(r_soft2), 2e-6)
    with pytest.raises(ValueError):
        enb.decode(rx2, 3, from_reference(g2), softbuffer=g_soft.to("meta"))
