"""The port's dynamic-grant decode against the JAX reference, module by
module and as a whole (`DynamicUeDl`), on the CPU at small sizes.

The same numpy inputs, made from a seed, go through the reference function
and its counterpart.  On CPU tensors the port runs the MAP kernel's plain
version (`map_pass_plain(k_vec=)`); the CUDA kernel's dynamic-K mode is
held against that plain version on the card by `chip_smoke.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.fec.rate_match_dev as r_rmd
import srsran_tpu.phy.fec.turbo_dyn as r_dyn
import srsran_tpu.pipeline_dynamic as r_pd
from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.common import LTE_CRC24A, LTE_CRC24B, Cell
from srsran_tpu.phy.crc import crc_attach_np
from srsran_tpu.phy.fec.cbsegm import F1, F2, cb_size_index, qpp_interleaver_np
from srsran_tpu.phy.fec.turbo import turbo_encode_np
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
import srsran_tpu_torch.phy.fec.rate_match_dev as t_rmd
import srsran_tpu_torch.phy.fec.turbo_dyn as t_dyn
import srsran_tpu_torch.pipeline_dynamic as t_pd
from srsran_tpu_torch.convert import from_reference, softbuffer_from_reference
from srsran_tpu_torch.phy.crc import crc_table
from srsran_tpu_torch.phy.fec import turbo, turbo_cuda
from srsran_tpu_torch.phy.fec.rate_match import turbo_rate_match_rx
from srsran_tpu_torch.pipeline import (
    enb_dl_subframe_encode,
    enb_ul_subframe,
    ue_dl_subframe,
    ue_dl_subframe_mimo,
)

torch.set_num_threads(1)


def i64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


# --- turbo_decode_dyn ---------------------------------------------------------


def dyn_batch(k_max, ks, b, amp, sigma, seed):
    """A (B, 3, K_max+4) LLR batch of encoded random messages of the sizes
    `ks` (slots beyond them unused), with its permutations and messages."""
    rng = np.random.default_rng(seed)
    d = np.zeros((b, 3, k_max + 4), np.float32)
    per = np.tile(np.arange(k_max, dtype=np.int32), (b, 1))
    inv = per.copy()
    k_vec = np.full(b, k_max, np.int32)
    valid = np.zeros(b, bool)
    msgs = []
    for i, k in enumerate(ks):
        cb = crc_attach_np(rng.integers(0, 2, k - 24).astype(np.uint8), LTE_CRC24A)
        msgs.append(cb)
        enc = turbo_encode_np(cb).astype(np.float32)
        d[i, :, : k + 4] = (2 * enc - 1) * amp + rng.normal(0, sigma, enc.shape)
        p = qpp_interleaver_np(k)
        per[i, :k] = p
        inv[i, p] = np.arange(k, dtype=p.dtype)
        k_vec[i], valid[i] = k, True
    return d, k_vec, per, inv, valid, msgs


@pytest.mark.parametrize("k_max,ks,b,amp,iters", [
    # the sampled sizes of the reference's own test: every message decodes
    (2112, [40, 64, 136, 512, 528, 1024, 1056, 2048, 2112], 16, 3.0, 6),
    # lower SNR: several iterations, rows converge at different ones
    (2112, [40, 512, 1056, 2048, 2112, 192], 8, 0.9, 6),
    (768, [768, 40, 384, 704], 4, 0.9, 5),
])
def test_turbo_decode_dyn_matches_reference(k_max, ks, b, amp, iters):
    d, k_vec, per, inv, valid, msgs = dyn_batch(k_max, ks, b, amp, 1.0, seed=k_max + b)
    crc_ab = r_dyn.crc_table_ab(k_max)
    np.testing.assert_array_equal(t_dyn.crc_table_ab(k_max), crc_ab)
    is_b = np.zeros(b, bool)
    r_bits, r_post, r_it = r_dyn.turbo_decode_dyn(
        jnp.asarray(d), jnp.asarray(k_vec), jnp.asarray(per), jnp.asarray(inv),
        jnp.asarray(valid), k_max, iters, crc_table=jnp.asarray(crc_ab),
        crc_is_b=jnp.asarray(is_b), backend="scan")
    bits, post, n_it = t_dyn.turbo_decode_dyn(
        torch.from_numpy(d), torch.from_numpy(k_vec), i64(per), i64(inv),
        torch.from_numpy(valid), k_max, iters, crc_table=torch.from_numpy(crc_ab),
        crc_is_b=torch.from_numpy(is_b))
    assert bits.dtype == torch.uint8 and n_it.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(n_it.numpy(), np.asarray(r_it))
    below_k = np.arange(k_max)[None, :] < k_vec[:, None]
    np.testing.assert_allclose(post.numpy()[below_k], np.asarray(r_post)[below_k], atol=2e-3)
    decoded = [bool((bits.numpy()[i, :k] == msgs[i]).all()) for i, k in enumerate(ks)]
    assert all(decoded) if amp >= 3.0 else any(decoded)
    assert not bits.numpy()[~below_k].any()  # zero beyond K
    if amp < 3.0:
        assert len(set(n_it.numpy()[: len(ks)].tolist())) > 1


@pytest.mark.parametrize("k", [40, 5632, 6144])
@pytest.mark.parametrize("case", ["converges", "capped"])
def test_turbo_decode_dyn_is_turbo_decode_at_k_max(k, case):
    """Every row valid at K = K_max: the dynamic loop gives the static
    loop's bits and posteriors exactly, and its iteration count.  In
    "capped" the last row is noise, which never passes its CRC."""
    poly = LTE_CRC24A if k == 40 else LTE_CRC24B  # a TB's one block, or a block of several
    b, iters = 4, (6 if case == "converges" else 2)
    rng = np.random.default_rng(k)
    d = np.zeros((b, 3, k + 4), np.float32)
    for i in range(b):
        enc = turbo_encode_np(crc_attach_np(rng.integers(0, 2, k - 24).astype(np.uint8), poly))
        amp = 0.0 if case == "capped" and i == b - 1 else 2.0
        d[i] = (2 * enc.astype(np.float32) - 1) * amp + rng.normal(0, 1, enc.shape)
    d_llr = torch.from_numpy(d)
    per = i64(np.tile(qpp_interleaver_np(k), (b, 1)))
    inv = torch.argsort(per, dim=1)
    crc_ab = torch.from_numpy(t_dyn.crc_table_ab(k))
    bits, post, it_vec = t_dyn.turbo_decode_dyn(
        d_llr, torch.full((b,), k), per, inv, torch.ones(b, dtype=torch.bool), k, iters,
        crc_table=crc_ab, crc_is_b=torch.full((b,), poly == LTE_CRC24B))
    s_bits, s_post, n_it = turbo.turbo_decode(d_llr, k, iters, crc_table=crc_table(poly, k, "cpu"))
    assert torch.equal(bits, s_bits) and torch.equal(post, s_post)
    assert int(it_vec.max()) == n_it
    assert (n_it < iters) if case == "converges" else (n_it == iters and it_vec[-1] == iters)


# --- rate_match_dev -------------------------------------------------------------


# (k3, f3, cls, e per codeblock, rep bucket): a TB with filler, one with K- and
# K+ codeblocks and an unused slot, one that repeats more than 8 times
RM_CASES = {
    "filler": ((512, 40, 40), (16, 0, 0), (0,), (1300,), 8),
    "k_minus_plus": ((504, 504, 512), (8, 0, 0), (0, 1, 2, 2, 0), (900, 904, 2000, 1700, 0), 8),
    "repeats": ((40, 40, 40), (8, 0, 0), (0, 0), (3000, 0), 64),
}


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("case", list(RM_CASES))
def test_codeword_d_fill_grouped_dev(case, rv):
    k3, f3, cls, es, rep = RM_CASES[case]
    k_max = 768
    ncb = t_rmd.ncb_max(k_max)
    assert ncb == r_rmd.ncb_max(k_max)
    rng = np.random.default_rng(rv)
    g = sum(es)
    llr = np.zeros(6000 + ncb, np.float32)
    llr[:g] = rng.standard_normal(g)
    start = (np.cumsum(es) - np.asarray(es)).astype(np.int32)
    ref = np.asarray(r_rmd.codeword_d_fill_grouped_dev(
        jnp.asarray(llr), jnp.asarray(start), jnp.asarray(es, jnp.int32),
        jnp.asarray(cls, jnp.int32), jnp.asarray(k3, jnp.int32), jnp.asarray(f3, jnp.int32),
        jnp.int32(rv), k_max, rep))
    args = (torch.from_numpy(llr), i64(start), i64(es), i64(cls), i64(k3), i64(f3),
            torch.tensor(rv), k_max, rep)
    got = t_rmd.codeword_d_fill_grouped_dev(*args).numpy()
    assert got.shape == (len(es), 3, k_max + 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # stopping at the folds the codeword needs changes nothing
    folds = max(-(-e // (3 * (k3[c] + 4) - 2 * f3[c])) for e, c in zip(es, cls))
    assert folds > 8 or rep == 8
    np.testing.assert_array_equal(
        t_rmd.codeword_d_fill_grouped_dev(*args, folds=folds).numpy(), got)
    # and the static path's de-rate-match of each codeblock gives the same
    for c, e in enumerate(es):
        if e:
            k, f = k3[cls[c]], f3[cls[c]]
            own = turbo_rate_match_rx(torch.from_numpy(llr[start[c] : start[c] + e]), k, rv, f)
            np.testing.assert_allclose(got[c, :, : k + 4], own.numpy(), atol=1e-5)
            assert not got[c, :, k + 4 :].any()
        else:
            assert not got[c].any()


def test_qpp_dev_all_sampled_sizes():
    ks = [40, 48, 512, 528, 1056, 2112, 6080, 6144, 0]
    ki = [cb_size_index(max(k, 40)) for k in ks]
    f1, f2 = [F1[i] for i in ki], [F2[i] for i in ki]
    per, inv = t_rmd.qpp_dev(i64(ks), i64(f1), i64(f2), 6144)
    r_per, r_inv = r_rmd.qpp_dev(jnp.asarray(ks, jnp.int32), jnp.asarray(f1, jnp.int32),
                                 jnp.asarray(f2, jnp.int32), 6144)
    np.testing.assert_array_equal(per.numpy(), np.asarray(r_per))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(r_inv))
    ident = np.arange(6144)
    for row, k in enumerate(ks):
        if k:
            np.testing.assert_array_equal(per[row, :k].numpy(), qpp_interleaver_np(k))
        np.testing.assert_array_equal(per[row, k:].numpy(), ident[k:])
        np.testing.assert_array_equal(per[row][inv[row]].numpy(), ident)


# --- host-side layout ---------------------------------------------------------


def test_buckets_and_tb_params_equal_reference():
    for name in ("K_BUCKETS", "B_BUCKETS", "RE_BUCKETS", "G_MAX", "REP_BUCKETS"):
        assert getattr(t_pd, name) == getattr(r_pd, name), name
    for tbs, g, qm in ((152, 1512, 2), (4008, 7200, 2), (18336, 21600, 6), (75376, 90000, 6),
                       (9528, 21000, 4), (16, 28800, 2), (6200, 12000, 4), (328, 1200, 2)):
        kb, bb, rb, folds, tbs_max, tmpl = t_pd._tb_params_v2(tbs, g, qm)
        r_kb, r_bb, r_rb, r_tbs_max, r_tmpl = r_pd._tb_params_v2(tbs, g, qm)
        assert (kb, bb, rb, tbs_max) == (r_kb, r_bb, r_rb, r_tbs_max)
        assert 1 <= folds <= rb
        np.testing.assert_array_equal(tmpl, r_tmpl)
    # two layers: the codeblocks' shares are multiples of 2*Qm
    for tbs, g, qm in ((6200, 2 * 3000 * 4, 4), (18336, 2 * 3600 * 6, 6)):
        got, ref = t_pd._tb_params_v2(tbs, g, qm, 2), r_pd._tb_params_v2(tbs, g, qm, 2)
        assert got[:3] + (got[4],) == ref[:4]
        np.testing.assert_array_equal(got[-1], ref[-1])
        assert not np.array_equal(got[-1], t_pd._tb_params_v2(tbs + 8, g, qm, 2)[-1])
    cell = Cell(nof_prb=25, nof_ports=1, id=5)
    for prb in (tuple(range(25)), (0, 1, 7, 20)):
        pad, n_re, bucket = t_pd._padded_re_indices(from_reference(cell), 0, 2, prb)
        r_pad, r_n_re, r_bucket = r_pd._padded_re_indices(cell, 0, 2, prb)
        assert (n_re, bucket) == (r_n_re, r_bucket)
        np.testing.assert_array_equal(pad, r_pad)


# --- DynamicUeDl as a whole ---------------------------------------------------


def render(cell, sf_idx, grant, tb, rng, amp):
    """One noisy subframe (1, sf_len) complex64 from the reference's host
    transmitter (CFI 1), as `tests/test_dynamic_pipeline.py` makes it."""
    grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
    put_crs_np(grid, cell, sf_idx)
    rx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid)).copy()
    rx += amp * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


@pytest.fixture(scope="module")
def both():
    """(reference cell, reference facade, the port's facade) at 25 PRB."""
    cell = Cell(nof_prb=25, nof_ports=1, id=5)
    return (cell, r_pd.DynamicUeDl(cell, cfi=1, max_iterations=6),
            t_pd.DynamicUeDl(from_reference(cell), cfi=1, max_iterations=6, device="cpu"))


# (mcs, PRB set, noise amplitude, turbo iterations both packages take):
# QPSK / 16QAM / 64QAM, K buckets 768 / 2112 / 6144, one and several
# codeblocks, a non-contiguous set, and noise levels that take several
# iterations or defeat the decoder
GRANTS = {
    "qpsk_6prb": (0, tuple(range(3, 9)), 0.05, 1),
    "qpsk_25prb_noisy": (9, tuple(range(25)), 0.5, 4),
    "qam16_25prb": (16, tuple(range(25)), 0.22, 2),
    "qam64_3cb": (28, tuple(range(25)), 0.08, 4),
    "qam16_noncontiguous": (12, tuple(range(4)) + tuple(range(10, 17)) + tuple(range(20, 25)),
                            0.17, 1),
    "qam64_fails": (24, tuple(range(25)), 0.2, 6),
}


@pytest.mark.parametrize("name", list(GRANTS))
def test_dynamic_ue_dl_matches_reference(both, name):
    cell, r_ue, ue = both
    mcs, prb, amp, iters = GRANTS[name]
    sf_idx = 2
    grant = DlGrant(prb=prb, mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, len(prb)), rnti=0x46)
    rng = np.random.default_rng(mcs)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    rx = render(cell, sf_idx, grant, tb, rng, amp)
    r_tb, r_ok, r_soft, r_it = r_ue.decode(rx, sf_idx, grant)
    launches = turbo_cuda.LAUNCHES
    p_tb, p_ok, p_soft, p_it = ue.decode(rx, sf_idx, from_reference(grant))
    assert turbo_cuda.LAUNCHES == launches  # CPU tensors never reach the kernel
    assert isinstance(p_ok, bool) and isinstance(p_it, int)
    assert p_tb.dtype == np.uint8 and p_tb.shape == (grant.tbs,)
    assert (p_ok, p_it) == (r_ok, r_it) and p_it == iters
    assert p_soft.dtype == torch.float32 and tuple(p_soft.shape) == np.asarray(r_soft).shape
    np.testing.assert_allclose(p_soft.numpy(), np.asarray(r_soft), atol=1e-3)
    if name == "qam64_fails":
        # a decode that does not converge amplifies rounding differences
        # from one iteration to the next: no bits to hold
        assert not p_ok
    else:
        assert p_ok
        np.testing.assert_array_equal(p_tb, r_tb)
        np.testing.assert_array_equal(p_tb, tb)
    for key in ("compiles_a", "compiles_b", "compiles_c", "ttis", "crc_ok"):
        assert ue.stats[key] == r_ue.stats[key], key
    assert ue.total_compiles == r_ue.total_compiles


H_2X2 = np.array([[1.0 + 0.1j, 0.25 - 0.55j], [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)


# (tx scheme, layers, mcs, PRB set, subframe, noise amplitude)
MIMO_GRANTS = {
    "diversity_qpsk": ("diversity", 1, 5, tuple(range(2, 12)), 1, 0.1),
    "diversity_qam64": ("diversity", 1, 20, tuple(range(15)), 5, 0.03),
    "spatialmux_1layer": ("spatialmux", 1, 12, tuple(range(15)), 2, 0.04),
    "spatialmux_2layers": ("spatialmux", 2, 14, tuple(range(3, 15)), 2, 0.02),
}


@pytest.mark.parametrize("name", list(MIMO_GRANTS))
def test_dynamic_ue_dl_two_port_grants_match_reference(name):
    """Transmit-diversity and spatial-multiplexing grants through both
    `DynamicUeDl`s behind a 2x2 channel: same TB, crc_ok, iterations, stage
    keys, softbuffer within 1e-3."""
    tx_scheme, nof_layers, mcs, prb, sf_idx, amp = MIMO_GRANTS[name]
    cell = Cell(nof_prb=15, nof_ports=2, id=5)
    r_ue = r_pd.DynamicUeDl(cell, cfi=1, max_iterations=6)
    ue = t_pd.DynamicUeDl(from_reference(cell), cfi=1, max_iterations=6, device="cpu")
    grant = DlGrant(prb=prb, mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, len(prb) * nof_layers),
                    rnti=0x46, tx_scheme=tx_scheme, nof_layers=nof_layers, pmi=1)
    rng = np.random.default_rng(mcs)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
    put_crs_np(grid, cell, sf_idx)
    tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))
    rx = np.einsum("rp,pt->rt", H_2X2, tx)
    rx = (rx + amp * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
          ).astype(np.complex64)
    r_tb, r_ok, r_soft, r_it = r_ue.decode(rx, sf_idx, grant)
    p_tb, p_ok, p_soft, p_it = ue.decode(rx, sf_idx, from_reference(grant))
    assert (p_ok, p_it) == (r_ok, r_it) and p_ok
    np.testing.assert_array_equal(p_tb, r_tb)
    np.testing.assert_array_equal(p_tb, tb)
    np.testing.assert_allclose(p_soft.numpy(), np.asarray(r_soft), atol=1e-3)
    assert ue.stats == r_ue.stats


@pytest.mark.parametrize("first", ["reference", "port"])
def test_dynamic_harq_combining_across_packages(first):
    """rv 0 alone fails at low SNR; rv 2 combines in the softbuffer and
    decodes — also when the softbuffer was filled by the other package."""
    rng = np.random.default_rng(3)
    cell = Cell(nof_prb=15, nof_ports=1, id=3)
    r_ue = r_pd.DynamicUeDl(cell, cfi=1, max_iterations=4)
    ue = t_pd.DynamicUeDl(from_reference(cell), cfi=1, max_iterations=4, device="cpu")
    tbs = dl_tbs(16, 15)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    g0 = DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(16), tbs=tbs, rv=0)
    g2 = dataclasses.replace(g0, rv=2)
    rx0 = render(cell, 1, g0, tb, rng, 0.42)
    rx2 = render(cell, 2, g2, tb, rng, 0.42)

    _, r_ok0, r_soft, r_it0 = r_ue.decode(rx0, 1, g0)
    _, p_ok0, p_soft, p_it0 = ue.decode(rx0, 1, from_reference(g0))
    assert (p_ok0, p_it0) == (r_ok0, r_it0) == (False, 4)
    np.testing.assert_allclose(p_soft.numpy(), np.asarray(r_soft), atol=1e-3)
    if first == "reference":  # the reference's softbuffer goes on in the port
        tb_hat, ok2, soft2, _ = ue.decode(rx2, 2, from_reference(g2),
                                          softbuffer_from_reference(r_soft, "cpu"))
        assert isinstance(soft2, torch.Tensor)
    else:  # and the port's in the reference
        tb_hat, ok2, _, _ = r_ue.decode(rx2, 2, g2, jnp.asarray(p_soft.numpy()))
    assert ok2
    np.testing.assert_array_equal(tb_hat, tb)
    # without the first transmission rv 2 alone fails too
    assert not ue.decode(rx2, 2, from_reference(g2))[1]


@pytest.mark.parametrize("mcs,sf_idx", [(4, 0), (13, 4), (22, 9)])
def test_dynamic_vs_static_parity(mcs, sf_idx):
    """The port's dynamic path gives the TB of the port's static path."""
    rng = np.random.default_rng(11 + mcs)
    cell = Cell(nof_prb=25, nof_ports=1, id=5)
    grant = DlGrant(prb=tuple(range(25)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, 25))
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    rx = render(cell, sf_idx, grant, tb, rng, 0.05)
    p_cell, p_grant = from_reference(cell), from_reference(grant)
    tb_dyn, ok_dyn, _, _ = t_pd.DynamicUeDl(p_cell, cfi=1, device="cpu").decode(rx, sf_idx, p_grant)
    tb_st, ok_st, _ = ue_dl_subframe(p_cell, sf_idx, 1, p_grant, device="cpu")(
        torch.from_numpy(rx)[None])
    assert ok_dyn and bool(ok_st[0])
    np.testing.assert_array_equal(tb_dyn, tb_st[0].numpy())
    np.testing.assert_array_equal(tb_dyn, tb)


def test_entry_points_need_a_card_unless_told_otherwise():
    """With no device given the entry points take the card; this machine has
    none, so they raise rather than run on the CPU."""
    assert not torch.cuda.is_available()
    cell = from_reference(Cell(nof_prb=6, nof_ports=1, id=1))
    grant = from_reference(DlGrant(prb=(0, 1), mod=dl_mcs_to_mod(2), tbs=dl_tbs(2, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pd.DynamicUeDl(cell)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ue_dl_subframe(cell, 1, 1, grant)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pd.DynamicEnbUl(cell)
    for build in (ue_dl_subframe_mimo, enb_dl_subframe_encode):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cell, 1, 1, grant)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enb_ul_subframe(cell, 1, grant)
    ue = t_pd.DynamicUeDl(cell, device="cpu")
    with pytest.raises(NotImplementedError):
        ue.decode(np.zeros((1, cell.sf_len), np.complex64), 1,
                  dataclasses.replace(grant, tx_scheme="cdd"))
    with pytest.raises(ValueError, match="softbuffer"):
        ue.decode(np.zeros((1, cell.sf_len), np.complex64), 1, grant,
                  softbuffer=torch.zeros((1, 3, 772), device="meta"))
