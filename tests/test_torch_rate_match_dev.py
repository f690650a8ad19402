"""The port's grid-form rate-match helpers and `turbo_decode_dyn(perm_groups=)`
against the JAX reference on the CPU.

The cases of `tests/test_rate_match_dev.py` run on the port beside the
reference at the same inputs: circular-buffer positions, scatter targets,
QPP tables and reassembly indices must be identical; `codeword_d_fill_dev`
is held to the host scatter and to the reference within 1e-5 (the reference
test's own bar).  `perm_groups` decodes a W = 2, B_CB = 3 window of mixed
K_i at K_max 512 against the reference's: hard bits and iteration counts
identical, posteriors within 2e-3 below each K_i (the dynamic-K bar of
`tests/test_torch_dynamic.py`), and bit for bit the port's per-row form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.fec.rate_match_dev as r_rmd
import srsran_tpu.phy.fec.turbo_dyn as r_dyn
from srsran_tpu.phy.common import LTE_CRC24A
from srsran_tpu.phy.crc import crc_attach_np
from srsran_tpu.phy.fec.cbsegm import F1, F2, CB_SIZES, cb_size_index, cbsegm, qpp_interleaver_np
from srsran_tpu.phy.fec.rate_match import turbo_rm_indices
from srsran_tpu.phy.fec.turbo import turbo_encode_np
from srsran_tpu.phy.phch.sch import _e_split
import srsran_tpu_torch.phy.fec.rate_match_dev as t_rmd
import srsran_tpu_torch.phy.fec.turbo_dyn as t_dyn

torch.set_num_threads(1)

K_MAX = 6144


def i64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def _host_positions(k, f, rv):
    """Every transmitted position of one buffer sweep from the host path,
    in the k_max-padded flat layout."""
    idx = turbo_rm_indices(k, 3 * (k + 4) - 2 * f, rv, f)
    stream, pos = idx // (k + 4), idx % (k + 4)
    return stream * (K_MAX + 4) + pos


def test_positions_match_host_all_sizes():
    rng = np.random.default_rng(0)
    ks = [40, 48, 512, 6144] + [int(k) for k in rng.choice(CB_SIZES, 12)]
    for rv in (0, 1, 2, 3):
        fs = [28 if (k, rv) == (512, 1) else 0 for k in ks]
        # the port batched over the sizes, the reference one size a call
        pos, n_valid = t_rmd.turbo_rm_positions_dev(i64(ks), i64(fs), rv, K_MAX)
        assert pos.dtype == n_valid.dtype == torch.int64
        for i, (k, f) in enumerate(zip(ks, fs)):
            r_pos, r_n = r_rmd.turbo_rm_positions_dev(jnp.int32(k), jnp.int32(f), jnp.int32(rv), K_MAX)
            assert int(n_valid[i]) == int(r_n) == 3 * (k + 4) - 2 * f
            np.testing.assert_array_equal(pos[i].numpy(), np.asarray(r_pos), err_msg=f"k={k} rv={rv}")
            np.testing.assert_array_equal(pos[i, : int(r_n)].numpy(), _host_positions(k, f, rv))
            assert bool((pos[i, int(r_n):] == 3 * (K_MAX + 4)).all())
    # one codeblock: 0-d in, 0-d out
    pos1, n1 = t_rmd.turbo_rm_positions_dev(torch.tensor(512), torch.tensor(28), torch.tensor(1), K_MAX)
    assert pos1.shape == (t_rmd.ncb_max(K_MAX),) and n1.shape == ()
    np.testing.assert_array_equal(pos1[: int(n1)].numpy(), _host_positions(512, 28, 1))


def _segmented(tbs, bsz, g, qm):
    segm = cbsegm(tbs)
    es = _e_split(g, segm.C, qm, 1)
    cb_k, cb_e, cb_f = (np.zeros(bsz, np.int32) for _ in range(3))
    valid = np.zeros(bsz, bool)
    for i, k in enumerate(segm.cb_sizes):
        cb_k[i], cb_e[i], cb_f[i], valid[i] = k, es[i], segm.F if i == 0 else 0, True
    return segm, es, cb_k, cb_e, cb_f, valid


@pytest.mark.parametrize("rv", [0, 2])
def test_codeword_scatter_matches_host_segmented(rv):
    """A codeword of 4 codeblocks (filler, uneven e split) and a padded slot
    row: the targets equal the reference's and the per-codeblock host
    indices."""
    tbs, g_max, qm, g = 20000, 98304, 6, 61440
    segm, es, cb_k, cb_e, cb_f, valid = _segmented(tbs, 8, g, qm)
    tgt = t_rmd.codeword_scatter_dev(i64(cb_k), i64(cb_e), i64(cb_f), torch.from_numpy(valid), rv,
                                     K_MAX, g_max)
    ref = np.asarray(r_rmd.codeword_scatter_dev(jnp.asarray(cb_k), jnp.asarray(cb_e), jnp.asarray(cb_f),
                                                jnp.asarray(valid), jnp.int32(rv), K_MAX, g_max))
    assert tgt.dtype == torch.int64 and tgt.shape == (g_max,)
    np.testing.assert_array_equal(tgt.numpy(), ref)
    dflat = 3 * (K_MAX + 4)
    off = 0
    for i, k in enumerate(segm.cb_sizes):
        idx = turbo_rm_indices(k, es[i], rv, int(cb_f[i]))
        stream, pos = idx // (k + 4), idx % (k + 4)
        np.testing.assert_array_equal(tgt[off : off + es[i]].numpy(),
                                      i * dflat + stream * (K_MAX + 4) + pos, err_msg=f"cb {i}")
        off += es[i]
    assert bool((tgt[off:] == 8 * dflat).all())


D_FILL_CASES = [
    # (codeblock sizes, fillers, e): one codeblock repeated 7.5 times, filler,
    # segmented without and with filler
    ([40], [0], [1000]),
    ([512], [28], [700]),
    ([6144, 6144], [0, 0], [8378, 8380]),
    ([2752, 2752], [12, 0], [4000, 4100]),
]


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
def test_d_fill_gather_matches_scatter(rv):
    """`codeword_d_fill_dev` accumulates what the host scatter indices give
    (repetition folds, filler, segmentation, every rv), and what the
    reference's gives, within 1e-5."""
    rng = np.random.default_rng(2 + rv)
    NCB = t_rmd.ncb_max(K_MAX)
    dflat = 3 * (K_MAX + 4)
    for cb_sizes, fs, es in D_FILL_CASES:
        llr = rng.standard_normal(sum(es)).astype(np.float32)
        llr_pad = np.concatenate([llr, np.zeros(NCB, np.float32)])
        off = 0
        for k, f, e in zip(cb_sizes, fs, es):
            fill = t_rmd.codeword_d_fill_dev(torch.from_numpy(llr_pad), off, torch.tensor(e), k, f, rv,
                                             K_MAX, 8)
            assert fill.shape == (3, K_MAX + 4)
            ref = np.asarray(r_rmd.codeword_d_fill_dev(
                jnp.asarray(llr_pad), jnp.int32(off), jnp.int32(e), jnp.int32(k), jnp.int32(f),
                jnp.int32(rv), K_MAX, 8))
            idx = turbo_rm_indices(k, e, rv, f)
            stream, pos = idx // (k + 4), idx % (k + 4)
            expect = np.zeros(dflat, np.float32)
            np.add.at(expect, stream * (K_MAX + 4) + pos, llr[off : off + e])
            tag = f"k={k} f={f} e={e} rv={rv}"
            np.testing.assert_allclose(fill.numpy().reshape(-1), expect, atol=1e-5, err_msg=tag)
            np.testing.assert_allclose(fill.numpy(), ref, atol=1e-5, err_msg=tag)
            off += e


def test_d_fill_raises_past_the_fold_bound():
    """The folds a codeblock needs are checked against `rep`, where the
    reference leaves the check to its callers."""
    NCB = t_rmd.ncb_max(K_MAX)
    llr_pad = torch.zeros(1000 + NCB)
    t_rmd.codeword_d_fill_dev(llr_pad, 0, 1000, 40, 0, 0, K_MAX, 8)  # 1000 / 132: 8 folds
    with pytest.raises(ValueError, match="repetition folds"):
        t_rmd.codeword_d_fill_dev(llr_pad, 0, 1000, 40, 0, 0, K_MAX, 7)


def test_qpp_dev_matches_host():
    ks = [40, 512, 4736, 6144]
    f1 = np.array([F1[cb_size_index(k)] for k in ks], np.int32)
    f2 = np.array([F2[cb_size_index(k)] for k in ks], np.int32)
    per, inv = t_rmd.qpp_dev(i64(ks), i64(f1), i64(f2), K_MAX)
    r_per, r_inv = r_rmd.qpp_dev(jnp.asarray(np.array(ks, np.int32)), jnp.asarray(f1), jnp.asarray(f2),
                                 K_MAX)
    np.testing.assert_array_equal(per.numpy(), np.asarray(r_per))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(r_inv))
    for b, k in enumerate(ks):
        np.testing.assert_array_equal(per[b, :k].numpy(), qpp_interleaver_np(k), err_msg=f"k={k}")
        np.testing.assert_array_equal(per[b, k:].numpy(), np.arange(k, K_MAX))
        np.testing.assert_array_equal(inv[b, per[b]].numpy(), np.arange(K_MAX))


@pytest.mark.parametrize("tbs", [20000, 2216, 75376])
def test_tb_reassembly_gather(tbs):
    """Gather indices of a TB of 4, 1 and 13 codeblocks (the largest at
    100 PRB) in an 8- or 13-slot row: the reference's, and the host
    concatenation."""
    segm = cbsegm(tbs)
    bsz, tbs_max = max(8, segm.C), 24576 if tbs < 24576 else 75376
    _, _, cb_k, _, cb_f, valid = _segmented(tbs, bsz, 3 * tbs, 2)
    crc_is_b = valid & (segm.C > 1)
    tb_idx, crc_idx = t_rmd.tb_reassembly_gather_dev(i64(cb_k), i64(cb_f), torch.from_numpy(valid),
                                                     torch.from_numpy(crc_is_b), tbs, K_MAX, tbs_max)
    r_tb, r_crc = r_rmd.tb_reassembly_gather_dev(
        jnp.asarray(cb_k), jnp.asarray(cb_f), jnp.asarray(valid), jnp.asarray(crc_is_b), jnp.int32(tbs),
        K_MAX, tbs_max)
    assert tb_idx.dtype == crc_idx.dtype == torch.int64
    np.testing.assert_array_equal(tb_idx.numpy(), np.asarray(r_tb))
    np.testing.assert_array_equal(crc_idx.numpy(), np.asarray(r_crc))
    parts = []
    for i, k in enumerate(segm.cb_sizes):
        f = segm.F if i == 0 else 0
        parts.append(i * K_MAX + np.arange(f, k - (24 if segm.C > 1 else 0)))
    flat = np.concatenate(parts)
    assert len(flat) == tbs + 24
    np.testing.assert_array_equal(tb_idx[: tbs_max - tbs].numpy(), bsz * K_MAX)
    np.testing.assert_array_equal(tb_idx[tbs_max - tbs :].numpy(), flat[:tbs])
    np.testing.assert_array_equal(crc_idx.numpy(), flat[tbs:])


# --- turbo_decode_dyn(perm_groups=) ---------------------------------------------------


@pytest.mark.parametrize("amp,iters", [(3.0, 4), (0.9, 6)])
def test_turbo_decode_dyn_perm_groups(amp, iters):
    """W = 2 windows of B_CB = 3 slots at K_max 512: row 0 a TB of three
    layouts (codeblock 0, K-, K+), row 1 two codeblocks and an unused slot."""
    k_max, w, b_cb = 512, 2, 3
    layouts = [(512, 496, 504), (256, 128, 256)]  # per row: k3 = (codeblock 0, K-, K+)
    cls = np.array([[0, 1, 2], [0, 1, 0]], np.int32)
    valid = np.array([[True, True, True], [True, True, False]])
    rng = np.random.default_rng(int(amp * 10))
    per3 = np.tile(np.arange(k_max, dtype=np.int32), (w, 3, 1))
    inv3 = per3.copy()
    for i, k3 in enumerate(layouts):
        for v, k in enumerate(k3):
            per3[i, v], inv3[i, v] = r_rmd.qpp_np(k, k_max)
    b = w * b_cb
    d = np.zeros((b, 3, k_max + 4), np.float32)
    k_vec = np.full(b, 40, np.int32)
    for i in range(w):
        for j in range(b_cb):
            if not valid[i, j]:
                continue
            k = layouts[i][cls[i, j]]
            enc = turbo_encode_np(crc_attach_np(rng.integers(0, 2, k - 24).astype(np.uint8), LTE_CRC24A))
            d[i * b_cb + j, :, : k + 4] = (2 * enc.astype(np.float32) - 1) * amp + rng.normal(0, 1.0,
                                                                                              enc.shape)
            k_vec[i * b_cb + j] = k
    crc_ab = r_dyn.crc_table_ab(k_max)
    is_b = np.zeros(b, bool)
    r_bits, r_post, r_it = r_dyn.turbo_decode_dyn(
        jnp.asarray(d), jnp.asarray(k_vec), None, None, jnp.asarray(valid.reshape(-1)), k_max, iters,
        crc_table=jnp.asarray(crc_ab), crc_is_b=jnp.asarray(is_b),
        perm_groups=(jnp.asarray(per3), jnp.asarray(inv3), jnp.asarray(cls)), backend="scan")
    args = (torch.from_numpy(d), torch.from_numpy(k_vec))
    kw = dict(crc_table=torch.from_numpy(crc_ab), crc_is_b=torch.from_numpy(is_b))
    bits, post, n_it = t_dyn.turbo_decode_dyn(
        *args, None, None, torch.from_numpy(valid.reshape(-1)), k_max, iters,
        perm_groups=(i64(per3), i64(inv3), torch.from_numpy(cls)), **kw)
    rows = np.repeat(np.arange(w), b_cb), cls.reshape(-1)
    bits_row, post_row, it_row = t_dyn.turbo_decode_dyn(
        *args, i64(per3[rows]), i64(inv3[rows]), torch.from_numpy(valid.reshape(-1)), k_max, iters, **kw)
    assert torch.equal(bits, bits_row) and torch.equal(post, post_row) and torch.equal(n_it, it_row)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(n_it.numpy(), np.asarray(r_it))
    below_k = np.arange(k_max)[None, :] < k_vec[:, None]
    np.testing.assert_allclose(post.numpy()[below_k], np.asarray(r_post)[below_k], atol=2e-3)
    if amp < 3.0:
        assert len(set(n_it.numpy()[valid.reshape(-1)].tolist())) > 1


def test_rm_positions_every_size_on_the_cpu():
    """chip_smoke.py phase 43's check: all 188 sizes and a filler case, rv
    0-3, against the host's `turbo_rm_indices`."""
    import chip_smoke

    assert chip_smoke.rm_positions_check("cpu") == 4 * 189


def test_perm_groups_window_on_the_cpu():
    """chip_smoke.py phase 43's chain on a 15 PRB window of MCS 0, 28 and 16
    (two codeblock slots a row): the scatter and gather softbuffers agree,
    every TB comes back and is the sent one, the per-row form identical."""
    import chip_smoke

    win = chip_smoke.perm_groups_window("cpu", nof_prb=15, mcs=(0, 28, 16))
    assert (win.w, win.b_cb) == (3, 2)
    res, res_row = win.run(), win.run(per_row=True)
    assert chip_smoke.check_perm_groups(win, res, res_row) == 3
