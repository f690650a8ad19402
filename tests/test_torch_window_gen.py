"""The port's generate windows against the JAX reference (`WindowedEnbDl`,
`WindowedUeUl`, `WindowedEnbDlMimo`, `window_channel` and the shared
codeword core), and the loopback round trips generator → channel → decode
engine, on the CPU at small sizes (W = 4, 25-50 PRB cells).

The same numpy inputs, made from a seed, go through the reference function
and its counterpart.  Tolerances: host tables, the dense payload, the
dynamic-K encoder's d-streams and the row codewords are equal bit for bit
(the codewords also equal the reference's host DL-SCH encoder); generated
samples within 2e-6 absolute of the reference's (the encoder's bar; largest
seen 4.5e-7); `window_channel` without noise within 2e-6 absolute of h·tx
and of the reference; with noise, the mean of each real component within
five standard errors of 0 and the variance within 3% of noise_amp².  The
loopback decodes have no reference of their own: every TB must pass its CRC
and equal the sent one.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.fec.turbo as r_turbo
import srsran_tpu.pipeline_window as r_pw
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.fec.cbsegm import CB_SIZES, cbsegm
from srsran_tpu.phy.fec.rate_match_dev import qpp_np
from srsran_tpu.phy.modem import Mod
from srsran_tpu.phy.phch.pdsch import DlGrant, DlGrant2
from srsran_tpu.phy.phch.pusch import UlGrant
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs, tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
from srsran_tpu.phy.phch.sch import TbCoding, dlsch_encode_np
import srsran_tpu_torch.phy.fec.turbo as t_turbo
import srsran_tpu_torch.pipeline_window as t_pw
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_torch_fixture", Path(__file__).resolve().parents[1] / "tools" / "make_torch_fixture.py")
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)

W = 4
SAMPLE_ATOL = 2e-6
K_MAX = t_pw.K_MAX


def ri2c(x) -> np.ndarray:
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


# --- host side ------------------------------------------------------------------


@pytest.mark.parametrize("m_sc,qm", [(12, 2), (108, 4), (300, 6), (600, 8), (1200, 6)])
def test_ul_interleave_and_pad_tables(m_sc, qm):
    nsym = 12
    np.testing.assert_array_equal(t_pw._ul_interleave_tab(m_sc, qm, nsym),
                                  np.asarray(r_pw._ul_interleave_tab_dev(m_sc, qm, nsym)))
    np.testing.assert_array_equal(t_pw._ul_pad_tab(m_sc, qm, nsym),
                                  np.asarray(r_pw._ul_pad_tab_dev(m_sc, qm, nsym)))


@pytest.mark.parametrize("k,f,rv,e_cap", [(40, 8, 0, 16384), (512, 0, 2, 24576),
                                          (6144, 0, 1, 24576), (1056, 32, 3, 65536)])
def test_tx_table_wraps_like_the_tiled_reference(k, f, rv, e_cap):
    """The port keeps one row of n_valid entries and wraps j mod n_valid on
    the device; the reference tiles the row to e_cap on the host."""
    nv = 3 * (k + 4) - 2 * f
    got = t_pw._tx_table(k, f, rv)
    assert got.shape == (3 * (K_MAX + 4),) and not got[nv:].any()
    np.testing.assert_array_equal(got[np.arange(e_cap) % nv],
                                  np.asarray(r_pw._tx_table_dev(k, f, rv, e_cap)))


@pytest.mark.parametrize("template", ["crs", "full"])
def test_inverse_re_tables_and_templates(template):
    cell = Cell(nof_prb=25, nof_ports=1, id=301)
    ref = r_pw.WindowedEnbDl(cell, cfi=2, w=2, template=template)
    mimo = r_pw.WindowedEnbDlMimo(Cell(nof_prb=25, nof_ports=2, id=77), cfi=1, w=2)
    for sf in (0, 3, 5):
        prb = tuple(range(3, 20))
        inv, _n_re = ref._inv(sf, prb)
        np.testing.assert_array_equal(t_pw._inv_re_np(from_reference(cell), sf, 2, prb), np.asarray(inv))
        np.testing.assert_array_equal(t_pw._tmpl_np(from_reference(cell), sf, 1, template)[0],
                                      ri2c(ref._tmpl(sf)))
        np.testing.assert_array_equal(t_pw._tmpl_np(from_reference(mimo.cell), sf, 2, "crs"),
                                      ri2c(mimo._tmpl(sf)))


def test_payload_dense():
    rng = np.random.default_rng(3)
    tbs = [16, 2792, 40, 6200, 16]
    payloads = [rng.integers(0, 2, t).astype(np.uint8) for t in tbs]
    got = t_pw._payload_dense(payloads, tbs, 1200, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (5, 1200)
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_pw._upload_payload_dense(payloads, tbs, 1200)))


# (K per row, filler bits per row): mixed sizes in one batch, the smallest and
# largest K, codeblocks whose head is filler
ENC_CASES = {
    "mixed": ((40, 6144, 512, 3136, 40, 6080, 1056, 2112), (0,) * 8),
    "filler": ((40, 528, 6144, 1024), (24, 56, 0, 8)),
    "all_sizes": (tuple(CB_SIZES[::5]), (0,) * len(CB_SIZES[::5])),
}


@pytest.mark.parametrize("case", list(ENC_CASES))
def test_turbo_encode_device_dyn(case):
    ks, fs = ENC_CASES[case]
    rng = np.random.default_rng(len(ks))
    classes = sorted(set(ks))
    bits = np.zeros((len(ks), K_MAX), np.uint8)
    for i, (k, f) in enumerate(zip(ks, fs)):
        bits[i, f:k] = rng.integers(0, 2, k - f)
    perq = np.stack([qpp_np(k, K_MAX)[0] for k in classes])
    cls = np.array([classes.index(k) for k in ks], np.int32)
    k_vec = np.array(ks, np.int32)
    ref = np.asarray(jax.jit(r_turbo.turbo_encode_device_dyn)(
        jnp.asarray(bits), jnp.asarray(k_vec), (jnp.asarray(perq), jnp.asarray(cls))))
    got = t_turbo.turbo_encode_device_dyn(
        torch.from_numpy(bits), torch.from_numpy(k_vec),
        (torch.from_numpy(perq.astype(np.int64)), torch.from_numpy(cls)))
    assert got.dtype == torch.uint8 and got.shape == (len(ks), 3, K_MAX + 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    for i, k in enumerate(ks):  # and each row is the host encoder's codeblock
        np.testing.assert_array_equal(got[i, :, : k + 4].numpy(), t_turbo.turbo_encode_np(bits[i, :k]))


def port_codewords(eng, stages_pack_args):
    """The port's codeword stage of a plan."""
    stages, _pack = eng._plan(*stages_pack_args[0], **stages_pack_args[1])
    assert [name for name, _fn in stages] == ["codewords", "samples"]
    return stages[0][1](None).numpy()


def check_host_encoder(cw, specs, payloads):
    """Each row codeword is the reference host DL-SCH encoder's, zero past
    its length."""
    for row, (tbs, g, qm, rv), tb in zip(cw, specs, payloads):
        np.testing.assert_array_equal(row[:g], dlsch_encode_np(tb, TbCoding(tbs=tbs, g=g, qm=qm, rv=rv)))
        assert not row[g:].any()


# (tbs, g, qm, rv) rows: the largest TB (16 codeblocks of K = 6144); one TB
# at rv 0-3; tiny TBs whose codeword repeats the circular buffer (filler
# bits, e > n_valid); a one-codeblock TB (no CRC24B)
CORE_CASES = {
    "sixteen_codeblocks": [(97896, 115200, 8, 0), (75376, 90000, 6, 2)],
    "rv_0_to_3": [(6200, 9000, 6, rv) for rv in (0, 1, 2, 3)],
    "repetition": [(16, 1800, 2, 0), (40, 15000, 2, 1), (2000, 14000, 2, 3)],
    "one_codeblock": [(2792, 8000, 2, 0), (6120, 7000, 4, 2)],
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_codeword_core(case):
    specs = CORE_CASES[case]
    rng = np.random.default_rng(len(case))
    payloads = [rng.integers(0, 2, s[0]).astype(np.uint8) for s in specs]
    if case == "sixteen_codeblocks":
        assert cbsegm(97896).C == 16
    if case == "one_codeblock":
        assert all(cbsegm(s[0]).C == 1 for s in specs)
    eng = t_pw.WindowedEnbDl(from_reference(Cell(nof_prb=6)), w=len(specs), device="cpu")
    pack, _rows, cw_fn = eng._codewords(specs, payloads, np.zeros((len(specs), 1)))
    got = cw_fn(None)
    assert got.dtype == torch.uint8 and got.shape == (len(specs), t_pw.G_MAX)
    np.testing.assert_array_equal(got.numpy(), TOOL.reference_codewords(specs, payloads))
    check_host_encoder(got.numpy(), specs, payloads)
    if case == "repetition":
        assert pack.key[5] == 11  # a fold depth the decode needs: 40 bits over 15000


# --- the generators ---------------------------------------------------------------


def dl_grants(cell, rng, n, mcs_range=(0, 27)):
    sfs, grants, tbs = [], [], []
    while len(grants) < n:
        sf, mcs = int(rng.integers(0, 10)), int(rng.integers(*mcs_range))
        l = int(rng.integers(4, cell.nof_prb + 1))
        st = int(rng.integers(0, cell.nof_prb + 1 - l))
        if dl_tbs(mcs, l) == 0:
            continue
        sfs.append(sf)
        grants.append(DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                              rnti=0x46))
        tbs.append(rng.integers(0, 2, grants[-1].tbs).astype(np.uint8))
    return sfs, grants, tbs


def ul_grants(cell, rng, n, widths=(4, 9, 25)):
    sfs, grants, tbs = [], [], []
    while len(grants) < n:
        sf, mcs = int(rng.integers(0, 10)), int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, cell.nof_prb - nprb + 1))
        t = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if t == 0:
            continue
        sfs.append(sf)
        grants.append(UlGrant(prb_start=st, nof_prb=nprb, mod=ul_mcs_to_mod(mcs), tbs=t, rv=0, rnti=0x46))
        tbs.append(rng.integers(0, 2, t).astype(np.uint8))
    return sfs, grants, tbs


def mimo_grants(cell, rng, n):
    """n two-codeword grants: PMI 0, 1, 2 and, last, one large-delay CDD."""
    sfs, grants, pairs = [], [], []
    for i in range(n):
        mcs1, mcs2 = int(rng.integers(4, 16)), int(rng.integers(4, 16))
        l = int(rng.integers(10, cell.nof_prb + 1))
        st = int(rng.integers(0, cell.nof_prb + 1 - l))
        sfs.append(int(rng.integers(0, 10)))
        grants.append(DlGrant2(prb=tuple(range(st, st + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                               mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=i % 3, rnti=0x46,
                               tx_scheme="cdd" if i == n - 1 else "spatialmux"))
        pairs.append(tuple(rng.integers(0, 2, t).astype(np.uint8) for t in (grants[-1].tbs1, grants[-1].tbs2)))
    return sfs, grants, pairs


def overlay_of(cell, rng):
    """A control-region overlay: random REs and values, the last five
    indices of each row past the grid (pad, dropped)."""
    s = cell.nsymb_per_sf * cell.nof_re_per_symbol
    idx = np.stack([rng.choice(s, 40, replace=False) for _ in range(W)]).astype(np.int32)
    idx[:, -5:] = s + 7
    vals = (rng.standard_normal((W, 40)) + 1j * rng.standard_normal((W, 40))).astype(np.complex64)
    return idx, vals


def pucch_of(cell, rng):
    """Per-slot PUCCH PRBs (one at the band edge), random PRB-local blocks,
    and a pad row whose PUSCH is masked."""
    prb = rng.integers(0, cell.nof_prb, (W, 2)).astype(np.int32)
    prb[0] = (0, cell.nof_prb - 1)
    grids = (rng.standard_normal((W, cell.nsymb_per_sf, 12))
             + 1j * rng.standard_normal((W, cell.nsymb_per_sf, 12))).astype(np.complex64)
    return prb, grids, np.array([True, False, True, True])


def check_samples(got: torch.Tensor, ref, shape):
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    ref = ri2c(ref)
    assert float(np.abs(got.numpy() - ref).max()) <= SAMPLE_ATOL
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("case", ["crs", "full_overlay"])
def test_enb_dl_window(case):
    cell = Cell(nof_prb=25, nof_ports=1, id=17 if case == "crs" else 301)
    rng = np.random.default_rng(13)
    sfs, grants, tbs = dl_grants(cell, rng, W)
    kw, template = {}, "crs"
    if case == "full_overlay":
        sfs[0], sfs[2] = 0, 5  # the subframes that carry PSS and SSS
        kw, template = dict(overlay=overlay_of(cell, rng)), "full"
    ref = r_pw.WindowedEnbDl(cell, cfi=1, w=W, template=template).dispatch_window(tbs, sfs, grants, **kw)
    eng = t_pw.WindowedEnbDl(from_reference(cell), cfi=1, w=W, template=template, device="cpu")
    pg = [from_reference(g) for g in grants]
    out = eng.dispatch_window(tbs, sfs, pg, **kw)
    check_samples(out, ref, (W, cell.sf_len))
    np.testing.assert_array_equal(eng.samples(out), out.numpy())
    assert eng.stats == {"windows": 1, "ttis": W}
    n_res = [t_pw._padded_re_indices(from_reference(cell), s, 1, g.prb)[1] for s, g in zip(sfs, pg)]
    specs = [(g.tbs, n * g.qm, g.qm, g.rv) for g, n in zip(grants, n_res)]
    check_host_encoder(port_codewords(eng, ((tbs, sfs, pg), kw)), specs, tbs)


@pytest.mark.parametrize("case", ["plain", "pucch"])
def test_ue_ul_window(case):
    cell = Cell(nof_prb=25, nof_ports=1, id=17)
    rng = np.random.default_rng(23)
    sfs, grants, tbs = ul_grants(cell, rng, W)
    kw = dict(pucch=pucch_of(cell, rng)) if case == "pucch" else {}
    ref = r_pw.WindowedUeUl(cell, w=W).dispatch_window(tbs, sfs, grants, **kw)
    eng = t_pw.WindowedUeUl(from_reference(cell), w=W, device="cpu")
    pg = [from_reference(g) for g in grants]
    check_samples(eng.dispatch_window(tbs, sfs, pg, **kw), ref, (W, cell.sf_len))
    specs = [(g.tbs, 12 * 12 * g.nof_prb * g.qm, g.qm, g.rv) for g in grants]
    check_host_encoder(port_codewords(eng, ((tbs, sfs, pg), kw)), specs, tbs)
    times = eng.stage_times(tbs, sfs, pg, n=1, **kw)
    assert list(times) == ["codewords", "samples"] and all(t > 0 for t in times.values())


def test_enb_dl_mimo_window():
    cell = Cell(nof_prb=25, nof_ports=2, id=77)
    rng = np.random.default_rng(37)
    sfs, grants, pairs = mimo_grants(cell, rng, W)
    assert [g.pmi for g in grants[:3]] == [0, 1, 2] and grants[3].tx_scheme == "cdd"
    ref = r_pw.WindowedEnbDlMimo(cell, cfi=1, w=W).dispatch_window(pairs, sfs, grants)
    eng = t_pw.WindowedEnbDlMimo(from_reference(cell), cfi=1, w=W, device="cpu")
    pg = [from_reference(g) for g in grants]
    check_samples(eng.dispatch_window(pairs, sfs, pg), ref, (W, 2, cell.sf_len))
    # codeword rows two per TTI, as the decode engine's rows
    n_res = [t_pw._padded_re_indices(from_reference(cell), s, 1, g.prb)[1] for s, g in zip(sfs, pg)]
    specs = [sp for g, n in zip(grants, n_res)
             for sp in ((g.tbs1, n * g.qm1, g.qm1, 0), (g.tbs2, n * g.qm2, g.qm2, 0))]
    check_host_encoder(port_codewords(eng, ((pairs, sfs, pg), {})), specs,
                       [t for pair in pairs for t in pair])


@pytest.mark.parametrize("ntx", [1, 2])
def test_window_channel_without_noise(ntx):
    rng = np.random.default_rng(ntx)
    shape = (W, 3000) if ntx == 1 else (W, 2, 3000)
    tx = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    h = (np.array([[0.9 - 0.35j]]) if ntx == 1 else
         np.array([[1.0 + 0.1j, 0.2 - 0.3j], [-0.25 + 0.15j, 0.8 - 0.4j]])).astype(np.complex64)
    got = t_pw.window_channel(torch.from_numpy(tx), h, 0.0, device="cpu")
    assert got.dtype == torch.complex64 and tuple(got.shape) == (W, h.shape[0], 3000)
    want = np.einsum("rp,wpl->wrl", h, tx.reshape(W, ntx, 3000))
    assert float(np.abs(got.numpy() - want).max()) <= SAMPLE_ATOL
    ref = r_pw.window_channel(jnp.asarray(np.stack([tx.real, tx.imag], -1)), h, 0.0)
    assert float(np.abs(got.numpy() - ri2c(ref)).max()) <= SAMPLE_ATOL


def test_window_channel_noise_moments():
    """With noise: zero mean and variance noise_amp² per real component,
    the same draw for the same seed, another for another seed."""
    amp = 0.3
    tx = torch.zeros((W, 2, 20000), dtype=torch.complex64)
    h = np.eye(2, dtype=np.complex64)
    rx = t_pw.window_channel(tx, h, amp, seed=5, device="cpu")
    v = torch.view_as_real(rx).reshape(-1, 2).double()
    n = v.shape[0]
    assert float(v.mean(dim=0).abs().max()) <= 5 * amp / np.sqrt(n)
    assert float((v.var(dim=0) / amp**2 - 1).abs().max()) <= 0.03
    assert torch.equal(rx, t_pw.window_channel(tx, h, amp, seed=5, device="cpu"))
    assert not torch.equal(rx, t_pw.window_channel(tx, h, amp, seed=6, device="cpu"))


# --- loopback round trips: generator → window_channel → decode engine -------------------


CELL50 = Cell(nof_prb=50, nof_ports=1, id=17)


def check_round_trip(res, sent):
    assert len(res) == len(sent)
    for (tb_hat, ok, _n), tb in zip(res, sent):
        assert ok and tb_hat.shape == tb.shape
        np.testing.assert_array_equal(tb_hat, tb)


def test_dl_loopback():
    """Payload bits to CRC-checked TBs without the baseband leaving the
    device: two windows of fresh grants through one generator, channel and
    `WindowedUeDl` (device-resident ingest)."""
    cell = from_reference(CELL50)
    rng = np.random.default_rng(41)
    enb = t_pw.WindowedEnbDl(cell, cfi=1, w=W, device="cpu")
    ue = t_pw.WindowedUeDl(cell, cfi=1, w=W, max_iterations=3, device="cpu")
    for round_i in range(2):
        sfs, grants, tbs = dl_grants(CELL50, rng, W)
        pg = [from_reference(g) for g in grants]
        rx = t_pw.window_channel(enb.dispatch_window(tbs, sfs, pg), np.array([[0.9 - 0.35j]]), 0.02,
                                 seed=round_i, device="cpu")
        assert tuple(rx.shape) == (W, 1, cell.sf_len)
        res, _soft = ue.decode_window(rx, sfs, pg)
        check_round_trip(res, tbs)


def test_ul_loopback():
    cell = from_reference(CELL50)
    rng = np.random.default_rng(53)
    sfs, grants, tbs = ul_grants(CELL50, rng, W, widths=(4, 9, 25, 50))
    pg = [from_reference(g) for g in grants]
    tx = t_pw.WindowedUeUl(cell, w=W, device="cpu").dispatch_window(tbs, sfs, pg)
    rx = t_pw.window_channel(tx, np.array([[0.85 + 0.3j]]), 0.02, device="cpu")
    res, _soft = t_pw.WindowedEnbUl(cell, w=W, max_iterations=3, device="cpu").decode_window(rx, sfs, pg)
    check_round_trip(res, tbs)


def test_mimo_loopback():
    cell = Cell(nof_prb=25, nof_ports=2, id=77)
    rng = np.random.default_rng(43)
    sfs, grants, pairs = mimo_grants(cell, rng, W)
    pg = [from_reference(g) for g in grants]
    tx = t_pw.WindowedEnbDlMimo(from_reference(cell), cfi=1, w=W, device="cpu").dispatch_window(pairs, sfs, pg)
    h = np.array([[1.0 + 0.1j, 0.2 - 0.3j], [-0.25 + 0.15j, 0.8 - 0.4j]], np.complex64)
    rx = t_pw.window_channel(tx, h, 0.01, device="cpu")
    ue = t_pw.WindowedUeDlMimo(from_reference(cell), cfi=1, w=W, max_iterations=4, device="cpu")
    res, _soft = ue.decode_window(rx, sfs, pg)
    for (tb1, tb2), ((t1, ok1), (t2, ok2), _n) in zip(pairs, res):
        assert ok1 and ok2
        np.testing.assert_array_equal(t1, tb1)
        np.testing.assert_array_equal(t2, tb2)


def test_largest_tb_round_trip():
    """The largest LTE TB (256QAM MCS 27 on 100 PRB: 97896 bits, 16
    codeblocks) generated at W = 2, host noise, int16 ingest."""
    cell = from_reference(Cell(nof_prb=100, nof_ports=1, id=301))
    rng = np.random.default_rng(41)
    grant = from_reference(DlGrant(prb=tuple(range(100)), mod=Mod.QAM256, tbs=97896, rnti=0x46))
    tbs = [rng.integers(0, 2, 97896).astype(np.uint8) for _ in range(2)]
    tx = t_pw.WindowedEnbDl.samples(
        t_pw.WindowedEnbDl(cell, cfi=1, w=2, device="cpu").dispatch_window(tbs, [2, 7], [grant] * 2))
    rx = (tx + 0.005 * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))).astype(np.complex64)
    ue = t_pw.WindowedUeDl(cell, cfi=1, w=2, max_iterations=3, ingest="int16", device="cpu")
    res, _soft = ue.decode_window(rx[:, None, :], [2, 7], [grant] * 2)
    check_round_trip(res, tbs)


def test_generated_link_harq_rv_combining():
    """HARQ over the generated uplink: rv 0 fails at heavy noise; the rv 2
    retransmission (another TX rate-match class, the same payload) combines
    in `WindowedEnbUl`'s softbuffer and decodes."""
    cell = from_reference(CELL50)
    rng = np.random.default_rng(29)
    ue = t_pw.WindowedUeUl(cell, w=2, device="cpu")
    enb = t_pw.WindowedEnbUl(cell, w=2, max_iterations=5, device="cpu")
    tbs = tbs_lookup(ul_mcs_to_itbs(16), 15)
    g0 = from_reference(UlGrant(prb_start=3, nof_prb=15, mod=ul_mcs_to_mod(16), tbs=tbs, rv=0, rnti=0x46))
    filler = from_reference(UlGrant(prb_start=20, nof_prb=9, mod=ul_mcs_to_mod(5),
                                    tbs=tbs_lookup(ul_mcs_to_itbs(5), 9), rv=0, rnti=0x47))
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    ftb = rng.integers(0, 2, filler.tbs).astype(np.uint8)

    def link(grants):
        tx = ue.samples(ue.dispatch_window([tb, ftb], [4, 9], grants))
        return (tx + 0.33 * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
                ).astype(np.complex64)[:, None, :]

    p0 = enb.dispatch_window(link([g0, filler]), [4, 9], [g0, filler])
    assert not enb.results(p0)[0][1], "rv 0 decoded alone at this SNR"
    g2 = dataclasses.replace(g0, rv=2)
    res2, _soft = enb.decode_window(link([g2, filler]), [4, 9], [g2, filler], softbuffer=p0.softbuffer)
    assert res2[0][1], "rv 0 + rv 2 did not combine"
    np.testing.assert_array_equal(res2[0][0], tb)


# --- the program set and the device contract ------------------------------------------


def test_program_set_stays_bounded():
    """Three fresh mixes through one generator and one decode engine per
    direction (the port's form of the reference's compile budget): one stage
    A function, at most 8 stage B functions, stage C functions at most one
    per distinct dense-occupancy key, the generators' functions at most one
    per Qm set and one codeword core per TB width bucket; the sized table
    caches stay within their bounds."""
    cell = from_reference(Cell(nof_prb=25, nof_ports=1, id=5))
    rng = np.random.default_rng(11)
    caches = (t_pw._build_win_c, t_pw._build_win_tx, t_pw._build_win_ul_tx, t_pw._make_codeword_core)
    before = [c.cache_info().currsize for c in caches]
    enb, ue = (t_pw.WindowedEnbDl(cell, w=2, device="cpu"),
               t_pw.WindowedUeDl(cell, cfi=1, w=2, max_iterations=2, device="cpu"))
    ue_tx, enb_rx = (t_pw.WindowedUeUl(cell, w=2, device="cpu"),
                     t_pw.WindowedEnbUl(cell, w=2, max_iterations=2, device="cpu"))
    a_dl, a_ul = ue._a, enb_rx._a
    keys, qms, caps = set(), set(), set()
    for _ in range(3):
        for gen, dec, grants_of in ((enb, ue, dl_grants), (ue_tx, enb_rx, ul_grants)):
            sfs, grants, tbs = grants_of(Cell(nof_prb=25, nof_ports=1, id=5), rng, 2)
            pg = [from_reference(g) for g in grants]
            p = dec.dispatch_window(t_pw.window_channel(gen.dispatch_window(tbs, sfs, pg),
                                                        np.ones((1, 1)), 0.01, device="cpu"), sfs, pg)
            check_round_trip(dec.results(p), tbs)
            keys.add(p.pack.key)
            qms.add((gen is enb, tuple(sorted({g.qm for g in pg}))))
            caps.add(p.pack.key[6])
    assert ue._a is a_dl and enb_rx._a is a_ul
    assert len(ue._b_cache) <= 2 * 4 and len(enb_rx._b_cache) <= 2 * 4
    grown = [c.cache_info().currsize - b for c, b in zip(caches, before)]
    assert grown[0] <= len(keys) <= 6
    assert grown[1] + grown[2] <= len(qms) and grown[3] <= len(caps) <= len(t_pw.TBCAP_BUCKETS)
    for sized in (t_pw._tx_tables, t_pw._j0_tables, t_pw._qpp_tables, t_pw._tb_tables):
        assert sized.cache_info().currsize <= sized.cache_info().maxsize


@pytest.mark.parametrize("cls", ["WindowedEnbDl", "WindowedUeUl", "WindowedEnbDlMimo", "window_channel"])
def test_entry_points_take_the_card_by_default(cls):
    cell = from_reference(Cell(nof_prb=6, nof_ports=2 if cls == "WindowedEnbDlMimo" else 1, id=1))
    assert not torch.cuda.is_available()
    if cls == "window_channel":
        tx = torch.zeros((2, cell.sf_len), dtype=torch.complex64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_pw.window_channel(tx, np.ones((1, 1)), 0.1)
        assert t_pw.window_channel(tx, np.ones((1, 1)), 0.1, device="cpu").shape == (2, 1, cell.sf_len)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(t_pw, cls)(cell, w=2)
    assert getattr(t_pw, cls)(cell, w=2, device="cpu").device == torch.device("cpu")


def test_bad_arguments_raise():
    cell = from_reference(Cell(nof_prb=6, nof_ports=1, id=1))
    grant = from_reference(DlGrant(prb=tuple(range(6)), tbs=120, rnti=0x46))
    enb = t_pw.WindowedEnbDl(cell, w=2, device="cpu")
    tb = np.zeros(120, np.uint8)
    with pytest.raises(ValueError, match="window takes"):
        enb.dispatch_window([tb], [1], [grant])
    with pytest.raises(ValueError, match="payload bits"):
        enb.dispatch_window([tb, tb[:-8]], [1, 2], [grant, grant])
    with pytest.raises(ValueError, match="template"):
        t_pw.WindowedEnbDl(cell, template="pss", device="cpu")
    with pytest.raises(ValueError, match="transmit ports"):
        t_pw.window_channel(torch.zeros((2, 2, 100), dtype=torch.complex64), np.ones((1, 1)), 0.0,
                            device="cpu")
    with pytest.raises(ValueError, match="expected"):
        t_pw.window_channel(torch.zeros((2, 100), dtype=torch.complex64, device="meta"),
                            np.ones((1, 1)), 0.0, device="cpu")
