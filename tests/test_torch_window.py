"""The port's windowed decode engines against the JAX reference, module by
module and as a whole (`WindowedUeDl`, `WindowedUeDlMimo`, `WindowedEnbUl`),
on the CPU at small sizes (W = 4, 25-50 PRB cells, 2-4 iterations).

The same numpy inputs, made from a seed, go through the reference function
and its counterpart.  On CPU tensors the port runs the MAP kernel's plain
version (`map_pass_plain(k_vec=)`); the reference runs its XLA scan, as its
own tests do on the CPU.  The CUDA kernel is held against the plain version
on the card by `chip_smoke.py`.

Tolerances, relative to each array's largest magnitude unless said
otherwise: host tables, `pack_window` and the quantized ingest are equal bit
for bit; `idft_bluestein` within 1e-4 absolute of the reference and of the
IDFT matrix (the reference's own bar); stage A grids, channel estimates and
noise within 2e-5 (largest seen 7.7e-7); the stage B LLRs on the reference's
stage A output within 2e-5, the uplink's too (largest seen 4.0e-7 downlink,
1.1e-6 uplink behind the Bluestein IDFT); stage C on the reference's own LLRs
gives the identical packed buffer and a softbuffer within 2e-6 (seen: equal);
every engine as a whole gives identical TB bits where the CRC passes,
identical CRC flags, iteration counts and `pack.key`, and a softbuffer within
2e-6 (largest seen 6.7e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.dft_precoding as r_dft
import srsran_tpu.phy.fec.rate_match_dev as r_rmd
import srsran_tpu.phy.fec.turbo_dyn as r_dyn
import srsran_tpu.pipeline_window as r_pw
from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.common import LTE_CRC24A, Cell
from srsran_tpu.phy.crc import crc_attach_np
from srsran_tpu.phy.fec.turbo import turbo_encode_np
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, DlGrant2, pdsch_encode2_np, pdsch_encode_np
from srsran_tpu.phy.phch.ra import (
    dl_mcs_to_mod,
    dl_tbs,
    tbs_lookup,
    ul_mcs_to_itbs,
    ul_mcs_to_mod,
)
from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
import srsran_tpu_torch.phy.dft_precoding as t_dft
import srsran_tpu_torch.phy.fec.rate_match_dev as t_rmd
import srsran_tpu_torch.phy.fec.turbo_dyn as t_dyn
import srsran_tpu_torch.pipeline_window as t_pw
from srsran_tpu_torch.convert import from_reference, softbuffer_from_reference
from srsran_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec, carrier_mesh

torch.set_num_threads(1)

W = 4
LLR_RTOL = 2e-5
SOFT_RTOL = 2e-6


def rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def ri2c(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy((x[..., 0] + 1j * x[..., 1]).astype(np.complex64))


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


# --- host side ------------------------------------------------------------------


@pytest.mark.parametrize("k,f,rv", [(40, 0, 0), (40, 8, 2), (512, 16, 1), (3136, 0, 3),
                                    (6144, 56, 0), (6144, 0, 2)])
def test_j0_variant_np(k, f, rv):
    got, nv = t_rmd.j0_variant_np(k, f, rv, 6144)
    ref, nv_ref = r_rmd.j0_variant_np(k, f, rv, 6144)
    assert nv == nv_ref and got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [40, 512, 2112, 6080, 6144])
def test_qpp_np(k):
    for a, b in zip(t_rmd.qpp_np(k, 6144), r_rmd.qpp_np(k, 6144)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


# (tbs, g, qm, rv) rows: plain grants; a tiny TB on a wide allocation (13-fold
# repetition) with filler bits; 16 codeblocks (the largest TB); retransmissions
PACK_CASES = {
    "plain": [(2792, 8000, 2, 0), (14112, 27600, 4, 0), (6200, 9000, 6, 0), (2792, 8000, 2, 0)],
    "repetition_filler": [(16, 1800, 2, 0), (2000, 14000, 2, 1), (4008, 13000, 2, 0)],
    "sixteen_codeblocks": [(97896, 122880, 8, 0), (75376, 90000, 6, 2)],
    "retransmissions": [(6200, 9000, 6, rv) for rv in (0, 2, 3, 1)] + [(6200, 9000, 6, 0)],
    "one_row": [(40576, 55296, 4, 0)],
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_window(case):
    got, ref = t_pw.pack_window(PACK_CASES[case]), r_pw.pack_window(PACK_CASES[case])
    assert got.key == ref.key
    assert got.params.dtype == ref.params.dtype == np.int32
    np.testing.assert_array_equal(got.params, ref.params)
    for name in ("row_start", "row_ncb", "tbs", "fill_classes", "qpp_classes", "tb_classes"):
        assert getattr(got, name) == getattr(ref, name), name
    if case == "sixteen_codeblocks":
        assert got.row_ncb[0] == 16
    if case == "repetition_filler":
        assert got.key[5] == 11 and any(f for _k, f, _rv in got.fill_classes)


@pytest.mark.parametrize("case", ["plain", "sixteen_codeblocks"])
def test_class_tables(case):
    """The stacked per-class tables equal the reference's, the reassembly
    table cropped to the window's TB width."""
    pack = t_pw.pack_window(PACK_CASES[case])
    got = t_pw.class_tables(pack, torch.device("cpu"))
    ref = r_pw.class_tables(r_pw.pack_window(PACK_CASES[case]))
    sw = pack.key[6] * 8
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3])[:, t_pw.TBS_MAX - sw:])


@pytest.mark.parametrize("tbs", [16, 2792, 6200, 61664, 97896])
def test_tb_gather_table(tbs):
    got = t_pw._tb_gather_dev(tbs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(r_pw._tb_gather_dev(tbs)))


@pytest.mark.parametrize("m_sc,qm", [(12, 2), (108, 4), (600, 6), (1152, 4), (1200, 6)])
def test_ul_compose_tabs(m_sc, qm):
    for a, b in zip(t_pw._ul_compose_tabs(m_sc, qm, 12), r_pw._ul_compose_tabs(m_sc, qm, 12)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("nof_prb", [1, 9, 50])
def test_win_ul_dmrs(nof_prb):
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    got = t_pw._win_ul_dmrs(from_reference(cell), nof_prb)
    assert got.dtype == np.complex64 and got.shape == (2, t_pw.M_MAX)
    np.testing.assert_array_equal(got, ri2c(r_pw._win_ul_dmrs(cell, nof_prb)).numpy())


def test_constants_and_buckets():
    for name in ("K_MAX", "MAX_CB", "RE_MAX", "TBS_MAX", "TB_BYTES", "QMS", "M_MAX", "CLS_BUCKETS",
                 "ECAP_BUCKETS", "JFOLD_BUCKETS", "TBCAP_BUCKETS", "G_MAX"):
        assert getattr(t_pw, name) == getattr(r_pw, name), name
    assert [int(m) for m in t_pw.MODS] == [int(m) for m in r_pw.MODS]
    for n in list(range(1, 40)) + [95, 96, 97, 352, 384, 385, 768, 769]:
        assert t_pw._pow2_bucket(n) == r_pw._pow2_bucket(n)
    with pytest.raises(ValueError):
        t_pw._bucket_of(129, t_pw.CLS_BUCKETS)


@pytest.mark.parametrize("ingest", ["int8", "int16", "float32"])
def test_quantize_ingest(ingest):
    rng = np.random.default_rng(3)
    samples = awgn(rng, np.zeros((3, 2, 500)), 0.7) * np.array([1.0, 1e-3, 40.0])[:, None, None]
    samples = samples.astype(np.complex64)
    (q, scale), (q_ref, scale_ref) = (m._quantize_ingest(samples, ingest) for m in (t_pw, r_pw))
    assert q.dtype == q_ref.dtype and scale.dtype == scale_ref.dtype == np.float32
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(scale, scale_ref)
    # the device dequantises to what the reference's stage A sees
    deq = t_pw._dequantize(torch.from_numpy(q), torch.from_numpy(scale)).numpy()
    want = q_ref.astype(np.float32) * scale_ref[:, None, None, None]
    np.testing.assert_array_equal(deq, want[..., 0] + 1j * want[..., 1])
    # a complex tensor is the device-resident ingest
    dev_in = torch.from_numpy(samples)
    q_dev, scale_dev = t_pw._quantize_ingest(dev_in, ingest)
    assert q_dev is dev_in and scale_dev.tolist() == [1.0, 1.0, 1.0]


# --- Bluestein transforms -----------------------------------------------------------


@pytest.mark.parametrize("m", [12, 36, 180, 300, 600, 960, 1200])
def test_idft_bluestein(m):
    rng = np.random.default_rng(m)
    M = 1200
    x = awgn(rng, np.zeros((3, M)), 1.0)  # columns beyond m are ignored
    got = t_dft.idft_bluestein(torch.from_numpy(x), m).numpy()
    assert got.dtype == np.complex64 and got.shape == (3, M)
    ref = np.asarray(r_dft.idft_bluestein(jnp.asarray(x), jnp.int32(m)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, :m], x[:, :m] @ t_dft._dft_matrix(m, True), rtol=0, atol=1e-4)
    assert not got[:, m:].any()


def test_bluestein_one_length_per_row():
    """The window's form: one length per TTI, (W, 1) against (W, nsym, M);
    the forward transform undoes the inverse."""
    rng = np.random.default_rng(0)
    ms = [12, 300, 1152, 600]
    x = awgn(rng, np.zeros((4, 3, 1200)), 1.0)
    m = torch.tensor(ms)[:, None]
    got = t_dft.idft_bluestein(torch.from_numpy(x), m)
    for i, mi in enumerate(ms):
        np.testing.assert_allclose(got[i, :, :mi].numpy(), x[i, :, :mi] @ t_dft._dft_matrix(mi, True),
                                   rtol=0, atol=1e-4)
        assert not got[i, :, mi:].any()
    back = t_dft.dft_bluestein(got, m).numpy()
    ref_back = np.asarray(r_dft.dft_bluestein(jnp.asarray(got.numpy()[1]), jnp.int32(300)))
    np.testing.assert_allclose(back[1], ref_back, rtol=0, atol=1e-4)
    for i, mi in enumerate(ms):
        np.testing.assert_allclose(back[i, :, :mi], x[i, :, :mi], rtol=0, atol=2e-4)


# --- turbo_decode_dyn(class_perms=) ---------------------------------------------------


@pytest.mark.parametrize("amp,iters", [(3.0, 4), (0.9, 6)])
def test_turbo_decode_dyn_class_perms(amp, iters):
    k_max, ks, b = 768, [768, 40, 384, 704, 384, 40], 8
    rng = np.random.default_rng(int(amp * 10))
    classes = sorted(set(ks))
    per_c = np.tile(np.arange(k_max, dtype=np.int32), (4, 1))  # class bucket 4, one unused
    inv_c = per_c.copy()
    for c, k in enumerate(classes):
        per_c[c], inv_c[c] = r_rmd.qpp_np(k, k_max)
    d = np.zeros((b, 3, k_max + 4), np.float32)
    k_vec, cls, valid = np.full(b, 40, np.int32), np.zeros(b, np.int32), np.zeros(b, bool)
    for i, k in enumerate(ks):
        enc = turbo_encode_np(crc_attach_np(rng.integers(0, 2, k - 24).astype(np.uint8), LTE_CRC24A))
        d[i, :, : k + 4] = (2 * enc.astype(np.float32) - 1) * amp + rng.normal(0, 1.0, enc.shape)
        k_vec[i], cls[i], valid[i] = k, classes.index(k), True
    crc_ab = r_dyn.crc_table_ab(k_max)
    is_b = np.zeros(b, bool)
    r_bits, r_post, r_it = r_dyn.turbo_decode_dyn(
        jnp.asarray(d), jnp.asarray(k_vec), None, None, jnp.asarray(valid), k_max, iters,
        crc_table=jnp.asarray(crc_ab), crc_is_b=jnp.asarray(is_b),
        class_perms=(jnp.asarray(per_c), jnp.asarray(inv_c), jnp.asarray(cls)))
    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731
    args = (torch.from_numpy(d), torch.from_numpy(k_vec))
    kw = dict(crc_table=torch.from_numpy(crc_ab), crc_is_b=torch.from_numpy(is_b))
    bits, post, n_it = t_dyn.turbo_decode_dyn(
        *args, None, None, torch.from_numpy(valid), k_max, iters,
        class_perms=(i64(per_c), i64(inv_c), i64(cls)), **kw)
    bits_row, post_row, it_row = t_dyn.turbo_decode_dyn(
        *args, i64(per_c[cls]), i64(inv_c[cls]), torch.from_numpy(valid), k_max, iters, **kw)
    assert torch.equal(bits, bits_row) and torch.equal(post, post_row) and torch.equal(n_it, it_row)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(n_it.numpy(), np.asarray(r_it))
    below_k = np.arange(k_max)[None, :] < k_vec[:, None]
    np.testing.assert_allclose(post.numpy()[below_k], np.asarray(r_post)[below_k], atol=2e-3)
    if amp < 3.0:
        assert len(set(n_it.numpy()[: len(ks)].tolist())) > 1


# --- the engines: stage by stage and as a whole ---------------------------------------


def dl_mix(cell, rng, n, amp=0.02, tx_scheme="port0", h=None, mcs_range=(0, 27)):
    """n noisy subframes of random one-codeword grants, rendered by the
    reference's host transmitter: [(rx (nrx, sf_len), sf_idx, grant, tb)]."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    out = []
    while len(out) < n:
        sf_idx, mcs = int(rng.integers(0, 10)), int(rng.integers(*mcs_range))
        l = int(rng.integers(4, cell.nof_prb + 1))
        st = int(rng.integers(0, cell.nof_prb + 1 - l))
        tbs = dl_tbs(mcs, l)
        if tbs == 0:
            continue
        grant = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs), tbs=tbs, rnti=0x46,
                        tx_scheme=tx_scheme)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
        put_crs_np(grid, cell, sf_idx)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))
        rx = tx if h is None else np.einsum("rp,pt->rt", h, tx)
        out.append((awgn(rng, rx, amp), sf_idx, grant, tb))
    return out


def harq_tx(cell, rng, tb, rv, sf_idx, amp=0.42):
    """One noisy subframe of the HARQ test grant (MCS 16 on 15 PRB) at rv."""
    grant = DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(16), tbs=dl_tbs(16, 15), rnti=0x46, rv=rv)
    grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
    put_crs_np(grid, cell, sf_idx)
    tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))
    return awgn(rng, tx, amp), sf_idx, grant, tb


def mimo_mix(cell, rng):
    """W two-codeword grants behind a 2x2 channel: PMI 0, 1, 2 and one CDD."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    h = np.array([[1.0 + 0.1j, 0.2 - 0.3j], [-0.25 + 0.15j, 0.8 - 0.4j]], np.complex64)
    out = []
    for i in range(W):
        sf_idx = int(rng.integers(0, 10))
        mcs1, mcs2 = int(rng.integers(4, 16)), int(rng.integers(4, 16))
        l = int(rng.integers(10, 26))
        st = int(rng.integers(0, 26 - l))
        grant = DlGrant2(prb=tuple(range(st, st + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                         mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=i % 3, rnti=0x46,
                         tx_scheme="cdd" if i == 3 else "spatialmux")
        tb1, tb2 = (rng.integers(0, 2, t).astype(np.uint8) for t in (grant.tbs1, grant.tbs2))
        full = np.zeros((2, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
        full += pdsch_encode2_np(cell, sf_idx, 1, grant, tb1, tb2)
        put_crs_np(full, cell, sf_idx)
        rx = np.einsum("rp,pt->rt", h, np.asarray(ofdm_tx_sf(ofdm, full)))
        out.append((awgn(rng, rx, 0.01), sf_idx, grant, (tb1, tb2)))
    return out


def ul_mix(cell, rng):
    out = []
    widths = (4, 9, 25, 50)
    while len(out) < W:
        sf_idx, mcs = int(rng.integers(0, 10)), int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, cell.nof_prb - nprb + 1))
        tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if tbs == 0:
            continue
        grant = UlGrant(prb_start=st, nof_prb=nprb, mod=ul_mcs_to_mod(mcs), tbs=tbs, rv=0, rnti=0x46)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        tx = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(grant, tb)))
        out.append((awgn(rng, tx[None, :], 0.02), sf_idx, grant, tb))
    return out


def ul_same_tti(cell, rng):
    """W UEs' PUSCH grants in one TTI: disjoint allocations, distinct RNTIs,
    one received subframe repeated along the window axis."""
    sf_idx, txs, out = 4, [], []
    for u, st in enumerate((0, 12, 24, 36)):
        mcs = int(rng.integers(4, 20))
        grant = UlGrant(prb_start=st, nof_prb=9, mod=ul_mcs_to_mod(mcs),
                        tbs=tbs_lookup(ul_mcs_to_itbs(mcs), 9), rv=0, rnti=0x46 + u)
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        txs.append(np.asarray(ue_ul_encode(cell, sf_idx, pusch=(grant, tb))))
        out.append([None, sf_idx, grant, tb])
    rx = awgn(rng, sum(txs)[None, :], 0.02)
    return [(rx, s, g, tb) for _rx, s, g, tb in out]


@dataclasses.dataclass
class Engines:
    """A reference engine and its counterpart, and what one window of a mix
    gives in each: the stage outputs of the reference's own plan, and both
    packs."""

    ref: object
    port: object
    kind: str  # "dl", "mimo" or "ul"

    def window(self, mix, soft_ref=None, soft_port=None):
        samples = np.stack([m[0] for m in mix])
        sfs = [m[1] for m in mix]
        grants = [m[2] for m in mix]
        stages, pack_ref = self.ref._plan(samples, sfs, grants, soft_ref)
        outs, prev = {}, None
        for name, fn in stages:
            prev = outs[name] = fn(prev)
        stages_t, pack = self.port._plan(samples, sfs, [from_reference(g) for g in grants], soft_port)
        return dict(mix=mix, samples=samples, sfs=sfs, grants=grants, ref=outs, pack_ref=pack_ref,
                    port_stages=dict(stages_t), pack=pack)

    def a_to_port(self, a_ref):
        """The reference's stage A output as the port's stage B takes it."""
        if self.kind == "ul":
            return ri2c(a_ref)
        return ri2c(a_ref[0]), ri2c(a_ref[1]), torch.from_numpy(np.array(a_ref[2]))

    def ref_rows(self, packed, tbs):
        """The reference's packed buffer as [(tb, ok, n_it)] per row."""
        return self.port._rows(t_pw.PendingWindow(torch.from_numpy(np.array(packed)), None, tbs))


def make_engines(kind, cell, iters, **kw):
    cls = {"dl": "WindowedUeDl", "mimo": "WindowedUeDlMimo", "ul": "WindowedEnbUl"}[kind]
    args = (cell,) if kind == "ul" else (cell, 1)
    ref = getattr(r_pw, cls)(*args, w=W, max_iterations=iters, **kw)
    port_args = (from_reference(cell),) + args[1:]
    port = getattr(t_pw, cls)(*port_args, w=W, max_iterations=iters, device="cpu", **kw)
    return Engines(ref, port, kind)


CELL50 = Cell(nof_prb=50, nof_ports=1, id=17)


@pytest.fixture(scope="module")
def dl_engines():
    return make_engines("dl", CELL50, 4)


@pytest.fixture(scope="module")
def ul_engines():
    return make_engines("ul", CELL50, 3)


@pytest.fixture(scope="module")
def windows(dl_engines, ul_engines):
    """One window per engine kind, with the reference's stage outputs."""
    div_cell = Cell(nof_prb=25, nof_ports=2, id=7)
    h_div = np.array([[0.9 + 0.3j, -0.5 + 0.7j]], np.complex64)  # 1 rx x 2 tx
    div = make_engines("dl", div_cell, 3, scheme="diversity")
    mimo_cell = Cell(nof_prb=25, nof_ports=2, id=77)
    mimo = make_engines("mimo", mimo_cell, 4)
    return {
        "port0": (dl_engines, dl_engines.window(dl_mix(CELL50, np.random.default_rng(7), W))),
        "diversity": (div, div.window(dl_mix(div_cell, np.random.default_rng(21), W,
                                             tx_scheme="diversity", h=h_div, mcs_range=(2, 20)))),
        "mimo": (mimo, mimo.window(mimo_mix(mimo_cell, np.random.default_rng(31)))),
        "ul": (ul_engines, ul_engines.window(ul_mix(CELL50, np.random.default_rng(9)))),
        "ul_same_tti": (ul_engines, ul_engines.window(ul_same_tti(CELL50, np.random.default_rng(3)))),
    }


KINDS = ["port0", "diversity", "mimo", "ul", "ul_same_tti"]


@pytest.mark.parametrize("kind", KINDS)
def test_pack_and_key_equal(windows, kind):
    _eng, win = windows[kind]
    assert win["pack"].key == win["pack_ref"].key
    np.testing.assert_array_equal(win["pack"].params, win["pack_ref"].params)


@pytest.mark.parametrize("kind", KINDS)
def test_stage_a(windows, kind):
    eng, win = windows[kind]
    got = win["port_stages"]["A"](None)
    want = eng.a_to_port(win["ref"]["A"])
    if eng.kind == "ul":
        got, want = (got,), (want,)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert rel_err(g.numpy(), r.numpy()) <= LLR_RTOL


@pytest.mark.parametrize("kind", KINDS)
def test_stage_b_on_reference_front_end(windows, kind):
    eng, win = windows[kind]
    got = win["port_stages"]["B"](eng.a_to_port(win["ref"]["A"])).numpy()
    ref = np.asarray(win["ref"]["B"])
    assert got.shape == ref.shape == (win["pack"].key[0], t_pw.G_MAX) and got.dtype == np.float32
    assert rel_err(got, ref) <= LLR_RTOL
    # each row is zero from its codeword length (the sum of its slots' e) on
    pack = win["pack"]
    e = pack.params[pack.key[1]:2 * pack.key[1]]
    for row, (st, ncb) in enumerate(zip(pack.row_start, pack.row_ncb)):
        n_bits = e[st:st + ncb].sum()
        assert not got[row, n_bits:].any() and got[row, :n_bits].any(), row


@pytest.mark.parametrize("kind", KINDS)
def test_stage_c_on_reference_llrs(windows, kind):
    """Stage C alone, on the reference's stage B output: the packed buffer
    is identical and the softbuffer within SOFT_RTOL."""
    _eng, win = windows[kind]
    packed, soft = win["port_stages"]["C"](torch.from_numpy(np.array(win["ref"]["B"])))
    ref_packed, ref_soft = win["ref"]["C"]
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_packed))
    assert soft.shape == ref_soft.shape and rel_err(soft.numpy(), ref_soft) <= SOFT_RTOL


def check_window(eng, win, res, want_ok=None):
    """The port's results of a window against the reference's and the sent
    TBs: identical ok and n_it, identical bits where ok; a CRC-passing TB is
    the sent one.  Returns the per-row ok flags."""
    ref_rows = eng.ref_rows(win["ref"]["C"][0], win["pack_ref"].tbs)
    if eng.kind == "mimo":
        rows = [r for (t1, o1), (t2, o2), _n in res for r in ((t1, o1), (t2, o2))]
        assert [n for _a, _b, n in res] == [max(a[2], b[2]) for a, b in zip(ref_rows[0::2], ref_rows[1::2])]
        sent = [tb for m in win["mix"] for tb in m[3]]
    else:
        rows = [(tb, ok) for tb, ok, _n in res]
        assert [n for _tb, _ok, n in res] == [n for _tb, _ok, n in ref_rows]
        sent = [m[3] for m in win["mix"]]
    oks = [ok for _tb, ok in rows]
    assert oks == [ok for _tb, ok, _n in ref_rows]
    for (tb, ok), (tb_ref, _ok, _n), tb_sent in zip(rows, ref_rows, sent):
        assert tb.shape == tb_sent.shape and tb.dtype == np.uint8
        if ok:
            np.testing.assert_array_equal(tb, tb_ref)
            np.testing.assert_array_equal(tb, tb_sent)
    if want_ok is not None:
        assert oks == want_ok
    return oks


@pytest.mark.parametrize("kind", KINDS)
def test_window_as_a_whole(windows, kind):
    """`decode_window` of the port on the same samples: every TB passes and
    equals the reference's and the sent one."""
    eng, win = windows[kind]
    grants = [from_reference(g) for g in win["grants"]]
    before = dict(eng.port.stats)
    p = eng.port.dispatch_window(win["samples"], win["sfs"], grants)
    assert p.pack.key == win["pack_ref"].key and p.tbs == win["pack_ref"].tbs
    assert p.packed.shape == (p.pack.key[8] + p.pack.key[6] + 2,)
    res = eng.port.results(p)
    n_rows = len(win["pack_ref"].tbs)
    check_window(eng, win, res, want_ok=[True] * n_rows)
    assert rel_err(p.softbuffer.numpy(), win["ref"]["C"][1]) <= SOFT_RTOL
    assert eng.port.stats["windows"] == before["windows"] + 1
    assert eng.port.stats["ttis"] == before["ttis"] + W
    assert eng.port.stats["crc_ok"] == before["crc_ok"] + W


def test_second_window_reuses_the_stage_functions(dl_engines):
    """A fresh random mix through the same engine: the same stage A and B
    functions, a stage C per occupancy bucket."""
    eng = dl_engines
    win = eng.window(dl_mix(CELL50, np.random.default_rng(8), W))
    a_fn, b_cache = eng.port._a, dict(eng.port._b_cache)
    res, _soft = eng.port.decode_window(win["samples"], win["sfs"],
                                        [from_reference(g) for g in win["grants"]])
    check_window(eng, win, res, want_ok=[True] * W)
    assert eng.port._a is a_fn
    assert all(eng.port._b_cache[k] is v for k, v in b_cache.items())
    assert len(eng.port._b_cache) <= 2 * 4


def test_harq_combining_dense_carry(dl_engines):
    """rv 0 in heavy noise fails; rv 2 combined through the window's dense
    softbuffer (the same codeblock layout) passes."""
    eng = dl_engines
    rng = np.random.default_rng(5)
    tb = rng.integers(0, 2, dl_tbs(16, 15)).astype(np.uint8)
    filler = dl_mix(CELL50, rng, W - 1)
    win0 = eng.window([harq_tx(CELL50, rng, tb, 0, 2)] + filler)
    grants0 = [from_reference(g) for g in win0["grants"]]
    res0, soft0 = eng.port.decode_window(win0["samples"], win0["sfs"], grants0)
    check_window(eng, win0, res0, want_ok=[False, True, True, True])
    ref_soft0 = win0["ref"]["C"][1]
    assert rel_err(soft0.numpy(), ref_soft0) <= SOFT_RTOL

    win2 = eng.window([harq_tx(CELL50, rng, tb, 2, 3)] + filler, soft_ref=ref_soft0,
                      soft_port=softbuffer_from_reference(ref_soft0, "cpu"))
    res2, _ = eng.port.decode_window(win2["samples"], win2["sfs"],
                                     [from_reference(g) for g in win2["grants"]], softbuffer=soft0)
    check_window(eng, win2, res2, want_ok=[True] * W)
    with pytest.raises(ValueError, match="layout"):
        eng.port.dispatch_window(win2["samples"], win2["sfs"], grants0, softbuffer=soft0[:-1])


def test_harq_cross_window_routing(dl_engines):
    """A retransmission lands in a later window at another row:
    `extract_softbuffer` / `make_softbuffer` route the HARQ state."""
    eng = dl_engines
    rng = np.random.default_rng(6)
    tb = rng.integers(0, 2, dl_tbs(16, 15)).astype(np.uint8)
    f1 = dl_mix(CELL50, rng, W - 1)
    win1 = eng.window([f1[0], harq_tx(CELL50, rng, tb, 0, 2)] + f1[1:])
    p1 = eng.port.dispatch_window(win1["samples"], win1["sfs"],
                                  [from_reference(g) for g in win1["grants"]])
    check_window(eng, win1, eng.port.results(p1), want_ok=[True, False, True, True])
    carry = t_pw.extract_softbuffer(p1, 1)
    ref_p1 = r_pw.PendingWindow(win1["ref"]["C"][0], win1["ref"]["C"][1], win1["pack_ref"].tbs,
                                win1["pack_ref"])
    ref_carry = r_pw.extract_softbuffer(ref_p1, 1)
    assert carry.shape == (t_pw.MAX_CB, 3, t_pw.K_MAX + 4)
    assert rel_err(carry.numpy(), ref_carry) <= SOFT_RTOL
    assert not carry[p1.pack.row_ncb[1]:].any()

    f2 = dl_mix(CELL50, rng, W - 1)
    win2 = eng.window(f2 + [harq_tx(CELL50, rng, tb, 2, 5)],
                      soft_ref=r_pw.make_softbuffer([None, None, None, ref_carry]),
                      soft_port=t_pw.make_softbuffer([None, None, None, carry]))
    res2, _ = eng.port.decode_window(
        win2["samples"], win2["sfs"], [from_reference(g) for g in win2["grants"]],
        softbuffer=t_pw.make_softbuffer([None, None, None, carry]))
    check_window(eng, win2, res2, want_ok=[True] * W)


def test_dispatch_window_from_stored_front_end(dl_engines, ul_engines):
    """The data pass on a stored stage A output skips the upload and the
    FFT, and gives the window's results."""
    for eng, mix in ((dl_engines, dl_mix(CELL50, np.random.default_rng(12), W)),
                     (ul_engines, ul_mix(CELL50, np.random.default_rng(13)))):
        win = eng.window(mix)
        grants = [from_reference(g) for g in win["grants"]]
        abc = win["port_stages"]["A"](None)
        p = eng.port.dispatch_window_from(abc, win["sfs"], grants)
        check_window(eng, win, eng.port.results(p), want_ok=[True] * W)
        times = eng.port.stage_times(win["samples"], win["sfs"], grants, n=1)
        assert list(times) == ["A", "B", "C"] and all(t > 0 for t in times.values())


def test_window_reduced_rate():
    """A window at 50 PRB on the 768-point grid of the reduced sample rate
    (`use_standard_rates=False`), held to the reference stage by stage and
    as a whole."""
    cell = Cell(nof_prb=50, nof_ports=1, id=17, use_standard_rates=False)
    assert cell.symbol_sz == 768
    eng = make_engines("dl", cell, 3)
    win = eng.window(dl_mix(cell, np.random.default_rng(47), W))
    for got, want in zip(win["port_stages"]["A"](None), eng.a_to_port(win["ref"]["A"])):
        assert got.shape == want.shape and rel_err(got.numpy(), want.numpy()) <= LLR_RTOL
    res, soft = eng.port.decode_window(win["samples"], win["sfs"],
                                       [from_reference(g) for g in win["grants"]])
    check_window(eng, win, res, want_ok=[True] * W)
    assert rel_err(soft.numpy(), win["ref"]["C"][1]) <= SOFT_RTOL


def test_int16_ingest_window():
    eng = make_engines("dl", Cell(nof_prb=25, nof_ports=1, id=5), 2, ingest="int16")
    win = eng.window(dl_mix(eng.ref.cell, np.random.default_rng(11), W))
    res, _ = eng.port.decode_window(win["samples"], win["sfs"],
                                    [from_reference(g) for g in win["grants"]])
    check_window(eng, win, res, want_ok=[True] * W)


# --- the device contract ------------------------------------------------------------


@pytest.mark.parametrize("cls", ["WindowedUeDl", "WindowedUeDlMimo", "WindowedEnbUl"])
def test_constructors_take_the_card_by_default(cls):
    cell = from_reference(Cell(nof_prb=6, nof_ports=2 if cls == "WindowedUeDlMimo" else 1, id=1))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(t_pw, cls)(cell, w=2)
    assert getattr(t_pw, cls)(cell, w=2, device="cpu").device == torch.device("cpu")


def cpu_sharding(n):
    mesh = carrier_mesh(devices=["cpu"] * n)
    return NamedSharding(mesh, PartitionSpec("carriers"))


def scaling_mix(rng, w=8):
    """`tests/test_scaling.py`'s window: 15 PRB, MCS 2-8 over the subframe
    indices, noise 0.02."""
    cell = Cell(nof_prb=15, nof_ports=1, id=11)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    mix = []
    for i in range(w):
        mcs = 2 + (i % 7)
        g = DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, 15), rnti=0x46)
        tb = rng.integers(0, 2, g.tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, i % 10, 1, g, tb)
        put_crs_np(grid, cell, i % 10)
        mix.append((awgn(rng, np.asarray(ofdm_tx_sf(ofdm, grid)), 0.02), i % 10, g, tb))
    return cell, mix


def assert_same_window(a, b):
    assert torch.equal(a.packed, b.packed) and torch.equal(a.softbuffer, b.softbuffer)
    assert a.tbs == b.tbs


def test_sharding_and_bad_arguments_raise(dl_engines):
    """A sharded dispatch (8 positions of the CPU, one row of int8 ingest
    each) is bit for bit the unsharded one: the packed results and the
    softbuffer; then the bad arguments raise."""
    ue = dl_engines.port
    cell, mix8 = scaling_mix(np.random.default_rng(1))
    samples8, sfs8 = np.stack([m[0] for m in mix8]), [m[1] for m in mix8]
    grants8 = [from_reference(m[2]) for m in mix8]
    eng = t_pw.WindowedUeDl(from_reference(cell), w=8, max_iterations=3, device="cpu")
    plain = eng.dispatch_window(samples8, sfs8, grants8)
    assert_same_window(eng.dispatch_window(samples8, sfs8, grants8, sharding=cpu_sharding(8)), plain)
    assert all(ok for _tb, ok, _n in eng.results(plain))
    mix = dl_mix(CELL50, np.random.default_rng(1), W)
    samples, sfs = np.stack([m[0] for m in mix]), [m[1] for m in mix]
    grants = [from_reference(m[2]) for m in mix]
    with pytest.raises(ValueError, match="window takes"):
        ue.dispatch_window(samples[:2], sfs[:2], grants[:2])
    with pytest.raises(ValueError, match="scheme"):
        t_pw.WindowedUeDl(ue.cell, scheme="spatialmux", device="cpu")
    with pytest.raises(ValueError, match="ingest"):
        t_pw.WindowedEnbUl(ue.cell, ingest="int4", device="cpu")


def test_enb_ul_refuses_sharding(ul_engines):
    win = ul_mix(CELL50, np.random.default_rng(9))
    with pytest.raises(NotImplementedError, match="WindowedEnbUl does not shard"):
        ul_engines.port.dispatch_window(np.stack([m[0] for m in win]), [m[1] for m in win],
                                        [from_reference(m[2]) for m in win],
                                        sharding=cpu_sharding(4))


@pytest.mark.parametrize("kind", ["port0", "diversity", "mimo"])
def test_sharded_window_bit_exact(windows, kind):
    """W = 4 over 4 positions of the CPU: port-0, 2-port diversity (two CRS
    estimates a row) and MIMO, which accepts a sharding and ignores it as
    the reference does; each bit for bit the unsharded dispatch."""
    eng, win = windows[kind]
    grants = [from_reference(g) for g in win["grants"]]
    plain = eng.port.dispatch_window(win["samples"], win["sfs"], grants)
    sharded = eng.port.dispatch_window(win["samples"], win["sfs"], grants, sharding=cpu_sharding(4))
    assert_same_window(sharded, plain)


def test_windowed_plane_sharded_bit_exact():
    """`tests/test_scaling.py::test_windowed_plane_sharded_bit_exact` on the
    port beside the reference: the reference's window sharded over JAX's 8
    virtual devices and the port's over 8 positions of the CPU decode every
    TB to the sent bits, and the port's sharded window is bit for bit its
    unsharded one (float32 ingest, as there)."""
    import jax
    from jax.sharding import Mesh, NamedSharding as JNamedSharding, PartitionSpec as JP

    cell, mix = scaling_mix(np.random.default_rng(5))
    samples, sfs = np.stack([m[0] for m in mix]), [m[1] for m in mix]
    ref = r_pw.WindowedUeDl(cell, cfi=1, w=8, ingest="float32")
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("carriers",))
    res_ref = ref.results(ref.dispatch_window(samples, sfs, [m[2] for m in mix],
                                              sharding=JNamedSharding(mesh, JP("carriers"))))
    port = t_pw.WindowedUeDl(from_reference(cell), cfi=1, w=8, ingest="float32", device="cpu")
    grants = [from_reference(m[2]) for m in mix]
    sharded = port.dispatch_window(samples, sfs, grants, sharding=cpu_sharding(8))
    assert_same_window(sharded, port.dispatch_window(samples, sfs, grants))
    for (tb_p, ok_p, n_p), (tb_r, ok_r, n_r), m in zip(port.results(sharded), res_ref, mix):
        assert ok_p and ok_r and n_p == n_r
        assert np.array_equal(tb_p, tb_r) and np.array_equal(tb_p, m[3])


def test_window_with_high_repetition(dl_engines):
    """A tiny TB on a wide allocation repeats 27 times: the fold takes its
    11 log-halving steps (j_fold 11), as for SIB- or paging-style grants."""
    eng = dl_engines
    rng = np.random.default_rng(14)
    mix = dl_mix(CELL50, rng, W - 1)
    grant = DlGrant(prb=tuple(range(5, 30)), mod=dl_mcs_to_mod(0), tbs=40, rnti=0x46)
    tb = rng.integers(0, 2, 40).astype(np.uint8)
    grid = pdsch_encode_np(CELL50, 3, 1, grant, tb)
    put_crs_np(grid, CELL50, 3)
    tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(CELL50, normalize=True), grid))
    win = eng.window(mix[:2] + [(awgn(rng, tx, 0.3), 3, grant, tb)] + mix[2:])
    assert win["pack"].key == win["pack_ref"].key and win["pack"].key[5] == 11
    res, soft = eng.port.decode_window(win["samples"], win["sfs"],
                                       [from_reference(g) for g in win["grants"]])
    check_window(eng, win, res, want_ok=[True] * W)
    assert rel_err(soft.numpy(), win["ref"]["C"][1]) <= SOFT_RTOL


def test_window_largest_tb_int16_ingest():
    """The largest LTE TB (256QAM MCS 27 on 100 PRB: tbs 97896, 16 codeblocks
    of K = 6144) through a W = 2 window with int16 ingest: MAX_CB slots a
    row, the widest reassembly table and packed rows."""
    from srsran_tpu.phy.modem import Mod

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    rng = np.random.default_rng(41)
    tbs = dl_tbs(27, 100, use_256qam=True)
    assert tbs == 97896
    grant = DlGrant(prb=tuple(range(100)), mod=Mod.QAM256, tbs=tbs, rnti=0x46)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    mix = []
    for sf_idx in (2, 7):
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
        put_crs_np(grid, cell, sf_idx)
        mix.append((awgn(rng, np.asarray(ofdm_tx_sf(ofdm, grid)), 0.005), sf_idx, grant, tb))
    ref = r_pw.WindowedUeDl(cell, cfi=1, w=2, max_iterations=3, ingest="int16")
    port = t_pw.WindowedUeDl(from_reference(cell), cfi=1, w=2, max_iterations=3, ingest="int16",
                             device="cpu")
    eng = Engines(ref, port, "dl")
    win = eng.window(mix)
    assert win["pack"].key == win["pack_ref"].key
    assert win["pack"].row_ncb == [16, 16] and win["pack"].key[6] == t_pw.TB_BYTES
    res, soft = port.decode_window(win["samples"], win["sfs"],
                                   [from_reference(g) for g in win["grants"]])
    check_window(eng, win, res, want_ok=[True, True])
    assert rel_err(soft.numpy(), win["ref"]["C"][1]) <= SOFT_RTOL


def test_device_resident_ingest(dl_engines):
    """A complex tensor on the engine's device is decoded as it is (no
    quantisation), like the reference on its device-resident ingest (a
    (W, nrx, sf_len, 2) float32 array): identical ok, n_it and bits, a
    softbuffer within SOFT_RTOL; a tensor that is not complex is refused."""
    eng = dl_engines
    mix = dl_mix(CELL50, np.random.default_rng(15), W)
    samples_np = np.stack([m[0] for m in mix])
    sfs, grants = [m[1] for m in mix], [m[2] for m in mix]
    p_ref = eng.ref.dispatch_window(
        jnp.asarray(np.stack([samples_np.real, samples_np.imag], axis=-1)), sfs, grants)
    samples = torch.from_numpy(samples_np)
    p = eng.port.dispatch_window(samples, sfs, [from_reference(g) for g in grants])
    assert p.pack.key == p_ref.pack.key
    win = dict(mix=mix, ref={"C": (p_ref.packed, p_ref.softbuffer)}, pack_ref=p_ref.pack)
    check_window(eng, win, eng.port.results(p), want_ok=[True] * W)
    assert rel_err(p.softbuffer.numpy(), p_ref.softbuffer) <= SOFT_RTOL
    with pytest.raises(ValueError, match="complex"):
        eng.port.dispatch_window(samples.real, sfs, [from_reference(g) for g in grants])
