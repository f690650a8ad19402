"""The committed stimulus fixtures of the port are what
`tools/make_torch_fixture.py` builds from the JAX reference, and the port
decodes what they store as the reference did: the two noisy subframes of
the static path (100 PRB MCS 26), the grants of the dynamic path, and the
2x2 MIMO, eNB UL and dynamic eNB UL ones, and the stored window of each
windowed decode engine."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch.pdsch import DlGrant
from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
from srsran_tpu_torch.phy.phch.pdsch import DlGrant2
from srsran_tpu_torch.phy.phch.pusch import UlGrant
from srsran_tpu_torch.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
from srsran_tpu_torch.pipeline import enb_ul_subframe, ue_dl_subframe, ue_dl_subframe_mimo
from srsran_tpu_torch.pipeline_dynamic import DynamicEnbUl, DynamicUeDl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", ROOT / "tools" / "make_torch_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_is_current():
    tool = load_tool()
    fx = np.load(tool.OUT)
    for key, val in tool.CONFIG.items():
        assert fx[key] == val, key
    tb, tx = tool.clean_tx()
    assert int(fx["tbs"]) == tb.size == 61664
    np.testing.assert_array_equal(np.unpackbits(fx["tb_packed"], count=tb.size), tb)
    # the reference's IFFT in complex64: equal up to its float32 rounding
    assert fx["tx"].dtype == np.complex64 and fx["tx"].shape == tx.shape == (30720,)
    np.testing.assert_allclose(fx["tx"], tx, rtol=0, atol=1e-6)
    assert fx["rx"].shape == (2, 1, 30720) and fx["ref_crc_ok"].shape == (2,)


def test_port_decodes_fixture_like_reference():
    fx = np.load(ROOT / "srsran_tpu_torch" / "testdata" / "ue_dl_siso_20mhz.npz")
    tbs = int(fx["tbs"])
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=1, id=int(fx["cell_id"]))
    grant = DlGrant(prb=tuple(range(cell.nof_prb)), mod=Mod.QAM64, tbs=tbs)
    fn = ue_dl_subframe(cell, int(fx["sf_idx"]), int(fx["cfi"]), grant,
                        int(fx["max_iterations"]), device="cpu")
    tb, ok, snr_db = fn(torch.from_numpy(fx["rx"]))
    np.testing.assert_array_equal(
        tb.numpy(), np.unpackbits(fx["ref_tb_packed"], axis=-1, count=tbs))
    np.testing.assert_array_equal(ok.numpy(), fx["ref_crc_ok"])
    np.testing.assert_allclose(snr_db.numpy(), fx["ref_snr_db"], atol=1e-3)


def test_dynamic_fixture_is_current():
    tool = load_tool()
    fd = np.load(tool.OUT_DYN)
    for key, val in tool.DYN_CONFIG.items():
        assert fd[key] == val, key
    n = len(tool.DYN_GRANTS)
    cols = np.stack([fd[k] for k in ("mcs", "prb_start", "prb_len", "sf_idx", "noise_amp")], axis=1)
    np.testing.assert_array_equal(cols, np.asarray(tool.DYN_GRANTS))
    assert fd["rx"].shape == (n, 1, 30720) and fd["rx"].dtype == np.complex64
    assert fd["ref_crc_ok"].tolist() == [True, True, True, False]
    assert fd["ref_n_it"].tolist() == [3, 2, 1, 6]
    # the stored subframe is the reference's rendering of the seeded TB plus
    # the seeded noise; a CRC-passing reference TB is the sent one
    for i in (1, 2):
        grant, tb, tx = tool.dynamic_grant(i)
        assert int(fd["tbs"][i]) == grant.tbs == tb.size
        np.testing.assert_array_equal(np.unpackbits(fd["ref_tb_packed"][i], count=tb.size), tb)
        rng = np.random.default_rng(tool.DYN_CONFIG["seed"] + 100 + i)
        noise = rng.standard_normal((1, tx.size)) + 1j * rng.standard_normal((1, tx.size))
        np.testing.assert_allclose(fd["rx"][i], tx[None, :] + tool.DYN_GRANTS[i][4] * noise,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_port_decodes_dynamic_fixture_like_reference(i):
    fd = np.load(ROOT / "srsran_tpu_torch" / "testdata" / "ue_dl_dynamic_20mhz.npz")
    cell = Cell(nof_prb=int(fd["nof_prb"]), nof_ports=1, id=int(fd["cell_id"]))
    ue = DynamicUeDl(cell, cfi=int(fd["cfi"]), max_iterations=int(fd["max_iterations"]),
                     device="cpu")
    l, s0, mcs = int(fd["prb_len"][i]), int(fd["prb_start"][i]), int(fd["mcs"][i])
    grant = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                    rnti=int(fd["rnti"]))
    assert grant.tbs == int(fd["tbs"][i])
    tb, ok, _, n_it = ue.decode(fd["rx"][i], int(fd["sf_idx"][i]), grant)
    assert (ok, n_it) == (bool(fd["ref_crc_ok"][i]), int(fd["ref_n_it"][i]))
    if ok:  # a decode that does not converge has no bits to hold
        np.testing.assert_array_equal(tb, np.unpackbits(fd["ref_tb_packed"][i], count=grant.tbs))


TESTDATA = ROOT / "srsran_tpu_torch" / "testdata"


def test_new_fixtures_stay_small():
    names = ("ue_dl_mimo_20mhz.npz", "enb_ul_20mhz.npz", "enb_ul_dynamic_20mhz.npz")
    assert sum((TESTDATA / n).stat().st_size for n in names) < 3 * 2**20


def test_mimo_fixture_is_current():
    tool = load_tool()
    fx = np.load(tool.OUT_MIMO)
    for key, val in tool.MIMO_CONFIG.items():
        assert fx[key] == val, key
    _cell, grant, tb1, tb2, clean = tool.mimo_clean_rx()
    assert int(fx["tbs"]) == grant.tbs1 == grant.tbs2 == 61664
    np.testing.assert_array_equal(np.unpackbits(fx["tb1_packed"], count=tb1.size), tb1)
    np.testing.assert_array_equal(np.unpackbits(fx["tb2_packed"], count=tb2.size), tb2)
    assert fx["rx"].shape == (2, 2, 30720) and fx["rx"].dtype == np.complex64
    want = tool.awgn(tool.MIMO_CONFIG["seed"] + 1, np.tile(clean[None], (2, 1, 1)),
                     tool.MIMO_CONFIG["noise_amp"])
    np.testing.assert_allclose(fx["rx"], want, rtol=0, atol=2e-6)
    assert fx["ref_crc_ok"].tolist() == [[True, True], [True, True]]
    # a CRC-passing reference TB is the sent one
    np.testing.assert_array_equal(np.unpackbits(fx["ref_tb1_packed"], axis=-1, count=tb1.size),
                                  np.stack([tb1, tb1]))


def test_port_decodes_mimo_fixture_like_reference():
    fx = np.load(TESTDATA / "ue_dl_mimo_20mhz.npz")
    tbs, nof_prb = int(fx["tbs"]), int(fx["nof_prb"])
    cell = Cell(nof_prb=nof_prb, nof_ports=2, id=int(fx["cell_id"]))
    grant = DlGrant2(prb=tuple(range(nof_prb)), mod1=Mod.QAM64, tbs1=tbs, mod2=Mod.QAM64, tbs2=tbs,
                     pmi=int(fx["pmi"]))
    fn = ue_dl_subframe_mimo(cell, int(fx["sf_idx"]), int(fx["cfi"]), grant,
                             int(fx["max_iterations"]), device="cpu")
    (tb1, ok1), (tb2, ok2), snr_db = fn(torch.from_numpy(fx["rx"]))
    for q, (tb, ok) in enumerate(((tb1, ok1), (tb2, ok2))):
        np.testing.assert_array_equal(ok.numpy(), fx["ref_crc_ok"][:, q])
        np.testing.assert_array_equal(
            tb.numpy(), np.unpackbits(fx[f"ref_tb{q + 1}_packed"], axis=-1, count=tbs))
    np.testing.assert_allclose(snr_db.numpy(), fx["ref_snr_db"], atol=1e-3)


def ul_grant(mcs, prb_start, nof_prb, rnti):
    return UlGrant(prb_start=prb_start, nof_prb=nof_prb, mod=ul_mcs_to_mod(mcs),
                   tbs=tbs_lookup(ul_mcs_to_itbs(mcs), nof_prb), rnti=rnti)


def test_ul_fixtures_are_current():
    tool = load_tool()
    fx = np.load(tool.OUT_UL)
    c = tool.UL_CONFIG
    for key, val in c.items():
        assert fx[key] == val, key
    grant = tool.ul_grant(c["mcs"], c["prb_start"], c["nof_prb_alloc"], c["rnti"])
    _cell, tb, tx = tool.ul_clean_tx(c["seed"], c["cell_id"], c["nof_prb"], c["sf_idx"], grant)
    assert int(fx["tbs"]) == grant.tbs == 40576
    np.testing.assert_array_equal(np.unpackbits(fx["tb_packed"], count=tb.size), tb)
    want = tool.awgn(c["seed"] + 1, np.tile(tx[None, None, :], (2, 1, 1)), c["noise_amp"])
    assert fx["rx"].shape == (2, 1, 30720) and fx["rx"].dtype == np.complex64
    np.testing.assert_allclose(fx["rx"], want, rtol=0, atol=2e-6)
    assert fx["ref_crc_ok"].tolist() == [True, True]

    fd = np.load(tool.OUT_UL_DYN)
    for key, val in tool.UL_DYN_CONFIG.items():
        assert fd[key] == val, key
    cols = np.stack([fd[k] for k in ("mcs", "prb_start", "prb_len", "sf_idx", "noise_amp")], axis=1)
    np.testing.assert_array_equal(cols, np.asarray(tool.UL_DYN_GRANTS))
    assert fd["ref_crc_ok"].tolist() == [True, True] and fd["ref_n_it"].tolist() == [1, 3]
    for i in range(len(tool.UL_DYN_GRANTS)):
        _cell, grant, tb, rx = tool.ul_dynamic_grant(i)
        assert int(fd["tbs"][i]) == grant.tbs
        np.testing.assert_array_equal(np.unpackbits(fd["ref_tb_packed"][i], count=tb.size), tb)
        np.testing.assert_allclose(fd["rx"][i], rx, rtol=0, atol=2e-6)


def test_port_decodes_ul_fixture_like_reference():
    fx = np.load(TESTDATA / "enb_ul_20mhz.npz")
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=1, id=int(fx["cell_id"]))
    grant = ul_grant(int(fx["mcs"]), int(fx["prb_start"]), int(fx["nof_prb_alloc"]), int(fx["rnti"]))
    fn = enb_ul_subframe(cell, int(fx["sf_idx"]), grant, int(fx["max_iterations"]), device="cpu")
    tb, ok, snr_db = fn(torch.from_numpy(fx["rx"]))
    np.testing.assert_array_equal(ok.numpy(), fx["ref_crc_ok"])
    np.testing.assert_array_equal(
        tb.numpy(), np.unpackbits(fx["ref_tb_packed"], axis=-1, count=grant.tbs))
    np.testing.assert_allclose(snr_db.numpy(), fx["ref_snr_db"], atol=1e-3)


@pytest.mark.parametrize("i", [0, 1])
def test_port_decodes_ul_dynamic_fixture_like_reference(i):
    fd = np.load(TESTDATA / "enb_ul_dynamic_20mhz.npz")
    cell = Cell(nof_prb=int(fd["nof_prb"]), nof_ports=1, id=int(fd["cell_id"]))
    enb = DynamicEnbUl(cell, max_iterations=int(fd["max_iterations"]), device="cpu")
    grant = ul_grant(int(fd["mcs"][i]), int(fd["prb_start"][i]), int(fd["prb_len"][i]),
                     int(fd["rnti"]))
    assert grant.tbs == int(fd["tbs"][i])
    tb, ok, _, n_it = enb.decode(fd["rx"][i], int(fd["sf_idx"][i]), grant)
    assert (ok, n_it) == (bool(fd["ref_crc_ok"][i]), int(fd["ref_n_it"][i]))
    np.testing.assert_array_equal(tb, np.unpackbits(fd["ref_tb_packed"][i], count=grant.tbs))


# --- the stored windows of the windowed decode engines ---------------------------

WINDOW_KINDS = ["ue_dl", "ue_dl_mimo", "enb_ul"]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_window_fixtures_stay_small():
    assert sum((TESTDATA / f"window_{k}_20mhz.npz").stat().st_size for k in WINDOW_KINDS) < 2 * 2**20


@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_window_fixture_is_current(kind):
    """Rendering the window again gives what is stored: the int8 pairs (the
    reference's IFFT rounds in float32, so a sample on a quantisation step's
    edge may land one step away: at most 1 in 10,000 does), the scales, the
    sent TBs and the configuration; the stimulus quantises to the stored
    bytes in the port's ingest."""
    from srsran_tpu_torch.pipeline_window import _quantize_ingest

    tool = load_tool()
    fx = np.load(tool.OUT_WIN[kind])
    for key, val in tool.WIN_CONFIG.items():
        assert fx[key] == val, key
    np.testing.assert_array_equal(fx["grant_rows"], np.asarray(tool.WIN_GRANTS[kind], np.float64))
    _cell, sfs, grants, tbs, q, scale = tool.window_stimulus(kind)
    assert fx["q"].dtype == np.int8 and fx["q"].shape == q.shape == (
        4, 2 if kind == "ue_dl_mimo" else 1, 30720, 2)
    step = np.abs(fx["q"].astype(np.int16) - q)
    assert step.max() <= 1 and np.count_nonzero(step) <= 1e-4 * q.size
    np.testing.assert_allclose(fx["scale"], scale, rtol=1e-6)
    sent = [t for pair in tbs for t in pair] if kind == "ue_dl_mimo" else tbs
    assert fx["tbs"].tolist() == [t.size for t in sent]
    for i, t in enumerate(sent):
        np.testing.assert_array_equal(np.unpackbits(fx["tb_packed"][i], count=t.size), t)
    q2, scale2 = _quantize_ingest(tool.window_samples(fx["q"], fx["scale"]), "int8")
    assert q2.tobytes() == fx["q"].tobytes()
    np.testing.assert_allclose(scale2, fx["scale"], rtol=2e-7)
    # a CRC-passing reference TB is the sent one
    for i, ok in enumerate(fx["ref_crc_ok"]):
        if ok:
            np.testing.assert_array_equal(fx["ref_tb_packed"][i], fx["tb_packed"][i])
    assert sfs == [int(r[-3 if kind == "ue_dl_mimo" else -2]) for r in tool.WIN_GRANTS[kind]]
    assert len(grants) == 4


@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_port_decodes_window_fixture_like_reference(kind):
    smoke = load_smoke()
    fx, cell, sfs, grants, samples = smoke.stored_window(kind)
    np.testing.assert_array_equal(samples, load_tool().window_samples(fx["q"], fx["scale"]))
    eng = smoke.window_engine(kind, cell, int(fx["w"]), int(fx["max_iterations"]), device="cpu")
    p = eng.dispatch_window(samples, sfs, grants)
    rows, n_it = smoke.window_rows(kind, eng.results(p))
    assert list(p.pack.key) == fx["ref_key"].tolist()
    assert [ok for _tb, ok in rows] == fx["ref_crc_ok"].tolist()
    assert n_it == fx["ref_n_it"].tolist()
    for i, (tb, ok) in enumerate(rows):
        if ok:  # a decode that does not converge has no bits to hold
            np.testing.assert_array_equal(
                tb, np.unpackbits(fx["ref_tb_packed"][i], count=int(fx["tbs"][i])))


# --- the stored windows of the generate engines -----------------------------------

GEN_KINDS = ["enb_dl", "ue_ul", "enb_dl_mimo"]


def test_gen_window_fixtures_stay_small():
    assert sum((TESTDATA / f"window_gen_{k}.npz").stat().st_size for k in GEN_KINDS) < 1.5 * 2**20


@pytest.mark.parametrize("kind", GEN_KINDS)
def test_gen_window_fixture_is_current(kind):
    """The stored payloads, grants and overlay or PUCCH inputs are what the
    tool makes from its seed, and the stored reference codewords are the
    reference host DL-SCH encoder's of those payloads."""
    from srsran_tpu.phy.phch.sch import TbCoding, dlsch_encode_np

    tool = load_tool()
    fx = np.load(tool.OUT_GEN[kind])
    for key, val in tool.GEN_CONFIG.items():
        assert fx[key] == val, key
    np.testing.assert_array_equal(fx["grant_rows"], np.asarray(tool.GEN_GRANTS[kind]))
    _cell, sfs, _grants, payloads, kw, specs = tool.gen_window_stimulus(kind)
    assert fx["tbs"].tolist() == [p.size for p in payloads]
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(np.unpackbits(fx["tb_packed"][i], count=p.size), p)
    for name, arrays in kw.items():
        stored = (fx["ov_idx"], fx["ov_vals"]) if name == "overlay" else (
            fx["pucch_prb"], fx["pucch_grids"], fx["pucch_live"])
        for a, b in zip(stored, arrays):
            np.testing.assert_array_equal(a, b)
    cw = np.unpackbits(fx["ref_cw_packed"], axis=-1)
    for row, (tbs, g, qm, rv), p in zip(cw, specs, payloads):
        np.testing.assert_array_equal(row[:g], dlsch_encode_np(p, TbCoding(tbs=tbs, g=g, qm=qm, rv=rv)))
        assert not row[g:].any()
    assert fx["ref_samples"].dtype == np.complex64 and len(sfs) == fx["ref_samples"].shape[0]


@pytest.mark.parametrize("kind", GEN_KINDS)
def test_port_generates_gen_window_fixture_like_reference(kind):
    """Codewords identical, samples within 2e-6 absolute of the stored
    reference window, through the loader `chip_smoke.py` uses."""
    smoke = load_smoke()
    fx, cell, sfs, grants, payloads, kw = smoke.stored_gen_window(kind)
    eng = smoke.gen_engine(kind, cell, int(fx["w"]), device="cpu")
    n_diff, err = smoke.stored_gen_errors(eng, fx, sfs, grants, payloads, kw)
    assert n_diff == 0 and err <= smoke.SAMPLE_ATOL


# --- the stored control windows ----------------------------------------------------


def test_ctrl_window_fixtures_stay_small():
    assert sum((TESTDATA / f"window_ctrl_{k}.npz").stat().st_size for k in ("ue_dl", "enb_ul")) < 2**20


@pytest.mark.parametrize("kind", ["ue_dl", "enb_ul"])
def test_ctrl_window_fixture_is_current(kind):
    """Rendering the control window again gives what is stored: the int8
    pairs (at most 1 in 10,000 one step away, as for the decode windows),
    the scales, the subframes, the sent TBs, DCIs and PUCCH payloads and the
    configuration; a CRC-passing reference TB is the sent one."""
    tool = load_tool()
    fx = np.load(tool.OUT_CTRL[kind])
    for key, val in tool.CTRL_CONFIG.items():
        assert fx[key] == val, key
    np.testing.assert_array_equal(fx["grant_rows"], np.asarray(tool.CTRL_GRANTS[kind], np.float64))
    _cell, sfs, q, scale, ex = tool.ctrl_window_stimulus(kind)
    assert fx["q"].dtype == np.int8 and fx["q"].shape == q.shape == (4, 1, 30720, 2)
    step = np.abs(fx["q"].astype(np.int16) - q)
    assert step.max() <= 1 and np.count_nonzero(step) <= 1e-4 * q.size
    np.testing.assert_allclose(fx["scale"], scale, rtol=1e-6)
    assert fx["sfs"].tolist() == sfs
    for i, t in enumerate(ex["tbs"]):
        np.testing.assert_array_equal(np.unpackbits(fx["tb_packed"][i], count=t.size), t)
        if fx["ref_crc_ok"][i]:
            np.testing.assert_array_equal(fx["ref_tb_packed"][i], fx["tb_packed"][i])
    if kind == "ue_dl":
        for t, dcis in enumerate(ex["dcis"]):
            assert fx["sent_rnti"][t].tolist() == [r for _b, r, _a, _c in dcis]
            np.testing.assert_array_equal(fx["sent_bits"][t], np.stack([b for b, _r, _a, _c in dcis]))
        assert fx["sent_acks"].tolist() == ex["acks"] == fx["ref_phich"].astype(int).tolist()
    else:
        np.testing.assert_array_equal(fx["sent_f1"], np.stack(ex["f1"]))
        np.testing.assert_array_equal(fx["ref_f1_bits"], fx["sent_f1"])
        np.testing.assert_array_equal(fx["sent_f2"], np.stack(ex["f2"]))


@pytest.mark.parametrize("kind", ["ue_dl", "enb_ul"])
def test_port_decodes_ctrl_window_fixture_like_reference(kind):
    """Through the loader and the check `chip_smoke.py` phase 21 uses."""
    smoke = load_smoke()
    fx, _cell, _sfs, samples = smoke.stored_ctrl(kind)
    np.testing.assert_array_equal(samples[:, 0], load_tool().window_samples(fx["q"], fx["scale"])[:, 0])
    line = smoke.check_stored_ctrl(kind, fx, smoke.stored_ctrl_decode(kind, "cpu"))
    assert line.startswith(f"stored ctrl {kind}: W=4")


# --- the stored received frame (chip_smoke.py phase 23) ---------------------------


def test_ue_dl_frame_fixture_stays_small():
    assert (TESTDATA / "ue_dl_frame_100prb.npz").stat().st_size < 2**20


def test_ue_dl_frame_fixture_is_current():
    """Rendering the capture again gives the stored int8 pairs (at most 1 in
    10,000 a step away: the reference's IFFT rounds in float32), scale, sent
    TBs and configuration."""
    tool = load_tool()
    fx = np.load(tool.OUT_FRAME)
    c, q, scale, sent = tool.ue_dl_frame_capture()
    assert np.count_nonzero(q != fx["q"]) <= q.size // 10_000
    assert np.abs(q.astype(int) - fx["q"]).max() <= 1
    assert abs(float(scale) - float(fx["scale"])) <= 1e-6 * float(scale)
    np.testing.assert_array_equal(tool.pack_rows(sent), fx["sent_packed"])
    for k, v in c.items():
        assert fx[k].tolist() == v, k


def test_port_decodes_ue_dl_frame_like_reference():
    """chip_smoke.py phase 23's checks of the stored frame, on the CPU."""
    fx = np.load(TESTDATA / "ue_dl_frame_100prb.npz")
    info = load_smoke().check_ue_dl_frame(fx, "cpu")
    assert info["subframes"] == fx["ref_sf"].tolist() and len(info["subframes"]) >= 7


# --- the stored UL subframes (chip_smoke.py phase 26) ---------------------------


def test_enb_ul_fixture_stays_small():
    assert (TESTDATA / "enb_ul_100prb.npz").stat().st_size < 2**20


def test_enb_ul_fixture_is_current():
    """Rendering the four UL subframes again gives the stored int8 pairs (at
    most 1 in 10,000 a step away), scales, sent bits and configuration."""
    tool = load_tool()
    fx = np.load(tool.OUT_ENB_UL)
    c, q, scale, sent = tool.enb_ul_capture()
    assert np.count_nonzero(q != fx["q"]) <= q.size // 10_000
    assert np.abs(q.astype(int) - fx["q"]).max() <= 1
    np.testing.assert_allclose(scale, fx["scale"], rtol=1e-6)
    np.testing.assert_array_equal(tool.pack_rows(sent["tbs"]), fx["sent_packed"])
    np.testing.assert_array_equal(sent["cqi"], fx["sent_cqi"])
    np.testing.assert_array_equal(tool.pack_rows(sent["pucch"]), fx["sent_pucch"])
    assert int(fx["w"]) == sent["w"] == 96
    for k, v in c.items():
        assert np.asarray(fx[k]).tolist() == list(v) if isinstance(v, tuple) else fx[k] == v, k


def test_port_decodes_enb_ul_fixture_like_reference():
    """chip_smoke.py phase 26's checks of the stored UL subframes and the
    refsignal validation of the stored frame, on the CPU."""
    fx = np.load(TESTDATA / "enb_ul_100prb.npz")
    info = load_smoke().check_enb_ul(fx, "cpu")
    assert info["uci"]["cqi_bits"] == tuple(fx["sent_cqi"].tolist()) and len(info["uci"]["cqi_bits"]) == 30
    assert info["prach"] == ([int(fx["preamble"])], 2)
    assert info["refsignal"][0].found and not info["refsignal"][1].found
