"""The port's eNB UL receive chain against the JAX reference on the CPU:
`pusch_decode` and `enb_ul_decode_pusch` (no UCI, the RM-coded CQI with ACK
and RI, the 30-bit conv-coded CQI, the shortened format, HARQ rv 0 → 2),
`enb_ul_fft`, `enb_ul_decode_pucch` (formats 1, 2, 3), PRACH
(`prach_generate_np`, `ue_prach_send`, `prach_detect`), the SRS
(`srs_sequence`, `put_srs_np`, `srs_estimate`, `ue_ul_encode(srs=)`), and
`chip_smoke.py`'s UL link at 25 PRB.  The same numpy inputs, made from a
seed, go through both packages.

Tolerances: TB bits, crc_ok, the UCI values, PUCCH bits, PRACH detections
and delays identical; softbuffers within 2e-6 of their largest magnitude;
snr_db within 1e-3 dB; PUCCH and PRACH metrics within 1e-4 relative; the
UL grid within 2e-5 of its largest magnitude (FFTs that round in another
order); samples of `ue_ul_encode` and the preambles within 2e-6; the SRS
estimate within 2e-5 of its largest magnitude, its SNR within 1e-4
relative.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import srsran_tpu.phy.chest.srs as r_srs
import srsran_tpu.phy.enb.enb_ul as r_enb_ul
import srsran_tpu.phy.phch.prach as r_prach
import srsran_tpu.phy.phch.pusch as r_pusch
import srsran_tpu.phy.phch.ra as r_ra
import srsran_tpu.phy.ue.ue_ul as r_ue_ul
from srsran_tpu.phy.chest.chest_ul import chest_ul as r_chest_ul
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.phch.pucch import PucchConfig
import srsran_tpu_torch.phy.chest.srs as t_srs
import srsran_tpu_torch.phy.enb.enb_ul as t_enb_ul
import srsran_tpu_torch.phy.phch.prach as t_prach
import srsran_tpu_torch.phy.phch.pusch as t_pusch
import srsran_tpu_torch.phy.ue.ue_ul as t_ue_ul
from srsran_tpu_torch.convert import from_reference

torch.set_num_threads(1)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
CELL = Cell(nof_prb=25, nof_ports=1, id=301)
PCELL = from_reference(CELL)
SNR_ATOL_DB = 1e-3


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def ul_grant(nprb, mcs, start, rv=0):
    tbs = r_ra.tbs_lookup(r_ra.ul_mcs_to_itbs(mcs), nprb)
    return r_pusch.UlGrant(prb_start=start, nof_prb=nprb, mod=r_ra.ul_mcs_to_mod(mcs), tbs=tbs,
                           rv=rv, rnti=0x46)


def rx_grid(rng, samples, nrx, amp):
    """The reference's UL grid of `samples` behind a flat channel per antenna."""
    h = np.array([0.9 * np.exp(0.4j), 0.5 * np.exp(-1.1j)][:nrx], np.complex64)
    return np.asarray(r_enb_ul.enb_ul_fft(CELL, awgn(rng, h[:, None] * samples[None], amp)))


def same_decode(got, ref):
    """(tb, ok, softbuffers, snr_db[, uci]) of both packages."""
    assert len(got) == len(ref) and got[1] == bool(ref[1]) and isinstance(got[1], bool)
    if ref[1]:
        np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert len(got[2]) == len(ref[2])
    for g, r in zip(got[2], ref[2]):
        close(g.numpy(), np.asarray(r), 2e-6)
    assert abs(got[3] - float(ref[3])) <= SNR_ATOL_DB
    if len(ref) > 4:
        assert got[4] == ref[4]


# (nprb, mcs, first PRB, subframe, UCI sent or None, shortened, rx antennas)
PUSCH_CASES = {
    "plain": (20, 12, 3, 2, None, False, 1),
    "rm_ack_ri": (20, 12, 3, 4, dict(cqi_bits=(1, 0, 1, 1), ack=(1,), ri=(1,)), False, 2),
    "conv_30bit": (24, 10, 1, 6, dict(cqi_bits=tuple(int(b) for b in np.arange(30) * 7 % 3 == 1),
                                      ack=(0, 0)), False, 1),
    "shortened_uci": (20, 12, 3, 3, dict(cqi_bits=(0, 1, 1, 0), ack=(1, 1), ri=(0,)), True, 1),
    "shortened_plain": (16, 14, 5, 3, None, True, 1),
}


@pytest.mark.parametrize("case", list(PUSCH_CASES))
def test_enb_ul_decode_pusch_equals_reference(case):
    """The facade and `pusch_decode` on the reference's channel estimate:
    bits, CRC, UCI and softbuffers as the reference's; the sent TB and UCI
    come back."""
    nprb, mcs, start, sf, uci_sent, shortened, nrx = PUSCH_CASES[case]
    rng = np.random.default_rng(nprb * 10 + sf)
    grant = ul_grant(nprb, mcs, start)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    uci = r_pusch.UciCfg(**uci_sent) if uci_sent else None
    srs = (0, 8) if shortened else None
    samples = np.asarray(r_ue_ul.ue_ul_encode(CELL, sf, pusch=(grant, tb), uci=uci, srs=srs))
    grid = rx_grid(rng, samples, nrx, 0.05)
    # the receiver knows the sizes only
    uci_exp = None if uci is None else r_pusch.UciCfg(
        cqi_bits=(0,) * len(uci.cqi_bits), ack=(0,) * len(uci.ack), ri=(0,) * len(uci.ri))
    t_uci = None if uci_exp is None else from_reference(uci_exp)
    t_grant = from_reference(grant)
    ref = r_enb_ul.enb_ul_decode_pusch(CELL, sf, grid, grant, 5, uci=uci_exp, shortened=shortened)
    got = t_enb_ul.enb_ul_decode_pusch(PCELL, sf, grid, t_grant, 5, uci=t_uci,
                                       shortened=shortened, device=CPU)
    same_decode(got, ref)
    assert got[1] and (got[0] == tb).all()
    if uci is not None:
        assert got[4] == dict(cqi_bits=uci.cqi_bits, ack=uci.ack[:1] * len(uci.ack),
                              ri=uci.ri[:1] * len(uci.ri))
    ce, noise = r_chest_ul(grid, CELL, grant.prb_start, grant.nof_prb)
    ce, noise_f = np.asarray(ce), float(np.mean(np.asarray(noise)))
    ref_d = r_pusch.pusch_decode(grid, ce, noise_f, CELL, sf, grant, 5, uci=uci_exp,
                                 shortened=shortened)
    got_d = t_pusch.pusch_decode(grid, ce, noise_f, PCELL, sf, t_grant, 5, uci=t_uci,
                                 shortened=shortened, device=CPU)
    same_decode((*got_d[:3], 0.0, *got_d[3:]), (*ref_d[:3], 0.0, *ref_d[3:]))


def test_pusch_harq_rv0_then_rv2():
    """rv 0 alone fails in noise; rv 2 combined with its softbuffers passes,
    in both packages alike."""
    rng = np.random.default_rng(8)
    g0, g2 = ul_grant(20, 16, 2, rv=0), ul_grant(20, 16, 2, rv=2)
    tb = rng.integers(0, 2, g0.tbs).astype(np.uint8)
    grids = [rx_grid(rng, np.asarray(r_ue_ul.ue_ul_encode(CELL, sf, pusch=(g, tb))), 1, 0.36)
             for sf, g in ((1, g0), (2, g2))]
    r0 = r_enb_ul.enb_ul_decode_pusch(CELL, 1, grids[0], g0, 5)
    t0 = t_enb_ul.enb_ul_decode_pusch(PCELL, 1, grids[0], from_reference(g0), 5, device=CPU)
    same_decode(t0, r0)
    r2 = r_enb_ul.enb_ul_decode_pusch(CELL, 2, grids[1], g2, 5, softbuffers=r0[2])
    t2 = t_enb_ul.enb_ul_decode_pusch(PCELL, 2, grids[1], from_reference(g2), 5,
                                      softbuffers=t0[2], device=CPU)
    same_decode(t2, r2)
    assert not t0[1] and t2[1] and (t2[0] == tb).all()


def test_enb_ul_fft_equals_reference():
    rng = np.random.default_rng(3)
    x = awgn(rng, np.zeros((2, CELL.sf_len), np.complex64), 0.5)
    got = t_enb_ul.enb_ul_fft(PCELL, x, device=CPU)
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    close(got.numpy(), np.asarray(r_enb_ul.enb_ul_fft(CELL, x)), 2e-5)


PUCCH_CASES = {  # format (its first letter) and case: (n_pucch, payload bits)
    "1": (2, 1), "1b": (7, 2), "2": (20, 4), "2_13": (22, 13), "3": (36, 4), "3_dual": (38, 16),
}


@pytest.mark.parametrize("case", list(PUCCH_CASES))
def test_enb_ul_decode_pucch_equals_reference(case):
    n_pucch, nbits = PUCCH_CASES[case]
    fmt = case[0]
    rng = np.random.default_rng(n_pucch)
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    cfg = PucchConfig(n_pucch=n_pucch)
    kw = {"1": dict(pucch1=(cfg, list(bits))), "2": dict(pucch2=(cfg, bits)),
          "3": dict(pucch3=(cfg, bits, 0x47))}[fmt]
    sf = 2 + n_pucch % 7
    grid = rx_grid(rng, np.asarray(r_ue_ul.ue_ul_encode(CELL, sf, **kw)), 1, 0.05)
    rnti = 0x47 if fmt == "3" else 0
    rb, rm = r_enb_ul.enb_ul_decode_pucch(CELL, sf, grid, cfg, fmt, nbits, rnti=rnti)
    tb, tm = t_enb_ul.enb_ul_decode_pucch(PCELL, sf, grid, from_reference(cfg), fmt, nbits,
                                          rnti=rnti, device=CPU)
    tb, tm = np.asarray(tb.cpu() if isinstance(tb, torch.Tensor) else tb), float(tm)
    np.testing.assert_array_equal(tb, np.asarray(rb))
    np.testing.assert_array_equal(tb, bits)
    assert abs(tm - float(rm)) <= 1e-4 * abs(float(rm))


# --- PRACH ---------------------------------------------------------------------


def prach_cfgs(**kw):
    ref = r_prach.PrachConfig(**kw)
    return ref, from_reference(ref)


@pytest.mark.parametrize("zcz,root", [(1, 0), (12, 22), (15, 837)])
def test_prach_generate_and_send_equal_reference(zcz, root):
    ref_cfg, t_cfg = prach_cfgs(root_seq_index=root, zero_corr_zone=zcz, freq_offset=4)
    assert t_prach._roots_and_shifts(t_cfg) == r_prach._roots_and_shifts(ref_cfg)
    assert t_prach.prach_nfft(PCELL) == r_prach.prach_nfft(CELL)
    assert t_prach.prach_cp_len(PCELL) == r_prach.prach_cp_len(CELL)
    np.testing.assert_array_equal(t_prach._freq_map(PCELL, t_cfg), r_prach._freq_map(CELL, ref_cfg))
    for pidx in (0, 17, 63):
        want = r_prach.prach_generate_np(CELL, ref_cfg, pidx)
        close(t_prach.prach_generate_np(PCELL, t_cfg, pidx), want, 2e-6)
        got = t_ue_ul.ue_prach_send(PCELL, t_cfg, pidx, ta_samples=11, device=CPU)
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), r_ue_ul.ue_prach_send(CELL, ref_cfg, pidx, 11),
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("pidx,delay", [(0, 0), (5, 0), (33, 0), (63, 0), (17, 24), (40, 61)])
def test_prach_detect_equals_reference(pidx, delay):
    """A preamble behind `delay` samples of propagation (PRACH window from
    the CP's end, as the eNB cuts it) in noise."""
    ref_cfg, t_cfg = prach_cfgs(freq_offset=2)
    rng = np.random.default_rng(pidx + delay)
    p = r_prach.prach_generate_np(CELL, ref_cfg, pidx)
    cp, nfft = r_prach.prach_cp_len(CELL), r_prach.prach_nfft(CELL)
    x = np.concatenate([np.zeros(delay, np.complex64), p])[cp : cp + nfft]
    x = awgn(rng, x, 0.05)
    rm, rd, rdet = (np.asarray(v) for v in r_prach.prach_detect(CELL, ref_cfg, x))
    tm, td, tdet = (v.numpy() for v in t_prach.prach_detect(PCELL, t_cfg, x, device=CPU))
    np.testing.assert_array_equal(tdet, rdet)
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_allclose(tm, rm, rtol=1e-4)
    assert tdet[pidx] and tdet.sum() == 1
    assert abs(int(td[pidx]) - delay * 839 / nfft) <= 1


def test_prach_detect_on_noise_alone():
    ref_cfg, t_cfg = prach_cfgs(zero_corr_zone=5)
    x = awgn(np.random.default_rng(0), np.zeros((2, r_prach.prach_nfft(CELL)), np.complex64), 0.3)
    rm, rd, rdet = (np.asarray(v) for v in r_prach.prach_detect(CELL, ref_cfg, x))
    tm, td, tdet = (v.numpy() for v in t_prach.prach_detect(PCELL, t_cfg, x, device=CPU))
    assert tm.shape == (2, 64) and not tdet.any() and not rdet.any()
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_allclose(tm, rm, rtol=1e-4)


# --- SRS -----------------------------------------------------------------------


@pytest.mark.parametrize("start,nprb,cs", [(0, 25, 0), (2, 8, 3), (5, 1, 7), (1, 3, 0)])
def test_srs_sequence_put_and_estimate(start, nprb, cs):
    np.testing.assert_array_equal(t_srs.srs_sequence(PCELL, nprb, cs),
                                  r_srs.srs_sequence(CELL, nprb, cs))
    assert t_srs.srs_symbol_index(PCELL) == r_srs.srs_symbol_index(CELL)
    g = np.zeros((CELL.nsymb_per_sf, CELL.nof_re_per_symbol), np.complex64)
    want = r_srs.put_srs_np(g.copy(), CELL, start, nprb, cs)
    np.testing.assert_array_equal(t_srs.put_srs_np(g.copy(), PCELL, start, nprb, cs), want)
    rng = np.random.default_rng(nprb)
    rx = awgn(rng, np.stack([0.7j * want, (0.3 - 0.2j) * want]), 0.05)
    rce, rsnr = (np.asarray(v) for v in r_srs.srs_estimate(rx, CELL, start, nprb, cs))
    tce, tsnr = t_srs.srs_estimate(rx, PCELL, start, nprb, cs, device=CPU)
    close(tce.numpy(), rce, 2e-5)
    np.testing.assert_allclose(tsnr.numpy(), rsnr, rtol=1e-4)


@pytest.mark.parametrize("with_pusch", [False, True])
def test_ue_ul_encode_with_srs(with_pusch):
    """`srs=` sounds the last symbol; a PUSCH there takes the shortened
    format, with UCI."""
    rng = np.random.default_rng(4)
    grant = ul_grant(12, 8, 6)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    uci = r_pusch.UciCfg(cqi_bits=(1, 1, 0, 1), ack=(1,))
    kw_r = dict(pusch=(grant, tb), uci=uci) if with_pusch else {}
    kw_t = dict(pusch=(from_reference(grant), tb), uci=from_reference(uci)) if with_pusch else {}
    for sf, srs, ta, cfo in ((3, (2, 20), 0, 0.0), (8, (0, 25), 4, 0.02)):
        want = np.asarray(r_ue_ul.ue_ul_encode(CELL, sf, srs=srs, ta_samples=ta, cfo=cfo, **kw_r))
        got = t_ue_ul.ue_ul_encode(PCELL, sf, srs=srs, ta_samples=ta, cfo=cfo, device=CPU, **kw_t)
        assert got.dtype == torch.complex64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_entry_points_take_the_card_by_default():
    """With no device given, the UL entry points ask for the card and raise
    where there is none (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from srsran_tpu_torch.phy.channel.channel import Channel, ChannelConfig
    from srsran_tpu_torch.phy.sync.refsignal_dl_sync import refsignal_dl_sync_run

    grid = np.zeros((1, PCELL.nsymb_per_sf, PCELL.nof_re_per_symbol), np.complex64)
    g = from_reference(ul_grant(4, 4, 0))
    cfg = t_prach.PrachConfig()
    for call in (lambda: t_enb_ul.enb_ul_fft(PCELL, grid[:, 0]),
                 lambda: t_enb_ul.enb_ul_decode_pusch(PCELL, 0, grid, g),
                 lambda: t_enb_ul.enb_ul_decode_pucch(PCELL, 0, grid, PucchConfig(), "1", 1),
                 lambda: t_pusch.pusch_decode(grid, grid, 0.1, PCELL, 0, g),
                 lambda: t_prach.prach_detect(PCELL, cfg, grid[0, 0]),
                 lambda: t_srs.srs_estimate(grid, PCELL, 0, 4),
                 lambda: t_ue_ul.ue_ul_encode(PCELL, 0),
                 lambda: t_ue_ul.ue_prach_send(PCELL, cfg, 0),
                 lambda: Channel(ChannelConfig()),
                 lambda: refsignal_dl_sync_run(grid[0, 0], PCELL)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_phase_27_ul_link_on_the_cpu():
    """chip_smoke.py phase 27's UL link at 25 PRB over one frame, with its
    own gates; its span steps give `enb_ul_receive`'s results on the PRACH,
    RM-CQI, SRS and Viterbi-CQI subframes."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = smoke.ul_link_run(CPU, nof_prb=25, n_frames=1, keep=(1, 2, 3, 5))
    assert rec["tbs_ok"] >= 9 and rec["prach"] == [True] and rec["srs_snr_db"][0] > 10
    for plan, rx in rec["kept"].values():
        s, spans = smoke.run_steps(smoke.enb_ul_steps(rec["cell"], plan, CPU), CPU, {"rx": rx})
        ref = smoke.enb_ul_receive(rec["cell"], plan, rx, CPU)
        assert s["ok"] and ref["ok"] and np.array_equal(s["tb"], ref["tb"]) and s["uci"] == ref["uci"]
        assert {k: v[0].tolist() for k, v in s["pucch"].items()} == {
            k: v[0].tolist() for k, v in ref["pucch"].items()}
        assert s.get("prach") == ref.get("prach") and len(spans) == 8


def test_prach_sidelobe_in_the_next_zone():
    """At 100 PRB a preamble 48 samples late (1.64 ZC samples) has a
    sidelobe at the last sample of the next preamble's zone, about 10 times
    the root's mean power on a flat channel, below the threshold of 15 —
    in both packages alike (ROADMAP Queue 3)."""
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    ref_cfg, t_cfg = prach_cfgs(freq_offset=2)
    p = r_prach.prach_generate_np(cell, ref_cfg, 17)
    cp, nfft = r_prach.prach_cp_len(cell), r_prach.prach_nfft(cell)
    x = np.concatenate([np.zeros(48, np.complex64), p])[cp : cp + nfft]
    rm, rd, rdet = (np.asarray(v) for v in r_prach.prach_detect(cell, ref_cfg, x))
    tm, td, tdet = (v.numpy() for v in t_prach.prach_detect(from_reference(cell), t_cfg, x,
                                                            device=CPU))
    np.testing.assert_array_equal(tdet, rdet)
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_allclose(tm, rm, rtol=1e-4)
    assert np.nonzero(tdet)[0].tolist() == [17] and td[17] == 2
    assert td[18] == ref_cfg.n_cs - 1 and 5 < tm[18] < 15


@pytest.mark.parametrize("n_f3", [26, 36])
def test_pucch_format_3_beside_format_2(n_f3):
    """Every format sits at `pucch_f1_prb(n_pucch)`: format 3 on the full
    stack's resource 26 shares PRB pair m = 1 with the format-2 CQI resource
    20 and does not decode there; on 36 (m = 2) it does.  Format 2 decodes
    in both; the two packages decode alike."""
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    rng = np.random.default_rng(n_f3)
    cqi, f3 = (rng.integers(0, 2, 4).astype(np.uint8) for _ in range(2))
    c2, c3 = PucchConfig(n_pucch=20), PucchConfig(n_pucch=n_f3)
    x = (np.asarray(r_ue_ul.ue_ul_encode(cell, 7, pucch2=(c2, cqi)))
         + np.asarray(r_ue_ul.ue_ul_encode(cell, 7, pucch3=(c3, f3, 0x49))))
    grid = np.asarray(r_enb_ul.enb_ul_fft(cell, awgn(rng, x, 0.01)[None]))
    got = {}
    for fmt, cfg, nb, rnti in (("2", c2, 4, 0), ("3", c3, 4, 0x49)):
        rb, rmet = r_enb_ul.enb_ul_decode_pucch(cell, 7, grid, cfg, fmt, nb, rnti=rnti)
        tb, tmet = t_enb_ul.enb_ul_decode_pucch(from_reference(cell), 7, grid, from_reference(cfg),
                                                fmt, nb, rnti=rnti, device=CPU)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
        assert abs(float(tmet) - float(rmet)) <= 1e-4 * abs(float(rmet))
        got[fmt] = tb.numpy()
    np.testing.assert_array_equal(got["2"], cqi)
    assert np.array_equal(got["3"], f3) == (n_f3 == 36)
