"""The port's sync chain (`srsran_tpu_torch/phy/sync/{pss,sss,cfo}.py`,
`phy/agc.py`, `phy/ue/ue_sync.py`, `phy/ue/intra_measure.py`) against the
JAX reference on the CPU, on the same numpy inputs made from a seed.

Tolerances: the PSS correlation within 1e-5 of its largest magnitude, with
`pss_find`'s n_id_2 and offset identical (every stimulus keeps a clear
peak: the FFTs round in another order); `pss_cfo_estimate` and `cfo.py`
within 1e-5; `sss_detect`'s n_id_1 and sf_is_5 identical, its metric within
1e-4 relative; `Agc` identical.  `cell_search` and `mib_search`: the cell,
offset, subframe, frame type, MIB, port count and frame offset identical,
cfo within 1e-5 and psr within 1e-4 relative; a window without a cell gives
the same decision (None).  `UeSync`: subframe indices, state, `in_sync`,
sample offsets and SFO identical in sequence, cfo within 1e-6, the popped
samples within 2e-6 of their largest magnitude plus the phase 2π·15·|Δcfo|
that a difference of the two CFOs in their last float32 bits turns over one
subframe (the CFO loop keeps such a difference; it is 0 where the CFOs are
equal).  `measure_cells`: the PCIs identical, RSRP within 1e-3
dB.  `refsignal_dl_sync_run`: the replicas within 2e-6, found,
false_alarm and peak_index identical, rsrp and rssi within 1e-3 dB, cfo
within 1 Hz, psr within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import srsran_tpu.phy.sync.cfo as r_cfo
import srsran_tpu.phy.sync.pss as r_pss
import srsran_tpu.phy.sync.sss as r_sss
import srsran_tpu.phy.ue.ue_sync as r_us
from srsran_tpu.phy import tdd as r_tdd
from srsran_tpu.phy.agc import Agc as RAgc
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
from srsran_tpu.phy.phch.pbch import Mib
import srsran_tpu_torch.phy.sync.cfo as t_cfo
import srsran_tpu_torch.phy.sync.pss as t_pss
import srsran_tpu_torch.phy.sync.sss as t_sss
import srsran_tpu_torch.phy.ue.ue_sync as t_us
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.phy.agc import Agc as TAgc

torch.set_num_threads(1)

CPU = "cpu"


def t(x):
    return torch.from_numpy(np.array(x))


def awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def frames(cell, n_sf, sfn=0, tdd_cfg=None, mib=True):
    """n_sf subframes of the reference's eNB with an empty schedule."""
    m = Mib(nof_prb=cell.nof_prb) if mib else None
    return np.concatenate([
        enb_dl_subframe(cell, i % 10, DlSched(cfi=1), mib=m, sfn=sfn + i // 10, tdd=tdd_cfg)[1][0]
        for i in range(n_sf)]).astype(np.complex64)


def with_cfo(x, cfo, sz):
    return (x * np.exp(2j * np.pi * cfo * np.arange(len(x)) / sz)).astype(np.complex64)


def pss_stimulus(seed, n, n_id_2, offsets, sz=128):
    rng = np.random.default_rng(seed)
    x = awgn(rng, np.zeros(n, np.complex64), 0.05)
    for off in offsets:
        x[off : off + sz] += r_pss.pss_time_np(n_id_2, sz)
    return x


@pytest.mark.parametrize("n_id_2,offsets", [(0, (37,)), (1, (500, 1700)), (2, (1900,))])
def test_pss_correlate_and_find(n_id_2, offsets):
    x = pss_stimulus(n_id_2, 2048, n_id_2, offsets)
    ref = np.asarray(r_pss.pss_correlate(x))
    got = t_pss.pss_correlate(t(x)).numpy()
    assert got.shape == ref.shape == (3, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    rn, ro, rp, ra = (np.asarray(v) for v in r_pss.pss_find(x))
    tn, to, tp, ta = (v.numpy() for v in t_pss.pss_find(t(x)))
    assert (int(tn), int(to)) == (int(rn), int(ro)) == (n_id_2, offsets[0] if len(offsets) == 1
                                                        else int(ro))
    np.testing.assert_allclose([tp, ta], [rp, ra], rtol=1e-5)


def test_pss_find_batched_and_at_larger_fft():
    xs = np.stack([pss_stimulus(s, 4000, s % 3, (300 + 500 * s,), sz=256) for s in range(4)])
    rn, ro, _, _ = (np.asarray(v) for v in r_pss.pss_find(xs, 256))
    tn, to, _, _ = (v.numpy() for v in t_pss.pss_find(t(xs), 256))
    np.testing.assert_array_equal(tn, rn)
    np.testing.assert_array_equal(to, ro)
    np.testing.assert_array_equal(to, [300, 800, 1300, 1800])


@pytest.mark.parametrize("cfo", [-0.3, 0.0, 0.12, 0.45])
def test_pss_cfo_estimate(cfo):
    rng = np.random.default_rng(3)
    for n_id_2 in range(3):
        sym = awgn(rng, with_cfo(r_pss.pss_time_np(n_id_2), cfo, 128), 0.01)
        ref = float(np.asarray(r_pss.pss_cfo_estimate(sym, n_id_2)))
        got = float(t_pss.pss_cfo_estimate(t(sym), n_id_2))
        assert abs(got - ref) <= 1e-5 and abs(got - cfo) < 0.05


@pytest.mark.parametrize("with_ce", [False, True])
def test_sss_detect(with_ce):
    rng = np.random.default_rng(7 + with_ce)
    for n_id_1, n_id_2, sf in ((0, 0, 0), (101, 2, 5), (167, 1, 0), (55, 1, 5)):
        d = r_sss.sss_sequence_np(n_id_1, n_id_2, sf).astype(np.complex64)
        ce = (0.8 * np.exp(1j * rng.uniform(0, 2 * np.pi, 62))).astype(np.complex64)
        rx = awgn(rng, d * ce if with_ce else d, 0.3)
        args = dict(ce=ce) if with_ce else {}
        r1, r5, rm = (np.asarray(v) for v in r_sss.sss_detect(rx, n_id_2, **args))
        targs = dict(ce=t(ce)) if with_ce else {}
        g1, g5, gm = t_sss.sss_detect(t(rx), n_id_2, **targs)
        assert (int(g1), bool(g5)) == (int(r1), bool(r5)) == (n_id_1, sf == 5)
        assert abs(float(gm) - float(rm)) <= 1e-4 * float(rm)


def test_cfo_module():
    rng = np.random.default_rng(11)
    ref_cell = Cell(nof_prb=6, nof_ports=1, id=3)
    cell = from_reference(ref_cell)
    x = frames(ref_cell, 2)
    for cfo in (-0.2, 0.07):
        y = awgn(rng, with_cfo(x, cfo, 128), 0.01)
        ref = np.asarray(r_cfo.cfo_apply(y, 0.1, 128))
        got = t_cfo.cfo_apply(t(y), 0.1, 128).numpy()
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        slots = np.stack([y[:960], y[960:1920]])
        ref = np.asarray(r_cfo.cfo_estimate_cp(slots, ref_cell))
        got = t_cfo.cfo_estimate_cp(t(slots), cell).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert np.all(np.abs(got - cfo) < 0.02)
        ext, mn, me = r_cfo.cp_detect(y, 128)
        g_ext, g_mn, g_me = t_cfo.cp_detect(t(y), 128)
        assert g_ext == ext is False or g_ext == ext
        np.testing.assert_allclose([g_mn, g_me], [mn, me], rtol=1e-5)
    offs = np.cumsum(rng.standard_normal((3, 20)), axis=-1).astype(np.float32)
    ref = np.asarray(r_cfo.sfo_estimate(offs, 0.005))
    np.testing.assert_allclose(t_cfo.sfo_estimate(t(offs), 0.005).numpy(), ref, rtol=1e-5)


def test_agc_identical():
    rng = np.random.default_rng(2)
    r, g = RAgc(target=0.25, min_gain_db=-30.0), TAgc(target=0.25, min_gain_db=-30.0)
    for amp in (0.001, 0.02, 1.5, 1.5, 0.3, 0.3, 0.3, 4.0):
        x = (amp * (rng.standard_normal(1920) + 1j * rng.standard_normal(1920))).astype(np.complex64)
        assert g.process(x) == r.process(x)
        assert (g.gain_db, g.state) == (r.gain_db, r.state)
    # a tensor is measured on its device
    assert abs(TAgc().process(t(x)) - RAgc().process(x)) <= 1e-5 * RAgc().process(x)


def same_search(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None
    for f in ("cell_id", "n_id_2", "peak_offset", "sf_idx", "frame_type"):
        assert getattr(got, f) == getattr(ref, f), f
    assert abs(got.cfo - ref.cfo) <= 1e-5
    assert abs(got.psr - ref.psr) <= 1e-4 * ref.psr


CAPTURES = [  # (nof_prb, pci, tdd config, cfo, noise)
    (6, 3 * 101 + 2, None, 0.12, 0.02),
    (15, 84, None, -0.07, 0.01),
    (6, 151, (1, 4), 0.05, 0.02),
]


@pytest.mark.parametrize("nof_prb,pci,tdd_cfg,cfo,noise", CAPTURES)
def test_cell_search_and_mib_search(nof_prb, pci, tdd_cfg, cfo, noise):
    ref_cell = Cell(nof_prb=nof_prb, nof_ports=1, id=pci)
    cfg = r_tdd.TddConfig(*tdd_cfg) if tdd_cfg else None
    rng = np.random.default_rng(pci)
    # from 2.6 subframes in: every PSS in the window has its SSS before it
    x = frames(ref_cell, 14, tdd_cfg=cfg)[int(2.6 * ref_cell.sf_len):]
    rx = awgn(rng, with_cfo(x, cfo, ref_cell.symbol_sz), noise)
    ref = r_us.cell_search(rx, nof_prb)
    got = t_us.cell_search(rx, nof_prb, device=CPU)
    same_search(got, ref)
    assert ref.cell_id == pci and ref.frame_type == ("tdd" if cfg else "fdd")
    for ft in ("fdd", "tdd"):
        same_search(t_us.cell_search(rx, nof_prb, frame_type=ft, device=CPU),
                    r_us.cell_search(rx, nof_prb, frame_type=ft))
    if cfg is None:
        sz = ref_cell.symbol_sz
        pss_pos = ref_cell.sf_len // 2 - sz
        sf0 = ref.peak_offset - pss_pos + (ref_cell.sf_len * 5 if ref.sf_idx == 5 else 0)
        sf0 %= 10 * ref_cell.sf_len
        rmib = r_us.mib_search(rx, ref_cell, sf0, ref.cfo)
        gmib = t_us.mib_search(rx, from_reference(ref_cell), sf0, ref.cfo, device=CPU)
        assert rmib is not None and gmib is not None
        assert gmib[0] == from_reference(rmib[0]) and gmib[1:] == rmib[1:]


def test_cell_search_without_a_cell():
    rng = np.random.default_rng(99)
    rx = awgn(rng, np.zeros(7 * 1920, np.complex64), 0.1)
    ref = r_us.cell_search(rx, 6)
    same_search(t_us.cell_search(rx, 6, device=CPU), ref)


def test_apply_cfo():
    rng = np.random.default_rng(4)
    x = awgn(rng, np.zeros(215040, np.complex64), 1.0)
    for cfo in (0.12, -0.37):
        ref = r_us.apply_cfo(x, cfo, 2048)
        got = t_us.apply_cfo(t(x), cfo, 2048).numpy()
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def _drift_capture(cell, n_frames, cfo_subc, ppm, snr_amp, rng):
    """tests/test_sync_drift.py's capture: CFO, clock drift and AWGN."""
    x = frames(cell, 10 * n_frames)
    n = np.arange(len(x))
    x = x * np.exp(2j * np.pi * cfo_subc * n / cell.symbol_sz)
    t_rx = np.arange(int(len(x) / (1 + ppm * 1e-6))) * (1 + ppm * 1e-6)
    x = np.interp(t_rx, n, x.real) + 1j * np.interp(t_rx, n, x.imag)
    return awgn(rng, x, snr_amp)


def run_pair(chunks, ref_sync, port_sync):
    """Feed both UeSyncs the same chunks; every popped subframe and the state
    after it must agree."""
    n = 0
    for chunk in chunks:
        ref_sync.push(chunk)
        port_sync.push(chunk)
        while True:
            r = ref_sync.pop_subframe()
            g = port_sync.pop_subframe()
            assert (g is None) == (r is None)
            if r is None:
                break
            assert g[1] == r[1]
            # the subframe was rotated by each side's CFO, whose float32
            # estimates may differ in their last bits: over a subframe that
            # difference turns the phase by up to 2π·15·|Δcfo|
            dphase = 2 * np.pi * 15 * abs(port_sync.cfo - ref_sync.cfo)
            np.testing.assert_allclose(g[0].numpy(), r[0], rtol=0,
                                       atol=(2e-6 + dphase) * np.abs(r[0]).max())
            n += 1
            assert (port_sync.state, port_sync.in_sync, port_sync.sf_idx) == (
                ref_sync.state, ref_sync.in_sync, ref_sync.sf_idx)
            assert (port_sync.mean_sample_offset, port_sync.sfo_samples_per_frame) == (
                ref_sync.mean_sample_offset, ref_sync.sfo_samples_per_frame)
            assert abs(port_sync.cfo - ref_sync.cfo) <= 1e-6
            assert port_sync.buf.shape[0] == len(ref_sync.buf)
    return n


def test_ue_sync_drift():
    """tests/test_sync_drift.py's drift scenario, 0.5 s: CFO 0.08, 25 ppm,
    AGC."""
    cell = Cell(nof_prb=6, nof_ports=1, id=150)
    cap = _drift_capture(cell, 50, 0.08, 25.0, 0.05, np.random.default_rng(8))
    ref = r_us.UeSync(nof_prb=6, agc=RAgc(target=0.1))
    got = t_us.UeSync(nof_prb=6, agc=TAgc(target=0.1), device=CPU)
    n = run_pair([cap[p : p + 3840] for p in range(0, len(cap), 3840)], ref, got)
    assert n > 400 and got.state == "TRACK" and abs(got.sfo_hz) > 10.0


def test_ue_sync_fade():
    """tests/test_sync_drift.py's fade scenario: lock, one faded frame (still
    TRACK), clean signal, a sustained outage (back to FIND)."""
    cell = Cell(nof_prb=6, nof_ports=1, id=99)
    rng = np.random.default_rng(3)
    cap = _drift_capture(cell, 12, 0.0, 0.0, 0.02, rng)
    fade = awgn(rng, np.zeros(10 * 1920, np.complex64), 0.02)
    ref, got = r_us.UeSync(nof_prb=6), t_us.UeSync(nof_prb=6, device=CPU)
    run_pair([cap[: 20 * 1920], fade, cap[20 * 1920 : 40 * 1920], np.tile(fade, 3)], ref, got)
    assert got.state == "FIND"


def test_ue_sync_agc_and_offset():
    """Start 1234 samples into a stream with a timing step and AGC: the buffer
    levels and the popped samples agree."""
    cell = Cell(nof_prb=15, nof_ports=1, id=17)
    rng = np.random.default_rng(1)
    x = frames(cell, 30)
    x = np.concatenate([np.zeros(1234, np.complex64), x[:12000], x[12003:]])
    x = awgn(rng, 0.02 * with_cfo(x, -0.04, 256), 0.0005)
    ref = r_us.UeSync(nof_prb=15, agc=RAgc(target=0.25, min_gain_db=-30.0))
    got = t_us.UeSync(nof_prb=15, agc=TAgc(target=0.25, min_gain_db=-30.0), device=CPU)
    n = run_pair([x[p : p + 3840] for p in range(0, len(x), 3840)], ref, got)
    assert n >= 20
    assert got._agc_gain == ref._agc_gain


def test_measure_cells_two_cells():
    """tests/test_ue_enb.py's two-cell mixture (PCI 42 strong, 151 weaker and
    half a subframe late)."""
    from srsran_tpu.phy.ue.intra_measure import measure_cells as r_measure
    from srsran_tpu_torch.phy.ue.intra_measure import measure_cells as t_measure

    def cell_frames(pci):
        return frames(Cell(nof_prb=6, nof_ports=1, id=pci), 12)

    rng = np.random.default_rng(0)
    rx = cell_frames(42) + np.roll(cell_frames(151), 960) * 0.4
    rx = awgn(rng, rx, 0.005)
    for serving in (None, 42):
        ref = r_measure(rx, nof_prb=6, threshold=5.0, serving_pci=serving)
        got = t_measure(rx, nof_prb=6, threshold=5.0, serving_pci=serving, device=CPU)
        assert [m.pci for m in got] == [m.pci for m in ref]
        for g, r in zip(got, ref):
            assert abs(g.rsrp_dbfs - r.rsrp_dbfs) <= 1e-3 and abs(g.rsrq_db - r.rsrq_db) <= 1e-3
            assert g.peak_offset == r.peak_offset and abs(g.cfo - r.cfo) <= 1e-5
    assert 151 in [m.pci for m in got]


def test_ue_sync_agc_levels():
    """tests/test_sync_drift.py's AGC scenario: noise at three input levels;
    the gains, the buffers and whatever the two pop agree."""
    rng = np.random.default_rng(1)
    for amp in (0.001, 0.02, 1.5):
        ref = r_us.UeSync(nof_prb=6, agc=RAgc(target=0.25, min_gain_db=-30.0))
        got = t_us.UeSync(nof_prb=6, agc=TAgc(target=0.25, min_gain_db=-30.0), device=CPU)
        chunks = [(amp * (rng.standard_normal(1920) + 1j * rng.standard_normal(1920))
                   ).astype(np.complex64) for _ in range(8)]
        run_pair(chunks, ref, got)
        assert got._agc_gain == ref._agc_gain
        np.testing.assert_array_equal(got.buf.numpy(), ref.buf)
        rms = float(np.sqrt(np.mean(np.abs(ref.buf[-1920:]) ** 2)))
        assert 0.1 < rms < 0.6


# --- refsignal_dl_sync: CRS cell validation ------------------------------------


def crs_frames(cell, n_frames=2):
    """The reference's CRS + PSS/SSS signature of n_frames frames."""
    import srsran_tpu.phy.sync.refsignal_dl_sync as r_rs_sync

    return np.concatenate([r_rs_sync._cell_sequences(cell)] * n_frames).reshape(-1)


@pytest.mark.parametrize("nof_prb,pci,wrong", [(6, 123, None), (25, 301, None), (6, 123, 124),
                                               (25, 301, 17)])
def test_refsignal_dl_sync(nof_prb, pci, wrong):
    """The capture of `tests/test_sync.py`'s refsignal test (two frames,
    1501 samples in, 250 Hz of CFO, noise 0.05), validated under its own
    PCI and rejected under a wrong one."""
    import srsran_tpu.phy.sync.refsignal_dl_sync as r_rs_sync
    import srsran_tpu_torch.phy.sync.refsignal_dl_sync as t_rs_sync

    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=pci)
    tx = crs_frames(cell)
    rng = np.random.default_rng(5)
    rx = tx * np.exp(2j * np.pi * 250.0 * np.arange(len(tx)) / cell.srate)
    rx = awgn(rng, np.concatenate([np.zeros(1501, np.complex64), rx]), 0.05)
    test_cell = cell if wrong is None else Cell(nof_prb=nof_prb, nof_ports=1, id=wrong)
    np.testing.assert_allclose(t_rs_sync._cell_sequences(from_reference(test_cell)),
                               r_rs_sync._cell_sequences(test_cell), rtol=0, atol=2e-6)
    ref = r_rs_sync.refsignal_dl_sync_run(rx, test_cell)
    got = t_rs_sync.refsignal_dl_sync_run(rx, from_reference(test_cell), device=CPU)
    assert (got.found, got.false_alarm, got.peak_index) == (ref.found, ref.false_alarm,
                                                            ref.peak_index)
    assert abs(got.psr - ref.psr) <= 1e-4 * ref.psr
    if ref.peak_index >= 0:
        assert abs(got.rsrp_dbfs - ref.rsrp_dbfs) <= 1e-3
        assert abs(got.rssi_dbfs - ref.rssi_dbfs) <= 1e-3
        assert abs(got.cfo_hz - ref.cfo_hz) <= 1.0
    if wrong is None:
        assert got.found and got.peak_index == 1501 and abs(got.cfo_hz - 250.0) < 40
    else:
        assert not got.found
