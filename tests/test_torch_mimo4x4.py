"""The port's 4x4 rank-4 TM4 decode (`pipeline.ue_dl_subframe_mimo` with
`tx_scheme="spatialmux4"`) and its 4x4 MMSE (`phy/mimo_cuda.py`) on the
CPU, where `mimo_cuda.mmse4` runs its plain form `mmse4_plain`.

The subframes: the benchmark configuration `lte10_fdd_dl_tm4_4x4` cut to
6 PRB (CFI 1 and one more control symbol below 10 PRB: 768 PDSCH REs),
MCS 26 with the two-layer TBS at 12 PRB (7224 bits, two code blocks of
3648 a codeword), from the benchmark's plain 4x4 transmitter
(`lte_bench/ref/tx_mimo4.py`) behind the configuration's channel, with
seeded TBs and white noise at two amplitudes, B = 2.

- (a) the batched entry gives the plain reference receiver's
  (`lte_bench/ref/rx_mimo4.py`) TB bits and CRC flags exactly, every TB
  the one sent, and its snr_db within the configuration's `snr_gap_db`
  (2e-4 dB: both sum the same CRS powers in float32 in other orders);
- (b) the port's host path, `pdsch_decode2` with `spatialmux4` (its MMSE
  `predecode_mmse_nl`, by `torch.linalg`), gives the same bits and flags
  subframe by subframe;
- (c) the plain MMSE form against `predecode_mmse_nl` on seeded (B, 4, 4,
  M) channels: see `test_plain_mmse_agrees_with_linalg`;
- (d) a traced call opens `fe.mimo` once inside `fe.equalize` and adds one
  `mmse4_launches`;
- the 4x4 grid of the reference transmitter is the port's
  `pdsch_encode2_np` (and with the CRS of four ports, `put_crs_np` of it).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lte_bench.ref import rx_mimo4, tx_mimo, tx_mimo4
from srsran_tpu_torch.graphs import run
from srsran_tpu_torch.phy import mimo_cuda
from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.mimo import _codebook_4, _fold_precoder, predecode_mmse_nl
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch.pdsch import (
    DlGrant2,
    pdsch_decode2,
    pdsch_encode2_np,
    pdsch_re_indices,
)
from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_itbs, tbs_lookup
from srsran_tpu_torch.pipeline import _dl_front_end, ue_dl_subframe_mimo
from srsran_tpu_torch.runtime import trace

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NOF_PRB, MCS, B = 6, 26, 2
AMPS = (0.01, 0.02)
# (c): x within 1e-4 of its largest magnitude, csi within 1e-4 relative.
# The plain form solves by a Cholesky factor and L^-1, `torch.linalg` by LU
# with pivoting, both in float32, on systems whose A has condition numbers
# up to ~1.4e3: a first-order bound of either's error is cond(A) times
# float32's 6e-8, about 8e-5; over 8 seeds they differ by up to 2.0e-5 (x)
# and 3.7e-5 (csi).  From inputs rounded to bf16 (8 bits of mantissa) the
# same form misses by 1e-2 to 5e-2.
X_TOL, CSI_TOL = 1e-4, 1e-4


def _cfg():
    cfg = json.loads((REPO / "lte_bench/configs/lte10_fdd_dl_tm4_4x4.json").read_text())
    cfg["cell"]["nof_prb"] = NOF_PRB
    cfg["grant"].update(nof_prb=NOF_PRB, mcs=MCS,
                        tbs=tbs_lookup(dl_mcs_to_itbs(MCS), 2 * NOF_PRB))
    return cfg


CFG = _cfg()


def _program(cfg):
    c, g = cfg["cell"], cfg["grant"]
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=4, id=c["cell_id"])
    mod = Mod[g["mod"]]
    grant = DlGrant2(prb=tuple(range(g["nof_prb"])), mod1=mod, tbs1=g["tbs"], mod2=mod,
                     tbs2=g["tbs"], pmi=g["pmi"], rnti=g["rnti"], tx_scheme="spatialmux4",
                     nof_layers=4)
    return cell, grant


def _tbs(seed):
    tb = np.random.default_rng([seed, 0]).integers(0, 2, (B, CFG["grant"]["tbs"]), dtype=np.uint8)
    return tb, tx_mimo.second_tb(CFG, tb)


def _samples(amp):
    """(B, 4, 15 N) received subframes and their (B, 2, tbs) sent TBs."""
    seed = int(amp * 1000)
    tb0, tb1 = _tbs(seed)
    clean = np.stack([tx_mimo4.pdsch4_subframe(CFG, a, b) for a, b in zip(tb0, tb1)])
    rng = np.random.default_rng([seed, 1])
    noise = rng.standard_normal(clean.shape + (2,)).astype(np.float32)
    x = clean + amp * (noise[..., 0] + 1j * noise[..., 1])
    return torch.from_numpy(x.astype(np.complex64)), np.stack([tb0, tb1], 1)


def _entry():
    cell, grant = _program(CFG)
    c = CFG["cell"]
    return ue_dl_subframe_mimo(cell, c["sf_idx"], c["cfi"], grant, CFG["max_iterations"],
                               device="cpu")


def test_the_cut_is_the_standards():
    """The reference's 4-port RE map is the port's: 768 REs here, 6800 at
    the cell's 50 PRB; G = 2 Q_m a RE a codeword, code rate about the
    cell's."""
    cell, grant = _program(CFG)
    c = CFG["cell"]
    n_re = len(tx_mimo4.re_indices(CFG))
    assert np.array_equal(tx_mimo4.re_indices(CFG),
                          pdsch_re_indices(cell, c["sf_idx"], c["cfi"], grant.prb))
    assert n_re == 768 and CFG["grant"]["tbs"] == 7224
    assert 0.7 < CFG["grant"]["tbs"] / (n_re * 6 * 2) < 0.8
    full = json.loads((REPO / "lte_bench/configs/lte10_fdd_dl_tm4_4x4.json").read_text())
    assert len(tx_mimo4.re_indices(full)) == 6800


@pytest.mark.parametrize("seed", [3, 2**31 + 26])
def test_transmitter_grid_matches_the_program(seed):
    tb0, tb1 = _tbs(seed)
    cell, grant = _program(CFG)
    c = CFG["cell"]
    theirs = pdsch_encode2_np(cell, c["sf_idx"], c["cfi"], grant, tb0[0], tb1[0])
    ours = tx_mimo4.ports_grid(CFG, tb0[0], tb1[0], crs=False)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx_mimo4.ports_grid(CFG, tb0[0], tb1[0]),
                               put_crs_np(theirs, cell, c["sf_idx"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("amp", AMPS)
def test_port_decodes_like_the_reference(amp):
    """(a)"""
    x, sent = _samples(amp)
    (tb0, ok0), (tb1, ok1), snr = _entry()(x)
    r_tb, r_ok, r_snr, _r_x = rx_mimo4.pdsch4_receive(x, CFG)
    assert bool(r_ok.all()) and torch.equal(torch.stack([ok0, ok1], 1), r_ok)
    assert torch.equal(torch.stack([tb0, tb1], 1), r_tb)
    assert np.array_equal(r_tb.numpy(), sent)
    assert float((snr - r_snr).abs().max()) <= CFG["limits"]["snr_gap_db"]


@pytest.mark.parametrize("amp", AMPS)
def test_detected_layers_are_the_references(amp):
    """`detected=True` adds the first subframe's equalised layers (4, M) to
    the same results: within the configuration's `mmse_gap` of the plain
    reference's `torch.linalg.solve` (of their largest magnitude), and the
    kernel's plain form of the front end's own y, h and noise exactly."""
    x, _sent = _samples(amp)
    cell, grant = _program(CFG)
    c = CFG["cell"]
    fn = ue_dl_subframe_mimo(cell, c["sf_idx"], c["cfi"], grant, CFG["max_iterations"],
                             device="cpu", detected=True)
    (tb0, ok0), (tb1, ok1), snr, layers = fn(x)
    (e_tb0, e_ok0), (e_tb1, e_ok1), e_snr = _entry()(x)
    for a, b in ((tb0, e_tb0), (ok0, e_ok0), (tb1, e_tb1), (ok1, e_ok1), (snr, e_snr)):
        assert torch.equal(a, b)
    _r_tb, _r_ok, _r_snr, r_x = rx_mimo4.pdsch4_receive(x, CFG)
    assert layers.shape == r_x.shape == (4, 768) and layers.dtype == torch.complex64
    assert _within(layers, r_x, CFG["limits"]["mmse_gap"])
    _n_re, front_end = _dl_front_end(cell, c["sf_idx"], c["cfi"], grant.prb, 4,
                                     torch.device("cpu"))
    s = run(front_end, {"samples": x})
    w = torch.from_numpy(np.ascontiguousarray(_codebook_4(grant.pmi, 4)))
    px, _pcsi = mimo_cuda.mmse4_plain(s["y"], s["h"], w, s["noise"].reshape(-1))
    assert torch.equal(layers, px[0])


@pytest.mark.parametrize("amp", AMPS)
def test_host_pdsch_decode2_decodes_alike(amp):
    """(b): the front end's grid and channel estimate of each subframe
    through `pdsch_decode2` (spatialmux4) with that subframe's noise."""
    x, _sent = _samples(amp)
    cell, grant = _program(CFG)
    c = CFG["cell"]
    (tb0, ok0), (tb1, ok1), _snr = _entry()(x)
    _n_re, front_end = _dl_front_end(cell, c["sf_idx"], c["cfi"], grant.prb, 4,
                                     torch.device("cpu"))
    s = run(front_end[:2], {"samples": x})
    for i in range(B):
        out = pdsch_decode2(s["grid"][i], s["ce"][i], float(s["noise"][i, 0]), cell,
                            c["sf_idx"], c["cfi"], grant, CFG["max_iterations"])
        for (bits, ok, _sb), tb, flag in zip(out, (tb0, tb1), (ok0, ok1)):
            assert bool(ok) == bool(flag[i]) and np.array_equal(bits, tb[i].numpy())


def _systems(seed, m=600):
    """Seeded y (B, 4, M), h (B, 4, 4, M), noise (B,): Gaussian channels
    around a fixed matrix, so that A's condition number stays bounded."""
    g = torch.Generator().manual_seed(seed)
    base = torch.from_numpy(tx_mimo.channel(CFG))
    h = base[None, :, :, None] + 0.4 * torch.randn((B, 4, 4, m), dtype=torch.complex64,
                                                    generator=g)
    y = torch.randn((B, 4, m), dtype=torch.complex64, generator=g)
    noise = torch.tensor([1e-3, 4e-3])
    return y, h.contiguous(), noise


def _within(got, want, tol):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_plain_mmse_agrees_with_linalg(seed):
    """(c) the plain form (the kernel's arithmetic) against
    `predecode_mmse_nl` on the folded channel: x within X_TOL of its
    largest magnitude and the CSI within CSI_TOL relative (the module's
    tolerances, with their reason); the same form computed from inputs
    rounded to bf16, its results rounded too, misses both."""
    y, h, noise = _systems(seed)
    w = torch.from_numpy(np.ascontiguousarray(_codebook_4(1, 4)))
    x, csi = mimo_cuda.mmse4_plain(y, h, w, noise)
    r_x, r_csi = predecode_mmse_nl(y, _fold_precoder(h, w), noise[:, None, None, None])
    assert x.dtype == torch.complex64 and csi.dtype == torch.float32
    assert _within(x, r_x, X_TOL)
    assert float(((csi - r_csi) / r_csi).abs().max()) <= CSI_TOL

    def bf16(t):
        if t.is_complex():
            return torch.view_as_complex(bf16(torch.view_as_real(t).contiguous()))
        return t.to(torch.bfloat16).to(t.dtype)

    lx, lcsi = mimo_cuda.mmse4_plain(bf16(y), bf16(h), bf16(w), noise)
    assert not _within(bf16(lx), r_x, X_TOL)
    assert float(((bf16(lcsi) - r_csi) / r_csi).abs().max()) > CSI_TOL


def test_mmse4_checks_and_counts():
    y, h, noise = _systems(7, m=8)
    w = torch.from_numpy(np.ascontiguousarray(_codebook_4(1, 4)))
    before = trace.counts().get("mmse4_launches", 0)
    x, csi = mimo_cuda.mmse4(y, h, w, noise[:, None])
    assert trace.counts()["mmse4_launches"] == before + 1
    px, pcsi = mimo_cuda.mmse4_plain(y, h, w, noise)
    assert torch.equal(x, px) and torch.equal(csi, pcsi)
    with pytest.raises(ValueError, match="h has shape"):
        mimo_cuda.mmse4(y, h[:, :, :2], w, noise)
    with pytest.raises(ValueError, match="not contiguous"):
        mimo_cuda.mmse4(y, h.transpose(1, 2), w, noise)
    with pytest.raises(ValueError, match="dtype"):
        mimo_cuda.mmse4(y, h, w, noise.double())


def test_traced_call_spans_and_counter():
    """(d)"""
    x, sent = _samples(AMPS[0])
    fn = _entry()
    fn(x)
    before = trace.counts().get("mmse4_launches", 0)
    trace.tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            (tb0, ok0), (tb1, _ok1), _snr = fn(x)
    finally:
        trace.tracer.disable()
        trace.tracer.clear()
    assert trace.counts()["mmse4_launches"] == before + 1
    assert bool(ok0.all()) and np.array_equal(tb0.numpy(), sent[:, 0])
    ranges = sorted([(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation() and str(e.device_type()).endswith("CPU")],
                    key=lambda r: (r[1], -r[2]))
    mimo = [r for r in ranges if r[0] == "fe.mimo"]
    assert len(mimo) == 1
    eq = [r for r in ranges if r[0] == "fe.equalize"]
    assert len(eq) == 1 and eq[0][1] <= mimo[0][1] and mimo[0][2] <= eq[0][2]
    names = [r[0] for r in ranges if r[0].startswith("fe.")]
    assert names == ["fe.ofdm", "fe.chest", "fe.equalize", "fe.mimo", "fe.demap"]


def test_wrong_antennas_and_layers_raise():
    cell, grant = _program(CFG)
    fn = _entry()
    with pytest.raises(ValueError, match="4 receive antennas"):
        fn(torch.zeros((1, 2, cell.sf_len), dtype=torch.complex64))
    with pytest.raises(NotImplementedError):
        ue_dl_subframe_mimo(cell, 2, 1, DlGrant2(**{**grant.__dict__, "nof_layers": 3}),
                            device="cpu")
    with pytest.raises(NotImplementedError):
        ue_dl_subframe_mimo(Cell(nof_prb=NOF_PRB, nof_ports=2, id=301), 2, 1, grant,
                            device="cpu")
