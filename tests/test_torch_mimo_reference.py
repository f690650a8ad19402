"""The port's 2x2 TM4 decode against the benchmark's plain 2x2 reference
(`lte_bench/ref/tx_mimo.py`, `lte_bench/ref/rx_mimo.py`) on the CPU at
15 PRB, B = 2: seeded random TBs on both codewords (64QAM, MCS 26, two
code blocks each) behind the configuration's fixed 2x2 channel, seeded
white noise at two amplitudes (0.045 is the cell's).

- The reference transmitter's precoded grid equals the port's
  `pdsch_encode2_np` (and with the CRS of both ports, `put_crs_np` of it)
  to 1e-6.
- `ue_dl_subframe_mimo` gives the reference receiver's TB bits and CRC
  flags exactly, and its snr_db within the configuration's `snr_gap_db`.
- The equalised layers agree to 1e-5 of their largest magnitude: both
  sides estimate the channel with the same matrices and solve the same
  2x2 system, the port by Cramer's rule in complex64, the reference by the
  adjugate.  Their float32 sums run in another order: the layers and the
  CSI differ by about 6e-7 of their largest value; 1e-5 leaves room for
  other seeds and summation orders and is still far below a wrong fold or
  solve.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lte_bench.ref import rx, rx_mimo, tx_mimo
from srsran_tpu_torch.graphs import run
from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.mimo import layerdemap, predecode_zf_mmse
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
from srsran_tpu_torch.pipeline import _dl_front_end, ue_dl_subframe_mimo

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NOF_PRB, MCS, B = 15, 26, 2
AMPS = (0.02, 0.045)
LAYER_TOL = 1e-5


def _cfg():
    cfg = json.loads((REPO / "lte_bench/configs/lte20_fdd_dl_tm4_2x2.json").read_text())
    cfg["cell"]["nof_prb"] = NOF_PRB
    cfg["grant"].update(nof_prb=NOF_PRB, mcs=MCS, mod=dl_mcs_to_mod(MCS).name,
                        tbs=dl_tbs(MCS, NOF_PRB))
    return cfg


CFG = _cfg()


def _program(cfg):
    c, g = cfg["cell"], cfg["grant"]
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=2, id=c["cell_id"])
    mod = Mod[g["mod"]]
    grant = DlGrant2(prb=tuple(range(g["nof_prb"])), mod1=mod, tbs1=g["tbs"], mod2=mod,
                     tbs2=g["tbs"], pmi=g["pmi"], rnti=g["rnti"])
    return cell, grant


def _tbs(seed):
    tb = np.random.default_rng([seed, 0]).integers(0, 2, (B, CFG["grant"]["tbs"]), dtype=np.uint8)
    return tb, tx_mimo.second_tb(CFG, tb)


def _samples(amp):
    """(B, 2, 15 N) received subframes and their (B, 2, tbs) sent TBs."""
    tb0, tb1 = _tbs(int(amp * 1000))
    clean = np.stack([tx_mimo.pdsch2_subframe(CFG, a, b) for a, b in zip(tb0, tb1)])
    rng = np.random.default_rng([int(amp * 1000), 1])
    noise = rng.standard_normal(clean.shape + (2,)).astype(np.float32)
    x = clean + amp * (noise[..., 0] + 1j * noise[..., 1])
    return torch.from_numpy(x.astype(np.complex64)), np.stack([tb0, tb1], 1)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_transmitter_grid_matches_the_program(seed):
    tb0, tb1 = _tbs(seed)
    cell, grant = _program(CFG)
    c = CFG["cell"]
    theirs = pdsch_encode2_np(cell, c["sf_idx"], c["cfi"], grant, tb0[0], tb1[0])
    ours = tx_mimo.ports_grid(CFG, tb0[0], tb1[0], crs=False)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx_mimo.ports_grid(CFG, tb0[0], tb1[0]),
                               put_crs_np(theirs, cell, c["sf_idx"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("amp", AMPS)
def test_port_decodes_like_the_reference(amp):
    x, sent = _samples(amp)
    cell, grant = _program(CFG)
    c = CFG["cell"]
    fn = ue_dl_subframe_mimo(cell, c["sf_idx"], c["cfi"], grant, CFG["max_iterations"],
                             device="cpu")
    (tb0, ok0), (tb1, ok1), snr = fn(x)
    r_tb, r_ok, r_snr = rx_mimo.pdsch2_receive(x, CFG)
    assert torch.equal(torch.stack([ok0, ok1], 1), r_ok) and bool(r_ok.all())
    assert torch.equal(torch.stack([tb0, tb1], 1), r_tb)
    assert np.array_equal(r_tb.numpy(), sent)
    assert float((snr - r_snr).abs().max()) <= CFG["limits"]["snr_gap_db"]


@pytest.mark.parametrize("amp", AMPS)
def test_equalized_layers_agree(amp):
    x, _sent = _samples(amp)
    cell, grant = _program(CFG)
    c = CFG["cell"]
    _n_re, front_end = _dl_front_end(cell, c["sf_idx"], c["cfi"], grant.prb, 2,
                                     torch.device("cpu"))
    s = run(front_end, {"samples": x})
    xl, csi = predecode_zf_mmse(s["y"], s["h"], 2, s["noise"], pmi=grant.pmi)
    r_x, r_csi, _r_snr = rx_mimo.equalize(x, CFG, rx.Lower(None))
    for got, want in ((xl, r_x), (csi, r_csi)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= LAYER_TOL * scale
    # codeword q is layer q
    assert torch.equal(layerdemap(xl, 2)[1], xl[:, 1])
