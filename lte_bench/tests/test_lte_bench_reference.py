"""The benchmark's transmitter and reference receiver against the
program: the transmitter's grids equal the program's host transmitter bit
for bit at 100 PRB and its samples agree to float32 rounding; the
reference receiver gives the program's results on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from lte_bench import stimuli
from lte_bench.ref import rx, tx
from lte_bench.tests.small import REPO

CFG = {n: json.loads((REPO / f"lte_bench/configs/{n}.json").read_text())
       for n in ("lte20_fdd_dl_siso", "lte20_fdd_ul_pusch")}


def _cell(cfg):
    from srsran_tpu_torch.phy.common import Cell

    c = cfg["cell"]
    return Cell(nof_prb=c["nof_prb"], nof_ports=c["nof_ports"], id=c["cell_id"])


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_pdsch_transmitter_matches_the_program(seed):
    from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu_torch.phy.modem import Mod
    from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, pdsch_encode_np

    cfg = CFG["lte20_fdd_dl_siso"]
    c, g = cfg["cell"], cfg["grant"]
    tb = stimuli.draw_tbs(seed, 1, g["tbs"])[0]
    cell = _cell(cfg)
    grant = DlGrant(prb=tuple(range(g["prb_start"], g["prb_start"] + g["nof_prb"])),
                    mod=Mod[g["mod"]], tbs=g["tbs"], rv=g["rv"], rnti=g["rnti"])
    grid = put_crs_np(pdsch_encode_np(cell, c["sf_idx"], c["cfi"], grant, tb), cell, c["sf_idx"])
    assert np.array_equal(tx.pdsch_grid(cfg, tb), grid[0])
    theirs = ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), torch.from_numpy(grid)).numpy()
    ours = tx.pdsch_subframe(cfg, tb)
    assert np.abs(ours - theirs).max() <= 4 * np.finfo(np.float32).eps * np.abs(theirs).max()


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_pusch_transmitter_matches_the_program(seed):
    from srsran_tpu_torch.phy.modem import Mod
    from srsran_tpu_torch.phy.phch.pusch import UlGrant, pusch_encode_np
    from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode

    cfg = CFG["lte20_fdd_ul_pusch"]
    c, g = cfg["cell"], cfg["grant"]
    tb = stimuli.draw_tbs(seed, 1, g["tbs"])[0]
    cell = _cell(cfg)
    grant = UlGrant(prb_start=g["prb_start"], nof_prb=g["nof_prb"], mod=Mod[g["mod"]],
                    tbs=g["tbs"], rv=g["rv"], rnti=g["rnti"])
    assert np.array_equal(tx.pusch_grid(cfg, tb), pusch_encode_np(cell, c["sf_idx"], grant, tb))
    theirs = ue_ul_encode(cell, c["sf_idx"], pusch=(grant, tb), device="cpu").numpy()
    ours = tx.pusch_subframe(cfg, tb)[0]
    assert np.abs(ours - theirs).max() <= 4 * np.finfo(np.float32).eps * np.abs(theirs).max()


@pytest.mark.parametrize("link", ["pdsch_siso", "pusch"])
def test_reference_receiver_gives_the_programs_results(tmp_path, link):
    """At 25 PRB on the CPU the reference's CRC flags and TB bits equal the
    program's, and its snr_db lies within 1e-5 dB of the program's."""
    from lte_bench import catalog
    from lte_bench.tests.small import make_root

    root = make_root(tmp_path)
    _w, cfg, mix = catalog.cell(root, "dl_small" if link == "pdsch_siso" else "ul_small")
    mod = catalog.link(cfg)
    sent = stimuli.draw_tbs(3, mix["n_tbs"], cfg["grant"]["tbs"])
    pool = stimuli.build_pool(torch.from_numpy(stimuli.render(mod, cfg, sent)), mix, 3)
    tb, ok, snr = mod.build_entry(cfg, ["cpu"])(pool[0])
    r_tb, r_ok, r_snr = mod.reference(pool[0], cfg)
    assert ok.all() and torch.equal(ok, r_ok) and torch.equal(tb, r_tb)
    assert torch.equal(tb, torch.from_numpy(sent[stimuli.tb_index(mix)[0]]))
    assert float((snr - r_snr).abs().max()) <= 1e-5
