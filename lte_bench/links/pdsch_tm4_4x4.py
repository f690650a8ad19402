"""PDSCH in closed-loop spatial multiplexing (TM4) at rank 4: two codewords,
each on two layers, from four ports into four receive antennas, decoded
by the program's `ue_dl_subframe_mimo` (`tx_scheme` "spatialmux4") over a
batch of subframes.

As `pdsch_tm4.py`: the entry is wrapped so that its results are (tb (B, 2,
tbs) uint8, ok (B, 2) bool, snr_db (B,)), codeword q at index q, and a
fourth, the equalised layers (4, M) complex64 of the batch's first
subframe (the entry's `detected`); the unit that passes is the subframe
whose two codewords pass; codeword 0 carries the TB the traffic drew for
the subframe, codeword 1 `tx_mimo.second_tb` of it.  The numbers compared
are `tb_link.CHECKS` over codewords, against the plain 4x4 reference
receiver (`ref/rx_mimo4.py`), and `mmse_gap`: over the same batches the
widest gap between the program's equalised layers and the reference's
(`rx_mimo4.mmse4`, `torch.linalg.solve` in float32), over the largest
magnitude of the reference's.  At this SNR the TBs and snr_db alone do not
see the detector: an MMSE in half precision, or one without its noise
term (zero forcing), decodes the same bits.  `mmse_shape` gives the 4x4
MMSE's work of one batch for its roofline reader.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tb_link
from ..ref import rx_mimo4, tables, tx_mimo, tx_mimo4
from . import pdsch_tm4, single

CHECKS = tb_link.CHECKS + ("mmse_gap",)
tally = pdsch_tm4.tally
# batches that the reference receiver also decodes, of those kept
REF_BATCHES = 4


def build_entry(cfg: dict, devices):
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.modem import Mod
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant2
    from srsran_tpu_torch.pipeline import ue_dl_subframe_mimo

    c, g = cfg["cell"], cfg["grant"]
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=c["nof_ports"], id=c["cell_id"])
    mod = Mod[g["mod"]]
    grant = DlGrant2(prb=tuple(range(g["prb_start"], g["prb_start"] + g["nof_prb"])),
                     mod1=mod, tbs1=g["tbs"], mod2=mod, tbs2=g["tbs"], rv1=g["rv"], rv2=g["rv"],
                     pmi=g["pmi"], rnti=g["rnti"], tx_scheme="spatialmux4",
                     nof_layers=g["nof_layers"])
    fn = ue_dl_subframe_mimo(cell, c["sf_idx"], c["cfi"], grant, cfg["max_iterations"],
                             device=single(devices), detected=True)

    def stacked(samples):
        (tb0, ok0), (tb1, ok1), snr, layers = fn(samples)
        return torch.stack([tb0, tb1], 1), torch.stack([ok0, ok1], 1), snr, layers

    return stacked


def render(cfg: dict, tb: np.ndarray) -> np.ndarray:
    return tx_mimo4.pdsch4_subframe(cfg, tb, tx_mimo.second_tb(cfg, tb))


def reference(samples, cfg: dict, precision: str | None = None):
    return rx_mimo4.pdsch4_receive(samples, cfg, precision)


def judge(kept, pool, idx, sent, cfg: dict) -> dict:
    """`tb_link.judge`'s numbers over both codewords of every subframe, and
    `mmse_gap`."""
    both = np.stack([sent, tx_mimo.second_tb(cfg, sent)], 1)  # (n_tbs, 2, tbs)
    tb_wrong, crc_diff, snr_gap, mmse_gap = 0, 0, 0.0, 0.0
    for n, (p, (tb_h, ok_h, snr_h, x_h)) in enumerate(kept):
        ok = ok_h.numpy()
        tb_wrong += int((ok & (tb_h.numpy() != both[idx[p]]).any(axis=-1)).sum())
        if n < REF_BATCHES:
            _r_tb, r_ok, r_snr, r_x = reference(pool[p], cfg)
            crc_diff += int((ok != r_ok.cpu().numpy()).sum())
            gap = np.abs(snr_h.numpy().astype(np.float64) - r_snr.cpu().numpy())
            snr_gap = max(snr_gap, float(np.nan_to_num(gap, nan=np.inf).max()))
            r_x = r_x.cpu().numpy().astype(np.complex128)
            x_gap = np.abs(x_h.numpy().astype(np.complex128) - r_x).max() / np.abs(r_x).max()
            mmse_gap = max(mmse_gap, float(np.nan_to_num(x_gap, nan=np.inf)))
    return {"tb_wrong": tb_wrong, "crc_diff": crc_diff, "snr_gap_db": snr_gap,
            "mmse_gap": mmse_gap}


def map_launch_shape(cfg: dict, batch: int) -> tuple[int, int]:
    """Both codewords' code blocks go into one MAP pass."""
    sizes, _f = tables.segment(cfg["grant"]["tbs"])
    return batch * 2 * len(sizes), max(sizes)


def mmse_shape(cfg: dict, batch: int) -> tuple[int, int]:
    """(subframes, REs a subframe) that one 4x4 MMSE launch detects."""
    return batch, len(tx_mimo4.re_indices(cfg))
