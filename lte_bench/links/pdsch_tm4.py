"""PDSCH in closed-loop spatial multiplexing (TM4): two codewords on two
layers from two ports into two receive antennas, decoded by the program's
`ue_dl_subframe_mimo` over a batch of subframes.

The entry is wrapped so that its results are (tb (B, 2, tbs) uint8, ok
(B, 2) bool, snr_db (B,)), codeword q at index q.  The unit that passes or
fails is the subframe, as `run.py` counts the subframes it attempts: one
passes when both its codewords pass their CRCs; the bits delivered are
those of every codeword that passes.  Codeword 0 carries the TB the
traffic drew for the subframe, codeword 1 `tx_mimo.second_tb` of it.
The numbers compared are `tb_link.CHECKS`, over codewords: `tb_wrong`,
CRC-passing codewords whose TB is not the one sent on that codeword;
`crc_diff`, codewords whose CRC flag differs from the plain reference
receiver's (`ref/rx_mimo.py`); `snr_gap_db`, the widest snr_db gap to it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tb_link
from ..ref import rx_mimo, tables, tx_mimo
from . import single

CHECKS = tb_link.CHECKS
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
                     pmi=g["pmi"], rnti=g["rnti"])
    fn = ue_dl_subframe_mimo(cell, c["sf_idx"], c["cfi"], grant, cfg["max_iterations"],
                             device=single(devices))

    def stacked(samples):
        (tb0, ok0), (tb1, ok1), snr = fn(samples)
        return torch.stack([tb0, tb1], 1), torch.stack([ok0, ok1], 1), snr

    return stacked


def tally(results, cfg: dict) -> tuple[int, int]:
    """(subframes whose two codewords pass, bits of the codewords that
    pass) of one batch's results on the host."""
    ok = results[1]
    return int(ok.all(1).sum()), int(ok.sum()) * cfg["grant"]["tbs"]


def render(cfg: dict, tb: np.ndarray) -> np.ndarray:
    return tx_mimo.pdsch2_subframe(cfg, tb, tx_mimo.second_tb(cfg, tb))


def reference(samples, cfg: dict, precision: str | None = None):
    return rx_mimo.pdsch2_receive(samples, cfg, precision)


def judge(kept, pool, idx, sent, cfg: dict) -> dict:
    """`tb_link.judge`'s numbers over both codewords of every subframe."""
    both = np.stack([sent, tx_mimo.second_tb(cfg, sent)], 1)  # (n_tbs, 2, tbs)
    tb_wrong, crc_diff, snr_gap = 0, 0, 0.0
    for n, (p, (tb_h, ok_h, snr_h)) in enumerate(kept):
        ok = ok_h.numpy()
        tb_wrong += int((ok & (tb_h.numpy() != both[idx[p]]).any(axis=-1)).sum())
        if n < REF_BATCHES:
            _r_tb, r_ok, r_snr = reference(pool[p], cfg)
            crc_diff += int((ok != r_ok.cpu().numpy()).sum())
            gap = np.abs(snr_h.numpy().astype(np.float64) - r_snr.cpu().numpy())
            snr_gap = max(snr_gap, float(np.nan_to_num(gap, nan=np.inf).max()))
    return {"tb_wrong": tb_wrong, "crc_diff": crc_diff, "snr_gap_db": snr_gap}


def map_launch_shape(cfg: dict, batch: int) -> tuple[int, int]:
    """Both codewords' code blocks go into one MAP pass."""
    sizes, _f = tables.segment(cfg["grant"]["tbs"])
    return batch * 2 * len(sizes), max(sizes)
