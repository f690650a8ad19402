"""PUSCH without UCI from one UE antenna into one eNB antenna, decoded by
the program's `enb_ul_subframe` over a batch of subframes."""

from __future__ import annotations

import numpy as np

from .. import tb_link
from ..ref import rx, tables, tx
from . import single

CHECKS = tb_link.CHECKS
tally = tb_link.tally
# batches that the reference receiver also decodes, of those kept
REF_BATCHES = 4


def build_entry(cfg: dict, devices):
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.modem import Mod
    from srsran_tpu_torch.phy.phch.pusch import UlGrant
    from srsran_tpu_torch.pipeline import enb_ul_subframe

    c, g = cfg["cell"], cfg["grant"]
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=c["nof_ports"], id=c["cell_id"])
    grant = UlGrant(prb_start=g["prb_start"], nof_prb=g["nof_prb"], mod=Mod[g["mod"]],
                    tbs=g["tbs"], rv=g["rv"], rnti=g["rnti"])
    return enb_ul_subframe(cell, c["sf_idx"], grant, cfg["max_iterations"], device=single(devices))


def render(cfg: dict, tb: np.ndarray) -> np.ndarray:
    return tx.pusch_subframe(cfg, tb)


def reference(samples, cfg: dict, precision: str | None = None):
    return rx.pusch_receive(samples, cfg, precision)


def judge(kept, pool, idx, sent, cfg: dict) -> dict:
    return tb_link.judge(kept, pool, idx, sent, cfg, reference, REF_BATCHES)


def map_launch_shape(cfg: dict, batch: int) -> tuple[int, int]:
    sizes, _f = tables.segment(cfg["grant"]["tbs"])
    return batch * len(sizes), max(sizes)
