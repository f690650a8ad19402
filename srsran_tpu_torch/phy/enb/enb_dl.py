"""eNB downlink subframe: the schedule and the facade that renders it.

Counterpart of `srsran_tpu/phy/enb/enb_dl.py` (`lib/src/phy/enb/enb_dl.c`,
API enb_dl.h:99-122).  `enb_dl_subframe` renders PSS/SSS, PBCH, PCFICH,
PHICH, PDCCH, PDSCH and CRS into a resource grid on the host with the
port's writers, then OFDM-modulates it on the device.  With a `TddConfig`
it renders frame structure 2, which the upstream eNB does not
(enb_dl.c:658): UL subframes empty, the sync signals at their TDD
symbols, special subframes only up to the end of the DwPTS.  `DlSched` is also
what `pipeline_ctrl.enb_ctrl_overlay` renders.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve
from ..chest.refsignal_dl import put_crs_np
from ..common import Cell
from ..mimo import precode_diversity2
from ..ofdm import OfdmConfig, ofdm_tx_sf
from ..phch.pbch import Mib, pbch_encode_np, pbch_re_indices
from ..phch.pcfich import pcfich_put_np
from ..phch.pdcch import pdcch_put_np
from ..phch.pdsch import DlGrant2, pdsch_encode2_np, pdsch_encode_np
from ..phch.phich import phich_put_np
from ..sync.pss import put_pss_grid
from ..sync.sss import put_sss_grid
from .. import tdd as tdd_mod


@dataclasses.dataclass
class DlSched:
    """One subframe's schedule (the FAPI-like pull result, mac get_dl_sched)."""

    cfi: int = 1
    # list of (dci_bits, rnti, agg_level, cce_start)
    dcis: list = dataclasses.field(default_factory=list)
    # list of (grant, tb_bits)
    grants: list = dataclasses.field(default_factory=list)
    # list of (group, n_seq, ack)
    phich: list = dataclasses.field(default_factory=list)


def enb_dl_subframe(cell: Cell, sf_idx: int, sched: DlSched, mib: Mib | None = None,
                    sfn: int = 0, tdd=None, *, device=None) -> tuple[np.ndarray, torch.Tensor]:
    """Render one DL subframe.  Returns (grid (nports, nsymb, nre)
    complex64 numpy, samples (nports, sf_len) complex64 on `device`, None
    being the card).

    ``tdd`` (a `TddConfig`): a UL subframe comes out empty, PSS moves to
    symbol 2 of sf 1/6 and SSS to the last symbol of sf 0/5 (TS 36.211
    §6.11), and a special subframe carries only its DwPTS symbols."""
    dev = resolve(device)
    nof_ports = max(cell.nof_ports, 1)
    grid = np.zeros((nof_ports, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    sftype = tdd_mod.sf_type(tdd, sf_idx)
    if sftype == tdd_mod.SfType.U:
        return grid, ofdm_tx_sf(ofdm, torch.from_numpy(grid).to(dev))
    last_symbol = tdd_mod.nof_dw(tdd) if sftype == tdd_mod.SfType.S else None
    for p in range(nof_ports):
        if tdd is None:
            if sf_idx in (0, 5):
                put_pss_grid(grid[p], cell.n_id_2, cell.nof_prb, cell.nsymb_per_slot - 1)
                put_sss_grid(grid[p], cell.n_id_1, cell.n_id_2, sf_idx, cell.nof_prb,
                             cell.nsymb_per_slot - 2)
        else:
            if sf_idx in (1, 6):
                put_pss_grid(grid[p], cell.n_id_2, cell.nof_prb, 2)
            if sf_idx in (0, 5):
                put_sss_grid(grid[p], cell.n_id_1, cell.n_id_2, sf_idx, cell.nof_prb,
                             cell.nsymb_per_sf - 1)
    if sf_idx == 0 and mib is not None:
        syms = pbch_encode_np(dataclasses.replace(mib, sfn=sfn), cell, nof_ports)[sfn % 4]
        idx = pbch_re_indices(cell)
        if nof_ports >= 2:
            # SFBC across the first two ports (TS 36.211 §6.6.3)
            ports = precode_diversity2(syms.astype(np.complex64))
            for p in range(2):
                grid[p].reshape(-1)[idx] = ports[p]
        else:
            grid[0].reshape(-1)[idx] = syms

    ctrl_grid = grid if nof_ports >= 2 else grid[0]
    pcfich_put_np(ctrl_grid, cell, sf_idx, sched.cfi)
    for group, n_seq, ack in sched.phich:
        phich_put_np(ctrl_grid, cell, sf_idx, group, n_seq, ack)
    for dci_bits, rnti, agg, cce in sched.dcis:
        pdcch_put_np(ctrl_grid, cell, sf_idx, sched.cfi, dci_bits, rnti, agg, cce)
    for grant, tb in sched.grants:
        if isinstance(grant, DlGrant2):
            # two codewords (TM3/TM4); tb = (tb1, tb2)
            pg = pdsch_encode2_np(cell, sf_idx, sched.cfi, grant, tb[0], tb[1])
        else:
            pg = pdsch_encode_np(cell, sf_idx, sched.cfi, grant, tb, tdd=tdd is not None,
                                 last_symbol=last_symbol)
        grid[: pg.shape[0]] += pg
    put_crs_np(grid, cell, sf_idx)
    if last_symbol is not None:
        grid[:, last_symbol:, :] = 0  # GP + UpPTS: the eNB is silent past the DwPTS
    samples = ofdm_tx_sf(ofdm, torch.from_numpy(grid).to(dev))
    return grid, samples
