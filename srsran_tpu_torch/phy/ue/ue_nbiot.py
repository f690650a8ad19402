"""NB-IoT UE receive facade (counterpart of `srsran_tpu/phy/ue/ue_nbiot.py`:
`ue_sync_nbiot.c` / `ue_mib_nbiot.c` / `ue_dl_nbiot.c`, grid domain).

One call per processing stage over (nsf, 14, 12) anchor-carrier subframe
grids, on the device: cell acquisition (NPSS subframe phase → NSSS cell
id/frame position → MIB-NB), then NPDCCH-scheduled NPDSCH reception.
"""

from __future__ import annotations

import dataclasses

import torch

from ...device import as_samples, resolve, table
from ..phch.npbch import MibNb, npbch_decode, npbch_re_indices, nrs_equalize
from ..phch.npdsch import NB_TBS, npdcch_blind_search, npdsch_decode, npdsch_re_indices
from ..sync.nbiot import nbiot_cell_search


@dataclasses.dataclass
class NbiotCell:
    n_id_ncell: int
    mib: MibNb
    sf5_index: int  # position of the NPSS subframe in the scanned stream
    frame4: int


def nbiot_ue_acquire(sf_grids, *, device=None) -> NbiotCell | None:
    """Full acquisition from (nsf, 14, 12) grids (numpy or a tensor, moved to
    `device`: None is the card): NPSS → NSSS → MIB-NB (ue_cell_search_nbiot
    + ue_mib_nbiot flow)."""
    grids = as_samples(sf_grids, resolve(device))
    res = nbiot_cell_search(grids)
    if res is None:
        return None
    nid, sf5, f4, _ = res
    sf0 = sf5 - 5
    if sf0 < 0:
        return None
    idx = table(npbch_re_indices, nid, device=grids.device, dtype=torch.int64)
    mib, _blk, ok = npbch_decode(nrs_equalize(grids[sf0], nid, 0, idx), nid)
    if not ok:
        return None
    return NbiotCell(nid, mib, sf5, f4)


def nbiot_ue_rx_data(ctrl_grid, data_grids, cell: NbiotCell, rnti: int, sf_idx_ctrl: int,
                     sf_idx_data0: int, *, device=None):
    """Decode an NPDCCH DCI N1 from `ctrl_grid` (14, 12), then the scheduled
    NPDSCH from `data_grids` (n_sf, 14, 12), each equalised by its own NRS
    estimate; numpy or tensors, moved to `device` (None: the card).

    Returns (DciN1, tb_bits, ok) or (None, None, False)."""
    device = resolve(device)
    nid = cell.n_id_ncell
    idx = table(npdsch_re_indices, nid, device=device, dtype=torch.int64)
    ctrl = as_samples(ctrl_grid, device)
    dci = npdcch_blind_search(nrs_equalize(ctrl, nid, sf_idx_ctrl, idx), rnti, nid, sf_idx_ctrl)
    if dci is None:
        return None, None, False
    tbs = NB_TBS[(dci.i_tbs, dci.i_sf)]
    data = as_samples(data_grids, device)
    sym = torch.stack([nrs_equalize(g, nid, sf_idx_data0 + s, idx) for s, g in enumerate(data)])
    tb, ok = npdsch_decode(sym, nid, rnti, dci.i_sf, tbs, sf_idx0=sf_idx_data0)
    return dci, tb, ok
