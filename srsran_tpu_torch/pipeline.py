"""UE DL subframe decode on the device.

Counterpart of `ue_dl_subframe` in `srsran_tpu/pipeline.py` (SISO, port-0
branch): OFDM demod → CRS channel estimate → MRC equalize → soft demod →
CSI weighting → descramble → de-rate-match → batched turbo decode → CRC.
The reference vmaps one subframe; here the leading batch axis of
subframes is written out, and every codeblock of the batch decodes in one
`turbo_decode`.
"""

from __future__ import annotations

import torch

from .device import require_cuda, table
from .phy.chest.chest_dl import chest_dl
from .phy.common import Cell
from .phy.mimo import predecode_single_mrc
from .phy.modem import demod_soft
from .phy.ofdm import OfdmConfig, ofdm_rx_sf
from .phy.phch.pdsch import DlGrant, pdsch_cinit, pdsch_re_indices
from .phy.phch.sch import TbCoding, dlsch_decode_device
from .phy.sequence import gold_sequence_signs


def ue_dl_subframe(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant,
                   max_iterations: int = 5, *, device=None):
    """Build the UE DL subframe decode for one (cell, subframe, grant).

    Returns fn(samples (B, nrx, sf_len) complex64 on `device`) ->
      (tb_bits (B, tbs) uint8, crc_ok (B,) bool, snr_db (B,) float32).
    The RE index table and the scrambling signs move to `device` once.
    `device=None` means the first CUDA device (and raises when there is
    none); the tests pass "cpu".
    """
    if grant.tx_scheme != "port0":
        raise NotImplementedError(f"tx_scheme {grant.tx_scheme!r} is not ported")
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    device = require_cuda() if device is None else torch.device(device)
    idx = table(pdsch_re_indices, cell, sf_idx, cfi, grant.prb, device=device,
                dtype=torch.int64)
    device = idx.device  # with its index ("cuda" → "cuda:0")
    g = idx.numel() * grant.qm
    coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv)
    signs = table(gold_sequence_signs, pdsch_cinit(grant.rnti, sf_idx, cell.id), g,
                  device=device)

    def fn(samples: torch.Tensor):
        if samples.device != device:
            raise ValueError(f"samples are on {samples.device}, expected {device}")
        rx_grid = ofdm_rx_sf(ofdm, samples)  # (B, nrx, nsymb, nre)
        res = chest_dl(rx_grid, cell, sf_idx, nof_ports=1)
        noise = torch.mean(res["noise"], dim=(1, 2))  # (B,)
        b, nrx = rx_grid.shape[:2]
        y = rx_grid.reshape(b, nrx, -1)[..., idx]  # (B, nrx, M)
        h = res["ce"][:, :, 0].reshape(b, nrx, -1)[..., idx]
        x, csi = predecode_single_mrc(y, h, noise[:, None])
        llr = demod_soft(grant.mod, x) * torch.repeat_interleave(csi, grant.qm, dim=-1)
        tb, ok = dlsch_decode_device(llr * signs, coding, max_iterations)
        snr_db = 10.0 * torch.log10(torch.mean(res["snr"], dim=(1, 2)))
        return tb, ok, snr_db

    return fn
