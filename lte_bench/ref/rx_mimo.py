"""The benchmark's plain 2x2 reference receiver, in PyTorch: samples of a
batch of TM4 subframes on two receive antennas to (TB bits, CRC flags) of
both codewords and snr_db.

It works out its tables again from the standard (`tables.py`, TS 36.211
§6.10.1 for the CRS of ports 0 and 1) and imports nothing of the program.
Per receive antenna: OFDM (`rx.ofdm_rx`), then per port the CRS least
squares at that port's pilots with srsLTE's 3-tap smoothing and linear
interpolation in frequency and linear interpolation in time, the noise of
the pilots' high-pass residual and the SNR.  Then the MMSE equaliser of the
effective channel H W(PMI): A = (H W)^H (H W) + n I, x = A^-1 (H W)^H y,
each layer's CSI 1 / Re(A^-1)_ll, with n the noise averaged over antennas
and ports; codeword q is layer q (§6.3.3.2).  Each codeword is demapped,
weighted by its CSI, descrambled with its own c_init and decoded by
`rx.sch_decode`.  snr_db is 10 log10 of the SNR averaged over receive
antennas and ports.

`precision` makes the control, as in `rx.py`: None is float32 throughout
(TF32 off), "bf16" rounds the result of every stage to bfloat16 and "tf32"
the operands of every product to TF32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tables as T
from .rx import Lower, demap, interp_matrix, ofdm_rx, sch_decode, signs, smooth_matrix, time_matrix
from .tx_mimo import cinit, precoder, re_indices


@lru_cache(maxsize=8)
def _crs_tables(nof_prb: int, cell_id: int, sf_idx: int, port: int):
    syms, k = T.crs_layout(nof_prb, cell_id, port)
    sm = smooth_matrix(2 * nof_prb, 3)
    wf = np.stack([interp_matrix(k[s], 12 * nof_prb) @ sm for s in range(4)])
    wt = time_matrix(tuple(syms.tolist()), T.NSYMB_SF)
    return syms, k, np.conj(T.crs_values(nof_prb, cell_id, sf_idx)), wf, wt


def chest_crs2(grid: torch.Tensor, cfg: dict, lo: Lower):
    """Both ports' channel over the grid (B, nrx, 14, nre).  Returns (ce
    (B, nrx, 2, 14, nre), noise (B, nrx, 2), snr (B, nrx, 2))."""
    c = cfg["cell"]
    dev = grid.device
    ces, noises, snrs = [], [], []
    for port in range(2):
        syms, k, ref, wf, wt = _crs_tables(c["nof_prb"], c["cell_id"], c["sf_idx"], port)
        ls = lo.stage(grid[..., torch.from_numpy(syms)[:, None].to(dev), torch.from_numpy(k).to(dev)]
                      * torch.from_numpy(ref).to(dev))
        wf_t = torch.from_numpy(wf).to(dev).to(torch.complex64)
        wt_t = torch.from_numpy(wt).to(dev).to(torch.complex64)
        per_sym = torch.einsum("snp,...sp->...sn", lo.mm(wf_t), lo.mm(ls))
        ces.append(lo.stage(torch.einsum("ls,...sn->...ln", lo.mm(wt_t), lo.mm(per_sym))))
        resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
        noise = lo.stage(torch.mean(resid.abs() ** 2, dim=(-1, -2)) / 1.5)
        rsrp = lo.stage(torch.mean(ls.abs() ** 2, dim=(-1, -2)))
        noises.append(noise)
        snrs.append(lo.stage(rsrp / torch.clamp(noise, min=1e-12)))
    return torch.stack(ces, 2), torch.stack(noises, -1), torch.stack(snrs, -1)


def mmse2(y: torch.Tensor, h: torch.Tensor, w: torch.Tensor, noise: torch.Tensor, lo: Lower):
    """y (B, nrx, M), h (B, nrx, 2 ports, M), w (2 ports, 2 layers), noise
    (B, 1) to (x (B, 2 layers, M), csi (B, 2, M))."""
    heff = lo.stage(torch.einsum("brpm,pl->brlm", lo.mm(h), lo.mm(w)))
    # A[i, j] = sum_r conj(heff[r, i]) heff[r, j] + n delta_ij, b = heff^H y
    a = torch.einsum("brim,brjm->bijm", torch.conj(heff), heff)
    a = a + noise[:, :, None, None] * torch.eye(2, device=y.device)[None, :, :, None]
    b = torch.einsum("brim,brm->bim", torch.conj(heff), y)
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    # A^-1 = adj(A) / det
    inv = torch.stack([torch.stack([a[:, 1, 1], -a[:, 0, 1]], 1),
                       torch.stack([-a[:, 1, 0], a[:, 0, 0]], 1)], 1) / det[:, None, None]
    inv = lo.stage(inv)
    x = torch.einsum("bijm,bjm->bim", inv, b)
    csi = 1.0 / torch.stack([inv[:, 0, 0].real, inv[:, 1, 1].real], 1)
    return lo.stage(x), lo.stage(csi)


def equalize(samples: torch.Tensor, cfg: dict, lo: Lower):
    """(B, 2, 15 N) samples to the equalised layers x (B, 2, M), their CSI
    (B, 2, M) and the SNR (B, nrx, 2 ports)."""
    c, gr = cfg["cell"], cfg["grant"]
    grid = ofdm_rx(samples, c["nof_prb"], None, lo)
    ce, noise, snr = chest_crs2(grid, cfg, lo)
    b, nrx = grid.shape[:2]
    idx = torch.from_numpy(re_indices(cfg)).to(samples.device)
    y = grid.reshape(b, nrx, -1)[..., idx]
    h = ce.reshape(b, nrx, 2, -1)[..., idx]
    w = torch.from_numpy(precoder(gr["pmi"])).to(samples.device)
    x, csi = mmse2(y, h, w, torch.mean(noise, dim=(1, 2))[:, None], lo)
    return x, csi, snr


def pdsch2_receive(samples: torch.Tensor, cfg: dict, precision: str | None = None):
    """(B, 2, 15 N) samples of TM4 subframes to (tb (B, 2, tbs) uint8, ok
    (B, 2), snr_db (B,)), codeword by codeword."""
    lo = Lower(precision)
    gr = cfg["grant"]
    x, csi, snr = equalize(samples, cfg, lo)
    qm = T.QM[gr["mod"]]
    g = x.shape[-1] * qm
    tbs, oks = [], []
    for q in range(2):
        llr = lo.stage(demap(gr["mod"], x[:, q]) * torch.repeat_interleave(csi[:, q], qm, -1))
        llr = llr * signs(cinit(cfg, q), g, samples.device)
        tb, ok = sch_decode(llr, gr["tbs"], qm, gr["rv"], cfg["max_iterations"], lo)
        tbs.append(tb)
        oks.append(ok)
    return torch.stack(tbs, 1), torch.stack(oks, 1), 10.0 * torch.log10(torch.mean(snr, dim=(1, 2)))
