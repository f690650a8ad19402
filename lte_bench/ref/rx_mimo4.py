"""The benchmark's plain 4x4 reference receiver, in PyTorch: samples of a
batch of rank-4 TM4 subframes on four receive antennas to (TB bits, CRC
flags) of both codewords and snr_db.

It works its tables out again from the standard (`tx_mimo4.py`: the CRS
of ports 2 and 3, the 4-port RE map, the layer map and the rank-4
codebook) and imports nothing of the program.  Per receive antenna: OFDM
(`rx.ofdm_rx`); per port the CRS least squares at that port's pilots with
srsLTE's 3-tap smoothing and linear interpolation in frequency and linear
interpolation in time (held constant outside the pilot symbols: ports 2
and 3 have two, on symbols 1 and 8), the noise of the pilots' high-pass
residual and the SNR.  Then the MMSE equaliser of the effective channel
H W: A = (H W)^H (H W) + n I, x = A^-1 (H W)^H y by `torch.linalg.solve`,
each layer's CSI 1 / Re(A^-1)_ll by `torch.linalg.inv`, in float32 with
TF32 off, n the noise averaged over antennas and ports.  Codeword q is
layers 2q and 2q + 1, interleaved (§6.3.3.2); each is demapped, weighted
by its CSI, descrambled with its own c_init and decoded by `rx.sch_decode`
with the rate matcher's unit N_L Q_m (N_L = 2).  snr_db is 10 log10 of the
SNR averaged over receive antennas and ports.  The solve runs in blocks
of BLOCK subframes, to bound the (B, M, 4, 4) systems it holds.

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
from .tx_mimo import cinit
from .tx_mimo4 import LAYERS_PER_CW, NOF_PORTS, crs_layout, crs_values, precoder, re_indices

BLOCK = 32


@lru_cache(maxsize=16)
def _crs_tables(nof_prb: int, cell_id: int, sf_idx: int, port: int):
    syms, k = crs_layout(nof_prb, cell_id, port)
    sm = smooth_matrix(2 * nof_prb, 3)
    wf = np.stack([interp_matrix(k[s], 12 * nof_prb) @ sm for s in range(len(syms))])
    wt = time_matrix(tuple(syms.tolist()), T.NSYMB_SF)
    return syms, k, np.conj(crs_values(nof_prb, cell_id, sf_idx, port)), wf, wt


def chest_crs4(grid: torch.Tensor, cfg: dict, lo: Lower):
    """The four ports' channel over the grid (B, nrx, 14, nre).  Returns (ce
    (B, nrx, 4, 14, nre), noise (B, nrx, 4), snr (B, nrx, 4))."""
    c = cfg["cell"]
    dev = grid.device
    ces, noises, snrs = [], [], []
    for port in range(NOF_PORTS):
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


def mmse4(y: torch.Tensor, h: torch.Tensor, w: torch.Tensor, noise: torch.Tensor, lo: Lower):
    """y (B, nrx, M), h (B, nrx, 4 ports, M), w (4 ports, 4 layers), noise
    (B,) to (x (B, 4 layers, M), csi (B, 4, M))."""
    heff = lo.stage(torch.einsum("brpm,pl->bmrl", lo.mm(h), lo.mm(w)))  # (B, M, nrx, L)
    a = torch.einsum("bmri,bmrj->bmij", torch.conj(heff), heff)
    a = lo.stage(a + noise[:, None, None, None] * torch.eye(4, device=y.device))
    rhs = lo.stage(torch.einsum("bmri,brm->bmi", torch.conj(heff), y))[..., None]
    x = torch.linalg.solve(lo.stage(a), rhs)[..., 0]
    inv = torch.linalg.inv(a)
    csi = 1.0 / torch.diagonal(inv, dim1=-2, dim2=-1).real
    return lo.stage(x.transpose(1, 2)), lo.stage(csi.transpose(1, 2))


def equalize(samples: torch.Tensor, cfg: dict, lo: Lower):
    """(B, 4, 15 N) samples to the equalised layers x (B, 4, M), their CSI
    (B, 4, M) and the SNR (B, nrx, 4 ports)."""
    c, gr = cfg["cell"], cfg["grant"]
    dev = samples.device
    idx = torch.from_numpy(re_indices(cfg)).to(dev)
    w = torch.from_numpy(precoder(gr["pmi"])).to(dev)
    xs, csis, snrs = [], [], []
    for blk in torch.split(samples, BLOCK):
        grid = ofdm_rx(blk, c["nof_prb"], None, lo)
        ce, noise, snr = chest_crs4(grid, cfg, lo)
        b, nrx = grid.shape[:2]
        y = grid.reshape(b, nrx, -1)[..., idx]
        h = ce.reshape(b, nrx, NOF_PORTS, -1)[..., idx]
        x, csi = mmse4(y, h, w, torch.mean(noise, dim=(1, 2)), lo)
        xs.append(x)
        csis.append(csi)
        snrs.append(snr)
    return torch.cat(xs), torch.cat(csis), torch.cat(snrs)


def pdsch4_receive(samples: torch.Tensor, cfg: dict, precision: str | None = None):
    """(B, 4, 15 N) samples of rank-4 TM4 subframes to (tb (B, 2, tbs)
    uint8, ok (B, 2), snr_db (B,), the equalised layers of the first
    subframe (4, M) complex64), codeword by codeword."""
    lo = Lower(precision)
    gr = cfg["grant"]
    x, csi, snr = equalize(samples, cfg, lo)
    qm = T.QM[gr["mod"]]
    g = x.shape[-1] * qm * LAYERS_PER_CW
    tbs, oks = [], []
    for q in range(2):
        # layers 2q, 2q + 1 interleaved back into codeword q's symbols
        sym = x[:, 2 * q : 2 * q + 2].transpose(1, 2).reshape(x.shape[0], -1)
        weight = csi[:, 2 * q : 2 * q + 2].transpose(1, 2).reshape(x.shape[0], -1)
        llr = lo.stage(demap(gr["mod"], sym) * torch.repeat_interleave(weight, qm, -1))
        llr = llr * signs(cinit(cfg, q), g, samples.device)
        tb, ok = sch_decode(llr, gr["tbs"], LAYERS_PER_CW * qm, gr["rv"], cfg["max_iterations"], lo)
        tbs.append(tb)
        oks.append(ok)
    return (torch.stack(tbs, 1), torch.stack(oks, 1),
            10.0 * torch.log10(torch.mean(snr, dim=(1, 2))), x[0].to(torch.complex64))
