"""Adaptive Wiener DL channel estimator (role of `wiener_dl.c`).

Counterpart of `srsran_tpu/phy/chest/wiener_dl.py`.  The reference's
SRSLTE_ESTIMATOR_ALG_WIENER measures the channel's frequency
autocorrelation online from LS pilot estimates (random 2-PRB subbands into
FIFOs, FFT low-pass, 8x8 matrix inverse per update — wiener_dl.c:546-751)
and filters pilots through the resulting Wiener matrices.  Here:

- the state is a dict of tensors on the grid's device (the EMA of the
  3-RE-lag autocorrelation and an update count), threaded through calls;
- the autocorrelation is measured at 3-subcarrier resolution by
  interleaving the two CRS shifts (v, v+3) of each slot (the reference's
  `hlsv` interleave, wiener_dl.c:613-620);
- the power-delay profile comes from one DFT of the tapered, symmetrized
  autocorrelation, clamped to non-negative delay power (wiener_dl.c:
  664-667);
- the subband Wiener matrices are one 8x8 `torch.linalg.inv` (complex64)
  and three small products per subframe.

`chest_dl_adaptive` reads nothing back to the host: the update factor and
every gate are tensor operations, so a call queues on the device.  Use
`wiener_init()` once, then `chest_dl_adaptive(...)` per subframe, threading
the returned state.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import table
from ..common import Cell
from .chest_dl import ChestDlConfig, _device_tables
from .refsignal_dl import crs_positions

DEFAULT_NLAGS = 32  # autocorrelation lags kept (in units of 3 subcarriers)
NREF = 8  # pilots per subband window (SRSLTE_WIENER_DL_MIN_REF)


def wiener_init(nlags: int = DEFAULT_NLAGS) -> dict:
    """Fresh estimator state (CPU tensors; `chest_dl_adaptive` takes it to
    the grid's device).  `r3[m]` is the EMA of the channel frequency
    autocorrelation at a lag of 3*m subcarriers; r3[0] = 1 (flat prior), so
    the first subframes behave like the averaging estimator until
    adaptation takes over."""
    r3 = torch.zeros(nlags, dtype=torch.complex64)
    r3[0] = 1.0
    return {"r3": r3, "count": torch.zeros((), dtype=torch.float32)}


def _lag_tables(k: int, nlags: int):
    """(idx (nlags, K) clipped at K-1, valid (nlags, K) float32)."""
    idx = np.arange(k)[None, :] + np.arange(nlags)[:, None]
    return idx.clip(max=k - 1), (idx < k).astype(np.float32)


def _measure_r3(ls: torch.Tensor, v_first: bool, nlags: int) -> torch.Tensor:
    """Autocorrelation of the channel across frequency at 3-RE lags.

    ls: (..., 4, npil) LS estimates on the port-0/1 CRS layout (symbol
    shifts alternate v, v+3).  Interleaves each slot's symbol pair into a
    3-RE-spaced vector (..., 2, 2*npil) and correlates."""
    s0 = ls[..., 0::2, :]  # shift v   (..., 2, npil)
    s1 = ls[..., 1::2, :]  # shift v+3
    pair = (s0, s1) if v_first else (s1, s0)
    h3 = torch.stack(pair, dim=-1).reshape(*ls.shape[:-2], 2, -1)  # (..., 2, K)
    k = h3.shape[-1]
    idx, valid = table(_lag_tables, k, nlags, device=ls.device)
    prod = torch.conj(h3)[..., None, :] * h3[..., idx] * valid  # (..., 2, nlags, K)
    den = valid.sum(-1) * (int(np.prod(ls.shape[:-2])) * 2) + 1e-9
    r3 = prod.sum(dim=tuple(range(prod.ndim - 2)) + (-1,)) / den
    return (r3 / torch.clamp(r3[0].abs(), min=1e-12)).to(torch.complex64)


def _pdp_tables(nlags: int):
    """(taper (n,) float32, analysis (n, n) complex64) of `_pdp`."""
    n = 2 * nlags - 1
    m = np.arange(-(nlags - 1), nlags)
    taper = (np.cos(np.pi * np.abs(m) / (2 * nlags)) ** 2).astype(np.float32)
    analysis = (np.exp(2j * np.pi * np.outer(m, np.arange(n)) / n) / n).astype(np.complex64)
    return taper, analysis


def _pdp(r3: torch.Tensor) -> torch.Tensor:
    """Delay-power profile: one DFT of the tapered, symmetrized
    autocorrelation, clamped to non-negative power and renormalized to
    r(0).  The Hann taper over lags keeps leakage sidelobes from surviving
    the clamp as phantom delay power."""
    taper, analysis = table(_pdp_tables, r3.shape[0], device=r3.device)
    r_sym = torch.cat([torch.conj(torch.flip(r3[1:], [0])), r3]) * taper
    pdp = torch.clamp((r_sym @ analysis).real, min=0.0)  # (n,)
    return pdp * r3[0].abs() / torch.clamp(pdp.sum(), min=1e-12)


def _delay_bins(nlags: int) -> np.ndarray:
    """Signed delay values per PDP bin: the top half of the DFT grid is
    NEGATIVE delay (timing skew).  At integer lags the two readings agree;
    at fractional RE lags only the signed form extrapolates correctly."""
    n = 2 * nlags - 1
    d = np.arange(n)
    return np.where(d < n / 2, d, d - n)


def _basis_np(pos: tuple, nlags: int) -> np.ndarray:
    n = 2 * nlags - 1
    return np.exp(-2j * np.pi * np.outer(np.asarray(pos) / 3.0, _delay_bins(nlags)) / n
                  ).astype(np.complex64)


def _basis(pos: np.ndarray, nlags: int, device) -> torch.Tensor:
    """Synthesis basis E[i,d] = exp(-j*2*pi*pos_i*d/(3n)), so that any
    correlation submatrix factors as r(pos_a - pos_b) = (E_a*pdp) E_b^H
    (the Wiener build stays O(len*n))."""
    return table(_basis_np, tuple(float(p) for p in pos), nlags, device=device)


def _pil_windows(nblk: int) -> np.ndarray:
    """(nblk, 8) pilot indices of the centre blocks' windows (block b
    starts at PRB 2 + 2b)."""
    blk_starts = 2 + 2 * np.arange(nblk)
    return ((blk_starts - 1) * 2)[:, None] + np.arange(NREF)


def wiener_adapt(state: dict, ls: torch.Tensor, v_first: bool = True,
                 alpha: float = 0.25) -> dict:
    """EMA-update the state from this subframe's LS pilot estimates."""
    r3_new = _measure_r3(ls, v_first, state["r3"].shape[0])
    count = state["count"]
    a = torch.clamp(1.0 / (count + 1.0), min=alpha)  # fast initial convergence
    return {"r3": ((1 - a) * state["r3"] + a * r3_new).to(torch.complex64),
            "count": count + 1.0}


def chest_dl_adaptive(grid: torch.Tensor, cell: Cell, sf_idx: int, state: dict,
                      cfg: ChestDlConfig = ChestDlConfig(), nof_ports: int | None = None):
    """Like `chest_dl.chest_dl`, but frequency filtering uses Wiener
    matrices built from the runtime-adapted autocorrelation in `state`.
    grid: (..., nsymb_sf, nre) complex64 on its device.  Returns
    (result_dict, new_state), both on the grid's device."""
    dev = grid.device
    state = {k: v.to(dev) for k, v in state.items()}
    nof_ports = nof_ports or min(cell.nof_ports, 2)
    nre = cell.nof_re_per_symbol
    noises, rsrps, lss, tabs = [], [], [], []
    for p in range(nof_ports):
        syms, freqs, ref_conj, _wf, wt = table(_device_tables, cell, sf_idx, cfg, p, device=dev)
        tabs.append(wt)
        ls = grid[..., syms, freqs] * ref_conj
        lss.append(ls)
        resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
        noises.append(torch.mean(resid.abs() ** 2, dim=(-1, -2)) / 1.5)
        rsrps.append(torch.mean(ls.abs() ** 2, dim=(-1, -2)))

    # The [-1/2, 1, -1/2] residual holds channel curvature as well as noise;
    # the adapted autocorrelation lets us subtract it:
    # E|resid|^2 = 1.5*noise + (1.5 - 2*Re r(6) + 0.5*Re r(12)) * signal.
    nlags = state["r3"].shape[0]
    pdp_prev = _pdp(state["r3"]).to(torch.complex64)
    r_c = (_basis(np.array([0.0, 6.0, 12.0]), nlags, dev) * pdp_prev).sum(-1).real
    curv = torch.clamp(1.5 * r_c[0] - 2.0 * r_c[1] + 0.5 * r_c[2], min=0.0)
    noises = [torch.maximum(n - curv * r / 1.5, 0.02 * n) for n, r in zip(noises, rsrps)]

    # adapt on port 0 (the reference averages over tx/rx; port 0's CRS
    # density sets the filter, the others share the statistics)
    _syms0, freqs0 = crs_positions(cell, 0)
    new_state = wiener_adapt(state, lss[0], v_first=int(freqs0[0][0]) < int(freqs0[1][0]))

    # Subband Wiener, the reference's estimate_wiener geometry (wiener_dl.c:
    # 503-530): 8-pilot windows -> 48-RE edge bands + 24-RE sliding center
    # blocks, each lag below the delay basis' period
    pdp = _pdp(new_state["r3"]).to(torch.complex64)
    e_p6 = _basis(np.arange(NREF) * 6.0, nlags, dev)
    r_pp = (e_p6 * pdp) @ e_p6.conj().T
    noise_rel = torch.clamp(torch.mean(torch.stack(noises)) /
                            torch.clamp(torch.mean(torch.stack(rsrps)), min=1e-12), min=1e-3)
    r_inv = torch.linalg.inv(r_pp + noise_rel * torch.eye(NREF, dtype=torch.complex64, device=dev))

    def wiener_matrix(re_pos: np.ndarray, pil_pos: np.ndarray) -> torch.Tensor:
        e_re, e_pil = _basis(re_pos, nlags, dev), _basis(pil_pos, nlags, dev)
        return ((e_re * pdp) @ e_pil.conj().T) @ r_inv

    npil = freqs0.shape[1]
    nblk = max(0, (cell.nof_prb - 4) // 2)  # center 24-RE blocks
    pil_win = table(_pil_windows, nblk, device=dev)  # (nblk, 8)

    ces = []
    for p in range(nof_ports):
        _syms, freqs = crs_positions(cell, p)
        per_sym = []
        for s in range(len(freqs)):
            v = float(freqs[s][0])
            ls = lss[p][..., s, :]
            # the lower and upper 48-RE edge bands share one matrix (same lags)
            w_edge = wiener_matrix(np.arange(48.0), v + 6.0 * np.arange(NREF))
            h = torch.zeros((*ls.shape[:-1], nre), dtype=torch.complex64, device=dev)
            h[..., :48] = torch.einsum("np,...p->...n", w_edge, ls[..., :NREF])
            h[..., nre - 48:] = torch.einsum("np,...p->...n", w_edge, ls[..., npil - NREF:])
            if nblk:
                w_ctr = wiener_matrix(12.0 + np.arange(24.0), v + 6.0 * np.arange(NREF))
                ctr = torch.einsum("np,...bp->...bn", w_ctr, ls[..., pil_win])
                h[..., 24:24 + nblk * 24] = ctr.reshape(*ls.shape[:-1], nblk * 24)
            per_sym.append(h)
        ces.append(torch.einsum("ls,...sn->...ln", tabs[p], torch.stack(per_sym, dim=-2)))
    ce = torch.stack(ces, dim=-3).to(torch.complex64)
    noise = torch.stack(noises, dim=-1)
    rsrp = torch.stack(rsrps, dim=-1)
    return dict(ce=ce, noise=noise, rsrp=rsrp,
                snr=rsrp / torch.clamp(noise, min=1e-12)), new_state
