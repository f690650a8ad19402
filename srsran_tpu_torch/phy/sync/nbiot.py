"""NB-IoT synchronization signals: NPSS and NSSS, TS 36.211 §10.2.7
(counterpart of `srsran_tpu/phy/sync/nbiot.py`).

NB-IoT occupies one PRB (12 subcarriers, 180 kHz).  NPSS: a length-11
Zadoff-Chu (root 5) on subcarriers 0-10 of OFDM symbols 3-13 in subframe 5
of every frame, with the per-symbol cover code S(l).  NSSS: a length-131 ZC
(root from the cell id) with a binary scrambling b_q(m) and phase rotation
θ_f, on the last 11 symbols of subframe 9 of even frames — conveying
N_id_ncell (0..503) and the 80 ms frame position.

The sequences and the 2016-row NSSS hypothesis matrix are host tables
(numpy copies); the correlations run on the device of the grids, all NSSS
hypotheses in one matrix product.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table

NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], np.float32)
NPSS_SYMS = 11  # symbols 3..13 of the subframe
NSSS_LEN = 131
NSSS_SYMS = 11


@lru_cache(maxsize=1)
def npss_freq_np() -> np.ndarray:
    """(11 symbols, 11 subcarriers) NPSS frequency-domain sequence."""
    u = 5
    n = np.arange(11)
    zc = np.exp(-1j * np.pi * u * n * (n + 1) / 11).astype(np.complex64)
    return NPSS_COVER[:, None] * zc[None, :]


def put_npss_grid(grid: np.ndarray):
    """Insert NPSS into a (14, 12) NB-IoT subframe grid (subframe 5)."""
    seq = npss_freq_np()
    for i in range(NPSS_SYMS):
        grid[3 + i, :11] = seq[i]
    return grid


@lru_cache(maxsize=512)
def nsss_sequence_np(n_id_ncell: int, frame4: int) -> np.ndarray:
    """NSSS d(n), n = 0..131 (TS 36.211 §10.2.7.2.1).

    frame4 = (nf/2) mod 4 selects the phase rotation θ_f.
    """
    u = n_id_ncell % 126 + 3
    q = n_id_ncell // 126
    n = np.arange(132)
    m = n % 128
    nn = n % NSSS_LEN
    # binary scrambling b_q(m): rows of the 128-Walsh matrix indexed by q*32
    b = _walsh128()[q * 32][m]
    theta = 33.0 / 132.0 * frame4
    d = (
        b
        * np.exp(-2j * np.pi * theta * n)
        * np.exp(-1j * np.pi * u * nn * (nn + 1) / NSSS_LEN)
    )
    return d.astype(np.complex64)


@lru_cache(maxsize=1)
def _walsh128() -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < 128:
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


def put_nsss_grid(grid: np.ndarray, n_id_ncell: int, frame4: int):
    """Insert NSSS into a (14, 12) grid (subframe 9, even frame)."""
    d = nsss_sequence_np(n_id_ncell, frame4)
    k = 0
    for l in range(14 - NSSS_SYMS, 14):
        grid[l, :12] = d[k : k + 12]
        k += 12
    return grid


def _npss_conj() -> np.ndarray:
    return np.conj(npss_freq_np())


def npss_correlate(grid_syms: torch.Tensor):
    """Correlate (nsf, 14, 12) candidate subframes against the NPSS.

    Returns (metric (nsf,), best ()): normalized coherent correlation over
    the 11 NPSS symbols — peak at the true subframe-5 alignment."""
    seq = table(_npss_conj, device=grid_syms.device)
    region = grid_syms[..., 3 : 3 + NPSS_SYMS, :11]
    corr = torch.abs(torch.sum(region * seq, dim=(-1, -2)))
    energy = torch.sqrt(torch.sum(torch.abs(region) ** 2, dim=(-1, -2)) + 1e-12)
    metric = corr / (energy * np.sqrt(11.0 * 11.0))
    return metric, torch.argmax(metric)


@lru_cache(maxsize=1)
def _nsss_hypothesis_matrix() -> np.ndarray:
    """(504*4, 132) conjugated NSSS hypotheses for one-shot detection."""
    rows = []
    for nid in range(504):
        for f4 in range(4):
            rows.append(np.conj(nsss_sequence_np(nid, f4)))
    return np.stack(rows)


def nsss_detect(grid: torch.Tensor):
    """Detect (n_id_ncell, frame4, confidence) from a (14, 12) subframe-9
    grid: one 2016x132 hypothesis product over NB-IoT's 504-cell space.
    Tensors of shape () on the grid's device."""
    d_rx = grid[14 - NSSS_SYMS :, :12].reshape(-1)  # (132,)
    hyp = table(_nsss_hypothesis_matrix, device=grid.device)
    corr = torch.abs(hyp @ d_rx)
    best = torch.argmax(corr)
    return best // 4, best % 4, corr[best] / (torch.linalg.vector_norm(d_rx) * np.sqrt(132.0))


def nbiot_cell_search(sf_grids: torch.Tensor):
    """Anchor-carrier cell search over a stream of (nsf, 14, 12) subframe
    grids (the `ue_cell_search_nbiot.c` flow, grid domain): find the NPSS
    subframe phase, then detect (n_id_ncell, frame position) from the NSSS 4
    subframes later (sf 9 of even frames).  Two host reads.

    Returns (n_id_ncell, sf5_index, frame4, confidence) or None."""
    metric, best = npss_correlate(sf_grids)
    best_m = torch.stack([best.to(metric.dtype), metric[best]]).cpu()
    best, peak = int(best_m[0]), float(best_m[1])
    if peak < 0.5:
        return None
    nsss_idx = best + 4  # sf 9 of the same frame
    if nsss_idx >= sf_grids.shape[0]:
        nsss_idx = best - 6  # previous frame's sf 9 (even-frame caveat)
    if nsss_idx < 0:
        return None
    nid, f4, conf = (float(v) for v in torch.stack(
        [v.to(torch.float64) for v in nsss_detect(sf_grids[nsss_idx])]).cpu())
    if conf < 0.4:
        return None
    return int(nid), best, int(f4), conf
