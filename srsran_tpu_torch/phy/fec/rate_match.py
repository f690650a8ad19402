"""Turbo de-rate-matching, TS 36.212 §5.1.4.1.

Counterpart of `srsran_tpu/phy/fec/rate_match.py` (the transmit side as
host numpy, for stimuli):
the host derives, per (K, E, rv, filler), one index vector into the flat
(3*(K+4),) d-stream array (circular buffer, dummy-bit skipping, rv start
k0); on the device the de-rate-match is one `index_add_` that sums
repeated positions like the reference's HARQ `+=`.  CUDA sums repeated
indices in no fixed order, so with repetition the result can differ from
the reference in the last ulp.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table

NCOLS = 32
# TS 36.212 Table 5.1.4-1 inter-column permutation (turbo)
RM_PERM_TC = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)


@lru_cache(maxsize=512)
def _turbo_wbuffer(k: int):
    """Circular buffer map for CB size k: (w, Kp), w of length 3*Kp maps
    each circular-buffer position to a flat d-stream index
    (stream*(k+4)+pos), or -1 for <NULL> dummy positions."""
    d = k + 4
    r = -(-d // NCOLS)
    kp = r * NCOLS
    nd = kp - d

    # streams 0/1: column-permuted, read column-wise
    y_idx01 = (np.arange(r)[None, :] * NCOLS + RM_PERM_TC[:, None]).reshape(-1)
    # stream 2: pi(m) = (P[m // r] + 32*(m % r) + 1) mod Kp
    m = np.arange(kp)
    y_idx2 = (RM_PERM_TC[m // r] + NCOLS * (m % r) + 1) % kp

    def to_d(stream, y):
        return np.where(y < nd, -1, stream * d + (y - nd))

    w = np.empty(3 * kp, np.int64)
    w[:kp] = to_d(0, y_idx01)
    w[kp::2] = to_d(1, y_idx01)
    w[kp + 1 :: 2] = to_d(2, y_idx2)
    return w, kp


def turbo_k0(k: int, rv: int) -> int:
    """Redundancy-version start point (TS 36.212 §5.1.4.1.2)."""
    r = -(-(k + 4) // NCOLS)
    ncb = 3 * r * NCOLS  # full soft buffer (no N_IR limiting)
    return r * (2 * int(np.ceil(ncb / (8.0 * r))) * rv + 2)


@lru_cache(maxsize=4096)
def turbo_rm_indices(k: int, e: int, rv: int, n_filler: int = 0) -> np.ndarray:
    """Gather indices (length e) into the flat (3*(k+4),) d-stream array.

    `n_filler` filler bits at the head of d^(0) and d^(1) are <NULL> and
    skipped by bit selection (TS 36.212 §5.1.3.2)."""
    w, kp = _turbo_wbuffer(k)
    d = k + 4
    k0 = turbo_k0(k, rv)
    valid_mask = w >= 0
    if n_filler:
        is_filler = ((w >= 0) & (w < n_filler)) | ((w >= d) & (w < d + n_filler))
        valid_mask = valid_mask & ~is_filler
    order = np.concatenate([np.arange(k0, 3 * kp), np.arange(0, k0)])
    stream = w[order][valid_mask[order]]
    reps = -(-e // len(stream))
    return np.tile(stream, reps)[:e].astype(np.int32)


def turbo_rate_match_tx(d: np.ndarray, e: int, rv: int = 0, n_filler: int = 0) -> np.ndarray:
    """Host: d (..., 3, K+4) coded bits → the e rate-matched bits (..., e)."""
    k = d.shape[-1] - 4
    return d.reshape(d.shape[:-2] + (-1,))[..., turbo_rm_indices(k, e, rv, n_filler)]


def turbo_rate_match_rx(llr_e: torch.Tensor, k: int, rv: int = 0,
                        n_filler: int = 0) -> torch.Tensor:
    """LLRs (..., e) → d-stream LLRs (..., 3, K+4), summing repetitions."""
    e = llr_e.shape[-1]
    idx = table(turbo_rm_indices, k, e, rv, n_filler, device=llr_e.device, dtype=torch.int64)
    flat = torch.zeros(llr_e.shape[:-1] + (3 * (k + 4),), dtype=llr_e.dtype,
                       device=llr_e.device)
    flat.index_add_(-1, idx, llr_e)
    return flat.reshape(llr_e.shape[:-1] + (3, k + 4))
