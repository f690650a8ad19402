"""Rate matching for turbo (TS 36.212 §5.1.4.1) and convolutional (§5.1.4.2)
codes.

Counterpart of `srsran_tpu/phy/fec/rate_match.py` (the transmit sides as
host numpy, for stimuli).  Turbo:
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
# TS 36.212 Table 5.1.4-2 inter-column permutation (convolutional)
RM_PERM_CC = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
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


def turbo_rate_match_rx(llr_e: torch.Tensor, k: int, rv: int = 0, n_filler: int = 0, *,
                        softbuffer=None) -> torch.Tensor:
    """LLRs (..., e) → d-stream LLRs (..., 3, K+4), summing repetitions.

    With `softbuffer` (..., 3, K+4) the LLRs are added to a copy of it (HARQ
    combining, the reference's `softbuffer=`); the caller's buffer is left as
    it was."""
    e = llr_e.shape[-1]
    idx = table(turbo_rm_indices, k, e, rv, n_filler, device=llr_e.device, dtype=torch.int64)
    if softbuffer is None:
        flat = torch.zeros(llr_e.shape[:-1] + (3 * (k + 4),), dtype=llr_e.dtype,
                           device=llr_e.device)
    else:
        flat = softbuffer.reshape(softbuffer.shape[:-2] + (-1,)).clone()
    flat.index_add_(-1, idx, llr_e)
    return flat.reshape(llr_e.shape[:-1] + (3, k + 4))


# --- convolutional (tail-biting) rate matching --------------------------------


@lru_cache(maxsize=512)
def _conv_wbuffer(d: int):
    """w map for conv coding: 3 streams of length d, concatenated v0|v1|v2."""
    r = -(-d // NCOLS)
    kp = r * NCOLS
    nd = kp - d
    y_idx = (np.arange(r)[None, :] * NCOLS + RM_PERM_CC[:, None]).reshape(-1)
    w = np.empty(3 * kp, np.int64)
    for s in range(3):
        w[s * kp : (s + 1) * kp] = np.where(y_idx < nd, -1, s * d + (y_idx - nd))
    return w, kp


@lru_cache(maxsize=4096)
def conv_rm_indices(d: int, e: int) -> np.ndarray:
    """Gather indices (length e) into the flat (3*d,) d-stream array."""
    w, _kp = _conv_wbuffer(d)
    stream = w[w >= 0]
    reps = -(-e // len(stream))
    return np.tile(stream, reps)[:e].astype(np.int32)


def conv_rate_match_tx(d: np.ndarray, e: int) -> np.ndarray:
    """Host: d (..., 3, D) → (..., e)."""
    return d.reshape(d.shape[:-2] + (-1,))[..., conv_rm_indices(d.shape[-1], e)]


def conv_rate_match_rx(llr_e: torch.Tensor, d: int) -> torch.Tensor:
    """LLRs (..., e) → (..., 3, d), summing repetitions, on the device of
    `llr_e`."""
    e = llr_e.shape[-1]
    idx = table(conv_rm_indices, d, e, device=llr_e.device, dtype=torch.int64)
    flat = torch.zeros(llr_e.shape[:-1] + (3 * d,), dtype=llr_e.dtype, device=llr_e.device)
    flat.index_add_(-1, idx, llr_e)
    return flat.reshape(llr_e.shape[:-1] + (3, d))


@lru_cache(maxsize=256)
def _conv_stream(d: int) -> np.ndarray:
    """The circular-buffer read order (each flat position at most once per
    cycle): the batch de-rate-match folds repetitions by cycle."""
    w, _kp = _conv_wbuffer(d)
    return w[w >= 0].astype(np.int32)


def conv_rate_match_rx_batch_np(llr_e: np.ndarray, d: int) -> np.ndarray:
    """Host: (H, e) LLR rows → (H, 3, d), the repetitions folded by cycle —
    the blind search runs one per (DCI length, aggregation level)."""
    llr_e = np.asarray(llr_e, np.float32)
    h, e = llr_e.shape
    stream = _conv_stream(d)
    ls = stream.size
    reps = -(-e // ls)
    pad = np.zeros((h, reps * ls), np.float32)
    pad[:, :e] = llr_e
    folded = pad.reshape(h, reps, ls).sum(axis=1)
    flat = np.zeros((h, 3 * d), np.float32)
    flat[:, stream] = folded
    return flat.reshape(h, 3, d)


def conv_rate_match_rx_np(llr_e: np.ndarray, d: int) -> np.ndarray:
    """Host: de-rate-match of control-sized payloads by one scatter-add."""
    llr_e = np.asarray(llr_e, np.float32)
    idx = conv_rm_indices(d, llr_e.shape[-1])
    flat = np.zeros(llr_e.shape[:-1] + (3 * d,), np.float32)
    np.add.at(flat, (..., idx), llr_e)
    return flat.reshape(llr_e.shape[:-1] + (3, d))
