"""Tail-biting convolutional code K=7 R=1/3 and its Viterbi decoder, TS 36.212
§5.1.3.1.

Counterpart of `srsran_tpu/phy/fec/conv.py`.  The encoder and the trellis
tables are host numpy copies (polynomials 0x6D, 0x4F, 0x57 with
``sr = (sr << 1) | bit``, ``out = parity(sr & poly)``).  `viterbi_decode` is
plain torch on the device of its input: the same wrap-around decode as the
reference — the received sequence tiled three times and halved, one
add-compare-select step over the 64 states per position with the metrics
renormalised by their maximum, traceback from the best final state, and the
middle copy kept.  The decisions tensor (steps, B, 64) stays on the device;
the step loop launches a few small kernels per position.

Bit parity with the reference rests on three things: the decision between
the two predecessors keeps the first on a tie (``cand[..., 1] >
cand[..., 0]``, as `jnp.argmax`); the branch metric sums the three signed
LLRs left to right, each product exact (the signs are ±1); and each step
runs the reference's order — gather the predecessors' metrics, add, max,
subtract the max.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table

POLYS = (0x6D, 0x4F, 0x57)
K = 7
NSTATES = 64
RATE = 3


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@lru_cache(maxsize=1)
def _tables():
    """prev_state (64, 2) and branch output signs (64, 2, 3) in ±1 (bit b →
    2b-1)."""
    prev_state = np.zeros((NSTATES, 2), np.int32)  # [s', which] -> previous s
    out_signs = np.zeros((NSTATES, 2, 3), np.float32)  # [s', which, j]
    for sp in range(NSTATES):
        u = sp & 1
        base = sp >> 1
        for which in (0, 1):
            prev = base | (which << 5)
            prev_state[sp, which] = prev
            sr = ((prev << 1) | u) & 0x7F
            for j, poly in enumerate(POLYS):
                out_signs[sp, which, j] = 2.0 * _parity(sr & poly) - 1.0
    return prev_state, out_signs


def convcoder_encode_np(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: (D,) bits → (3, D) uint8 streams d^(0..2)."""
    d = len(bits)
    sr = 0
    for i in range(d - K + 1, d):
        sr = (sr << 1) | int(bits[i])
    out = np.zeros((3, d), np.uint8)
    for i in range(d):
        sr = ((sr << 1) | int(bits[i])) & 0x7F
        for j, poly in enumerate(POLYS):
            out[j, i] = _parity(sr & poly)
    return out


def _prev_flat() -> np.ndarray:
    return _tables()[0].reshape(-1).astype(np.int64)


def _out_signs() -> np.ndarray:
    return _tables()[1]


def viterbi_decode(llr_d: torch.Tensor, d: int, wraps: int = 3) -> torch.Tensor:
    """Decode (B, 3, D) float32 LLRs (positive ⇒ bit 1) → (B, D) uint8 hard
    bits, on the device of `llr_d`.

    Wrap-around Viterbi over `wraps` copies for tail biting.  Traceback
    stops at the start of the middle copy: the bits before it are not
    returned."""
    if llr_d.dim() != 3 or llr_d.shape[1] != 3 or llr_d.shape[2] != d:
        raise ValueError(f"viterbi_decode expects (B, 3, {d}) LLRs, got {tuple(llr_d.shape)}")
    dev = llr_d.device
    b = llr_d.shape[0]
    total = wraps * d
    signs = table(_out_signs, device=dev)  # (64, 2, 3)
    prev = table(_prev_flat, device=dev)  # (128,)
    x = 0.5 * llr_d.to(torch.float32).repeat(1, 1, wraps)  # (B, 3, total)
    xt = x.permute(2, 0, 1)[..., None, None]  # (total, B, 3, 1, 1)
    # branch metrics of every step at once, each sum left to right
    bm = (xt[:, :, 0] * signs[:, :, 0] + xt[:, :, 1] * signs[:, :, 1]) + xt[:, :, 2] * signs[:, :, 2]
    pm = torch.zeros((b, NSTATES), dtype=torch.float32, device=dev)
    decs = torch.empty((total, b, NSTATES), dtype=torch.bool, device=dev)
    for t in range(total):
        cand = pm.index_select(1, prev).view(b, NSTATES, 2) + bm[t]
        decs[t] = cand[..., 1] > cand[..., 0]
        new = cand.amax(dim=-1)
        pm = new - new.amax(dim=-1, keepdim=True)
    state = torch.argmax(pm, dim=-1)  # (B,) int64, the first best state
    mid = (wraps // 2) * d
    bits = torch.empty((d, b), dtype=torch.uint8, device=dev)
    for t in range(total - 1, mid - 1, -1):
        if t < mid + d:
            bits[t - mid] = (state & 1).to(torch.uint8)
        which = decs[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (which << 5)
    return bits.T.contiguous()
