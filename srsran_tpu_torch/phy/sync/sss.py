"""SSS generation and detection, TS 36.211 §6.11.2.

Counterpart of `srsran_tpu/phy/sync/sss.py`.  Host side: the three
length-31 m-sequences, the (m0, m1) pair of an N_id_1, the ±1 sequence of
subframe 0 or 5, its placement in a subframe grid, and the (2, 168, 62)
matrix of every N_id_1 hypothesis.  Device side: detection as one product
of the received symbol with that matrix, then the argmax (`sss_detect`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table

SSS_LEN = 62


def _mseq(poly_taps, init) -> np.ndarray:
    """Length-31 binary m-sequence x(i+5) = sum(taps) mod 2, as ±1."""
    x = np.zeros(31, np.int64)
    x[:5] = init
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in poly_taps) % 2
    return 1 - 2 * x


@lru_cache(maxsize=1)
def _base_sequences():
    s_t = _mseq((0, 2), [0, 0, 0, 0, 1])  # x^5+x^2+1
    c_t = _mseq((0, 3), [0, 0, 0, 0, 1])  # x^5+x^3+1
    z_t = _mseq((0, 1, 2, 4), [0, 0, 0, 0, 1])  # x^5+x^4+x^2+x+1
    return s_t, c_t, z_t


def _m0m1(n_id_1: int) -> tuple[int, int]:
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


def sss_sequence_np(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """SSS d(n), n=0..61, ±1 float32 (subframe 0 or 5)."""
    s_t, c_t, z_t = _base_sequences()
    m0, m1 = _m0m1(n_id_1)
    n = np.arange(31)
    s0 = s_t[(n + m0) % 31]
    s1 = s_t[(n + m1) % 31]
    c0 = c_t[(n + n_id_2) % 31]
    c1 = c_t[(n + n_id_2 + 3) % 31]
    z1_m0 = z_t[(n + (m0 % 8)) % 31]
    z1_m1 = z_t[(n + (m1 % 8)) % 31]
    d = np.zeros(62)
    if sf_idx == 0:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d.astype(np.float32)


def put_sss_grid(grid: np.ndarray, n_id_1: int, n_id_2: int, sf_idx: int, nof_prb: int,
                 symbol: int):
    """Place the SSS into a (nsymb, nre) grid at `symbol`, on the 62
    subcarriers around DC."""
    k0 = nof_prb * 12 // 2 - 31
    grid[symbol, k0 : k0 + 62] = sss_sequence_np(n_id_1, n_id_2, sf_idx)
    return grid


@lru_cache(maxsize=8)
def sss_hypothesis_matrix(n_id_2: int) -> np.ndarray:
    """(2, 168, 62): all N_id_1 sequences for subframes 0 and 5."""
    out = np.zeros((2, 168, 62), np.float32)
    for sf_i, sf in enumerate((0, 5)):
        for nid1 in range(168):
            out[sf_i, nid1] = sss_sequence_np(nid1, n_id_2, sf)
    return out


def sss_detect(sss_re: torch.Tensor, n_id_2: int, ce: torch.Tensor | None = None):
    """Detect N_id_1 and the frame half from the 62 SSS subcarriers.

    sss_re: (..., 62) complex64, channel-compensated if `ce` is None, else
    raw with `ce` (..., 62) the estimate from the adjacent PSS symbol.
    Returns (n_id_1 (...,), sf_is_5 (...,) bool, metric (...,)) on the
    device of `sss_re`: the peak |correlation| over its mean."""
    if ce is not None:
        sss_re = sss_re * torch.conj(ce) / (torch.abs(ce) ** 2 + 1e-9)
    h = table(sss_hypothesis_matrix, int(n_id_2), device=sss_re.device, dtype=torch.complex64)
    metric = torch.abs(torch.einsum("...k,snk->...sn", sss_re, h))
    flat = metric.reshape(metric.shape[:-2] + (-1,))
    arg = torch.argmax(flat, dim=-1)
    peak = torch.gather(flat, -1, arg[..., None])[..., 0]
    return arg % 168, (arg // 168).to(torch.bool), peak / (torch.mean(flat, dim=-1) + 1e-12)
