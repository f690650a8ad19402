"""LTE CRC (24A/24B/16/8), TS 36.212 §5.1.1, as a GF(2) matrix product.

For a fixed message length N the checksum is linear: crc = bits @ M mod 2,
with row i of M equal to x^(N-1-i+L) mod g(x) (MSB first).  On the device
that is one float32 `torch.matmul` plus `& 1`; it is exact because the
sums stay below 2^24 (N ≤ 6144).  TF32 must stay off for callers that
pass non-binary inputs; 0/1 bits are exact in TF32 too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import table
from .common import LTE_CRC8, LTE_CRC16, LTE_CRC24A, LTE_CRC24B

_ORDERS = {LTE_CRC24A: 24, LTE_CRC24B: 24, LTE_CRC16: 16, LTE_CRC8: 8}


def crc_order(poly: int) -> int:
    return _ORDERS[poly]


def _xpow_mod(poly: int, order: int, e: int) -> int:
    """x^e mod g(x) as an integer with bit k = coeff of x^k."""
    r = 1
    for _ in range(e):
        r <<= 1
        if (r >> order) & 1:
            r ^= poly
    return r & ((1 << order) - 1)


@lru_cache(maxsize=512)
def crc_matrix_np(poly: int, length: int) -> np.ndarray:
    """(length, order) uint8 matrix M with crc = bits @ M mod 2 (MSB first)."""
    order = _ORDERS[poly]
    m = np.zeros((length, order), dtype=np.uint8)
    r = _xpow_mod(poly, order, order)  # contribution of bit length-1
    for i in range(length - 1, -1, -1):
        for j in range(order):
            m[i, j] = (r >> (order - 1 - j)) & 1
        # the previous message bit multiplies by x
        r <<= 1
        if (r >> order) & 1:
            r ^= poly
        r &= (1 << order) - 1
    return m


def crc_attach_np(bits: np.ndarray, poly: int) -> np.ndarray:
    """Host: append the CRC to a {0,1} uint8 bit array."""
    m = crc_matrix_np(poly, len(bits))
    crc = (bits.astype(np.uint32) @ m.astype(np.uint32)) & 1
    return np.concatenate([bits.astype(np.uint8), crc.astype(np.uint8)])


def crc_compute_np(bits: np.ndarray, poly: int) -> np.ndarray:
    """Host: the (order,) uint8 CRC of a {0,1} bit array."""
    m = crc_matrix_np(poly, len(bits))
    return ((bits.astype(np.uint32) @ m.astype(np.uint32)) & 1).astype(np.uint8)


def crc_check_np(bits_with_crc: np.ndarray, poly: int) -> bool:
    """Host: True iff the trailing CRC matches."""
    order = crc_order(poly)
    msg, crc = bits_with_crc[:-order], bits_with_crc[-order:]
    return bool(np.array_equal(crc_compute_np(msg, poly), crc.astype(np.uint8)))


def crc_table(poly: int, length: int, device) -> torch.Tensor:
    """`crc_matrix_np` as a float32 tensor on `device` (cached)."""
    return table(crc_matrix_np, poly, length, device=torch.device(device), dtype=torch.float32)


def crc_compute(bits: torch.Tensor, poly: int) -> torch.Tensor:
    """CRC of {0,1} bits along the last axis, any leading batch dims.

    Returns (..., order) uint8."""
    m = crc_table(poly, bits.shape[-1], bits.device)
    acc = torch.matmul(bits.to(torch.float32), m)
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def crc_ok(bits_with_crc: torch.Tensor, poly: int) -> torch.Tensor:
    """Vectorized check: (..., N+order) bits -> (...,) bool."""
    order = _ORDERS[poly]
    msg = bits_with_crc[..., :-order]
    crc = bits_with_crc[..., -order:].to(torch.uint8)
    return torch.all(crc_compute(msg, poly) == crc, dim=-1)
