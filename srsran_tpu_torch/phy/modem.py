"""Soft demodulator and host modulation mapper, TS 36.211 §7.1.

Counterpart of `demod_soft` in `srsran_tpu/phy/modem.py`: the zone-based
max-log approximation — the first I/Q LLR pair is the negated symbol, each
further pair is ``abs(prev) - threshold``.  Positive LLR ⇒ bit 1.
`modulate_np` is the reference's host mapper (constellations from the 3GPP
Gray-mapping recursion), for stimuli; `modulate` is the device mapper, the
same constellations in closed form.  `demod_hard` and `quantize_llr` (the
int16/int8 soft bits at `LLR_SCALE_I16`/`LLR_SCALE_I8`) are the reference's
too.
"""

from __future__ import annotations

import enum
from functools import lru_cache

import numpy as np
import torch


class Mod(enum.IntEnum):
    BPSK = 0
    QPSK = 1
    QAM16 = 2
    QAM64 = 3
    QAM256 = 4

    @property
    def bits_per_symbol(self) -> int:
        return (1, 2, 4, 6, 8)[self]


# the reference's per-modulation scales of its int16 and int8 soft bits
LLR_SCALE_I16 = {Mod.BPSK: 100, Mod.QPSK: 100, Mod.QAM16: 400, Mod.QAM64: 700, Mod.QAM256: 1000}
LLR_SCALE_I8 = {Mod.BPSK: 20, Mod.QPSK: 20, Mod.QAM16: 30, Mod.QAM64: 40, Mod.QAM256: 50}


def _pam_levels(nbits: int) -> np.ndarray:
    """Gray-mapped PAM amplitude for each bit pattern (TS 36.211 §7.1):
    unnormalized odd levels for all 2^nbits patterns."""
    if nbits == 0:
        return np.array([1.0])

    def f(bits):
        if len(bits) == 1:
            return 2.0 - (1.0 - 2.0 * bits[0])
        return 2.0 ** len(bits) - (1.0 - 2.0 * bits[0]) * f(bits[1:])

    out = np.empty(2**nbits)
    for idx in range(2**nbits):
        out[idx] = f([(idx >> (nbits - 1 - i)) & 1 for i in range(nbits)])
    return out


@lru_cache(maxsize=None)
def constellation_np(mod: Mod) -> np.ndarray:
    """Symbol table indexed by the MSB-first packed bit word."""
    if mod == Mod.BPSK:
        a = 1.0 / np.sqrt(2.0)
        return np.array([a + 1j * a, -a - 1j * a], dtype=np.complex64)
    m = mod.bits_per_symbol
    half = m // 2
    # even bits (b0, b2, ..) steer I, odd bits Q; the first bit of each
    # axis is the sign, the others the magnitude
    norm = {2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0), 8: np.sqrt(170.0)}[m]
    mag = _pam_levels(half - 1)
    table = np.empty(2**m, dtype=np.complex64)
    for idx in range(2**m):
        bits = [(idx >> (m - 1 - i)) & 1 for i in range(m)]
        ib, qb = bits[0::2], bits[1::2]
        i_val = (1.0 - 2.0 * ib[0]) * mag[int("".join(map(str, ib[1:])) or "0", 2)]
        q_val = (1.0 - 2.0 * qb[0]) * mag[int("".join(map(str, qb[1:])) or "0", 2)]
        table[idx] = (i_val + 1j * q_val) / norm
    return table


def modulate_np(mod: Mod, bits) -> np.ndarray:
    """Host: {0,1} bits (n*m,) → complex64 symbols (n,), for stimuli."""
    m = mod.bits_per_symbol
    b = np.asarray(bits, np.uint8).reshape(-1, m).astype(np.int64)
    return constellation_np(mod)[b @ (1 << np.arange(m - 1, -1, -1, dtype=np.int64))]


def modulate(mod: Mod, bits: torch.Tensor) -> torch.Tensor:
    """{0,1} bits (..., n*m) → complex64 symbols (..., n) on the device.

    Closed-form Gray mapping (the arithmetic the TS 36.211 §7.1 tables
    tabulate): I is driven by the even bits, Q by the odd bits, with the
    amplitude recursion level = A − s·(A/2 − s'·(…)).  Elementwise float32
    math in the reference's order of operations: equal to the reference's
    `modulate` bit for bit, and to `constellation_np` (rounded once, from
    float64) within 2e-7."""
    m = mod.bits_per_symbol
    s = 1.0 - 2.0 * bits.reshape(tuple(bits.shape[:-1]) + (-1, m)).to(torch.float32)  # ±1
    c = float(np.float32(1.0 / np.sqrt({1: 2.0, 2: 2.0, 4: 10.0, 6: 42.0, 8: 170.0}[m])))
    if mod == Mod.BPSK:
        v = s[..., 0] * c
        return torch.complex(v, v)

    def level(first: int) -> torch.Tensor:
        # bits first, first+2, ... of the symbol: sign, then amplitude steps
        lev = None
        for j in range(m - 2 + first, first, -2):
            step = float(2 ** ((m - j + first) // 2))
            lev = step - s[..., j] * (1.0 if lev is None else lev)
        return s[..., first] * (1.0 if lev is None else lev) * c

    return torch.complex(level(0), level(1))


def _interleave(*llrs: torch.Tensor) -> torch.Tensor:
    """Per-symbol LLR columns → (..., n*m), bit-major within each symbol."""
    llr = torch.stack(llrs, dim=-1)
    return llr.reshape(llr.shape[:-2] + (-1,)).to(torch.float32)


def demod_soft(mod: Mod, symbols: torch.Tensor) -> torch.Tensor:
    """complex64 symbols (..., n) → float32 LLRs (..., n*m)."""
    re, im = symbols.real, symbols.imag
    if mod == Mod.BPSK:
        return (-(re + im) * np.float32(1.0 / np.sqrt(2.0))).to(torch.float32)
    if mod == Mod.QPSK:
        return _interleave(-re * np.sqrt(2.0), -im * np.sqrt(2.0))
    if mod == Mod.QAM16:
        th = 2.0 / np.sqrt(10.0)
        return _interleave(-re, -im, re.abs() - th, im.abs() - th)
    if mod == Mod.QAM64:
        t1, t2 = 4.0 / np.sqrt(42.0), 2.0 / np.sqrt(42.0)
        l2, l3 = re.abs() - t1, im.abs() - t1
        return _interleave(-re, -im, l2, l3, l2.abs() - t2, l3.abs() - t2)
    if mod == Mod.QAM256:
        t1, t2, t3 = (x / np.sqrt(170.0) for x in (8.0, 4.0, 2.0))
        l2, l3 = re.abs() - t1, im.abs() - t1
        l4, l5 = l2.abs() - t2, l3.abs() - t2
        return _interleave(-re, -im, l2, l3, l4, l5, l4.abs() - t3, l5.abs() - t3)
    raise ValueError(f"unsupported modulation {mod}")


def quantize_llr(llr: torch.Tensor, mod: Mod, dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Float LLRs → int16/int8 with the reference's per-modulation scales
    (rounded half to even, saturated)."""
    if dtype == torch.int16:
        scale, lim = LLR_SCALE_I16[mod], 32767
    elif dtype == torch.int8:
        scale, lim = LLR_SCALE_I8[mod], 127
    else:
        raise ValueError(dtype)
    return torch.clamp(torch.round(llr * scale), -lim - 1, lim).to(dtype)


def demod_hard(mod: Mod, symbols: torch.Tensor) -> torch.Tensor:
    """Hard decisions from LLR signs (positive ⇒ 1), uint8."""
    return (demod_soft(mod, symbols) > 0).to(torch.uint8)
