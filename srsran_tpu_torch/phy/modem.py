"""Soft demodulator, TS 36.211 §7.1.

Counterpart of `demod_soft` in `srsran_tpu/phy/modem.py`: the zone-based
max-log approximation — the first I/Q LLR pair is the negated symbol, each
further pair is ``abs(prev) - threshold``.  Positive LLR ⇒ bit 1.
"""

from __future__ import annotations

import enum

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
