"""Scrambling, counterpart of `srsran_tpu/phy/scrambling.py`: soft
values are multiplied by the (1-2c) signs of the Gold sequence (see
`sequence.gold_sequence_signs`); bits are XORed with it on the host."""

from __future__ import annotations

import numpy as np
import torch


def scramble_bits(bits: np.ndarray, seq: np.ndarray) -> np.ndarray:
    """Host: (bits + c) mod 2; shapes broadcast along the last axis."""
    return np.bitwise_xor(np.asarray(bits, np.uint8), np.asarray(seq, np.uint8))


def scramble_soft(values: torch.Tensor, seq_signs: torch.Tensor) -> torch.Tensor:
    """Apply (1-2c) signs to float LLRs or complex symbols (last axis)."""
    return values * seq_signs
