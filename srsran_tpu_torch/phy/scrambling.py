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


def pdsch_cinit(rnti: int, q: int, sf_idx: int, cell_id: int) -> int:
    """c_init for PDSCH/PUSCH scrambling, TS 36.211 §6.3.1 (the argument
    order of the reference's module; `phch.pdsch.pdsch_cinit` takes `q`
    last)."""
    return (rnti << 14) + (q << 13) + (sf_idx << 9) + cell_id


def pbch_cinit(cell_id: int) -> int:
    return cell_id
