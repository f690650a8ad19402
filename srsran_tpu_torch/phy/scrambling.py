"""Descrambling of soft values, counterpart of `scramble_soft` in
`srsran_tpu/phy/scrambling.py`: an elementwise multiply by the (1-2c)
signs of the Gold sequence (see `sequence.gold_sequence_signs`)."""

from __future__ import annotations

import torch


def scramble_soft(values: torch.Tensor, seq_signs: torch.Tensor) -> torch.Tensor:
    """Apply (1-2c) signs to float LLRs or complex symbols (last axis)."""
    return values * seq_signs
