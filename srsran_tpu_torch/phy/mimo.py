"""MIMO predecoding — the single-port MRC combiner of
`srsran_tpu/phy/mimo.py`.  The diversity and spatial-multiplexing
predecoders come with the MIMO slice.

Shape conventions (RE-last, batch-first):
  y  (..., nof_rx, M)   received REs
  h  (..., nof_rx, M)   estimated channel of the one port per RE
"""

from __future__ import annotations

import torch


def predecode_single_mrc(y: torch.Tensor, h: torch.Tensor, noise_est=0.0):
    """MRC: x = h^H y / (|h|^2 + n); returns (x_hat, csi), each (..., M).

    `noise_est` is a scalar or a tensor broadcasting against (..., M)."""
    hh = torch.sum(h.abs() ** 2, dim=-2) + noise_est
    x = torch.sum(torch.conj(h) * y, dim=-2) / hh
    return x, hh
