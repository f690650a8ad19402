"""CFO and SFO estimation and correction, and CP-length detection.

Counterpart of `srsran_tpu/phy/sync/cfo.py` (`lib/src/phy/sync/cfo.c` and
the CP-based estimator of `sync.c`).  Every function takes tensors with any
leading batch axes and runs on their device; a correction is one
elementwise product.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import CP, Cell, cp_len_ext, cp_len_norm


def cfo_apply(samples: torch.Tensor, cfo: float, symbol_sz: int) -> torch.Tensor:
    """Shift (..., n) complex64 by `cfo` subcarrier spacings (vec_apply_cfo),
    the phase in float32."""
    n = torch.arange(samples.shape[-1], device=samples.device, dtype=torch.float32)
    phase = (-2.0 * np.pi * cfo) * n / symbol_sz
    return samples * torch.polar(torch.ones_like(phase), phase)


def cfo_estimate_cp(samples: torch.Tensor, cell: Cell, nof_symbols: int = 7) -> torch.Tensor:
    """CFO in subcarrier spacings from one slot of samples (..., >= slot_len):
    each symbol's CP against its tail, whose phase advances by 2π·cfo over
    `symbol_sz` samples, summed over `nof_symbols`."""
    n = cell.symbol_sz
    acc = 0.0
    t = 0
    for l in range(nof_symbols):
        cp = cp_len_norm(l, n) if cell.cp == CP.NORM else cp_len_ext(n)
        acc = acc + torch.sum(samples[..., t : t + cp] * torch.conj(samples[..., t + n : t + n + cp]),
                              dim=-1)
        t += cp + n
    return -torch.angle(acc) / (2 * np.pi)


def sfo_estimate(t_offsets: torch.Tensor, period_s: float) -> torch.Tensor:
    """Sampling-frequency offset in samples per second from timing offsets
    (..., n) measured `period_s` apart (`srslte_sync_sfo_estimate`)."""
    return torch.mean(torch.diff(t_offsets, dim=-1), dim=-1) / period_s


def cp_detect(samples: torch.Tensor, symbol_sz: int):
    """Normal or extended CP from the CP-correlation energy over one slot
    (sync.c srslte_sync_detect_cp).  Returns (is_extended, metric_norm,
    metric_ext) on the host."""
    n = symbol_sz

    def metric(cp_lens):
        pos = 0
        acc = 0.0
        eng = 1e-12
        for cp in cp_lens:
            a = samples[pos : pos + cp]
            b = samples[pos + n : pos + n + cp]
            acc = acc + torch.abs(torch.sum(a * torch.conj(b)))
            eng = eng + torch.sqrt(torch.sum(torch.abs(a) ** 2) * torch.sum(torch.abs(b) ** 2))
            pos += cp + n
        return acc / eng

    m_norm = float(metric([cp_len_norm(l, n) for l in range(7)]))
    m_ext = float(metric([cp_len_ext(n)] * 6))
    return m_ext > m_norm, m_norm, m_ext
