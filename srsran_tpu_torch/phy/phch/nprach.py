"""NPRACH: NB-IoT random access preamble, TS 36.211 §10.1.6 (counterpart of
`srsran_tpu/phy/phch/nprach.py`).

A preamble is 4 symbol groups (CP + 5 identical 3.75 kHz single-tone
symbols each); the tone hops between symbol groups by the deterministic
pattern derived from the starting subcarrier: ±1 inside a 12-tone block
(level-1 hop), ±6 between repetitions (level-2, fixed first repetition).

The hop pattern and the transmitter are host copies.  `nprach_detect` runs
on the device of the samples: one batched FFT of the four groups, every
candidate's hopped tones in one gather, and one host read of the best
candidate and the delay.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import as_samples, resolve, table

N_SC = 12  # subcarriers per NPRACH block (3.75 kHz each)
N_GROUPS = 4
N_SYM = 5  # symbols per group
FFT = 256  # 3.75 kHz tones at 0.96 MHz sampling (modeled domain)


def _hop_pattern(n_init: int) -> np.ndarray:
    """Tone index for each of the 4 symbol groups (§10.1.6.1 level-1/2)."""
    a = n_init % N_SC
    # group 2: ±1 (odd/even), group 3: ±6 (mod 12), group 4: ±1 again
    g1 = a
    g2 = a + 1 if a % 2 == 0 else a - 1
    g3 = (g2 + 6) % N_SC
    g4 = g3 + 1 if g3 % 2 == 0 else g3 - 1
    return np.array([g1, g2, g3, g4], np.int32)


def nprach_generate_np(n_init: int, cp_len: int = 64) -> np.ndarray:
    """Time-domain preamble: 4 groups of (CP + 5 symbols) single tones."""
    pattern = _hop_pattern(n_init)
    out = []
    n = np.arange(FFT)
    for tone in pattern:
        sym = np.exp(2j * np.pi * tone * n / FFT).astype(np.complex64)
        group = np.concatenate([sym[-cp_len:], np.tile(sym, N_SYM)])
        out.append(group)
    return np.concatenate(out)


def _detect_tables(cp_len: int):
    """(group FFT window index (4, FFT), hopped tone of every candidate and
    group (12, 4), the first-group tones' conjugate replicas (12, FFT))."""
    group_len = cp_len + N_SYM * FFT
    gidx = np.arange(N_GROUPS) * group_len + cp_len
    win = (gidx[:, None] + np.arange(FFT)[None, :]).astype(np.int64)
    tones = np.stack([_hop_pattern(c) for c in range(N_SC)]).astype(np.int64)
    rep = np.exp(-2j * np.pi * tones[:, :1] * np.arange(FFT)[None, :] / FFT).astype(np.complex64)
    return win, tones, rep


def nprach_detect(samples, cp_len: int = 64, threshold: float = 8.0, *, device=None):
    """Detect preambles in `samples` (numpy or a tensor, moved to `device`:
    None is the card): returns (metric (12,) tensor, detected (12,) tensor,
    delay in samples, a float).

    Each symbol group's first symbol is FFT'd; a candidate's metric is its
    hopped tones' mean energy over the average bin energy.  The delay comes
    from the phase between the first group's first two symbols at the best
    candidate's tone."""
    samples = as_samples(samples, resolve(device))
    win, tones, rep = table(_detect_tables, cp_len, device=samples.device)
    power = torch.abs(torch.fft.fft(samples[win], dim=-1)) ** 2  # (4, FFT)
    avg = torch.mean(power) + 1e-12
    e = power[torch.arange(N_GROUPS, device=samples.device), tones]  # (12, 4)
    metric = ((((e[:, 0] + e[:, 1]) + e[:, 2]) + e[:, 3]) / N_GROUPS) / avg
    detected = metric > threshold
    best = torch.argmax(metric)
    g0 = cp_len  # the first group's first symbol
    s0 = samples[g0 : g0 + FFT]
    s1 = samples[g0 + FFT : g0 + 2 * FFT]
    ph = torch.angle(torch.sum(s1 * rep[best]) * torch.conj(torch.sum(s0 * rep[best])))
    best_ph = torch.stack([best.to(ph.dtype), ph]).cpu()
    tone0 = int(_hop_pattern(int(best_ph[0]))[0])
    delay = -float(best_ph[1]) / (2 * np.pi) * FFT / max(tone0, 1) if tone0 else 0.0
    return metric, detected, delay
