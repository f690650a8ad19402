"""The one traffic generator: from a mix's parameters and a seed, the
transport blocks, their clean subframes (the benchmark's own
transmitter) and the pool of noisy batches on the card that the window
cycles through.

A mix file holds `batch` (subframes a call), `noise_amp` (the standard
deviation of the white Gaussian noise per real and imaginary part, the
signal's resource elements having unit power), `n_tbs` (distinct TBs),
and `pool_batches` (noisy batches made once).  The window keeps one batch
in flight: the loop is closed.  Subframe j of pool batch i carries TB
(i (batch + 1) + j) mod n_tbs, so consecutive batches carry the TBs in
another order.
"""

from __future__ import annotations

import numpy as np
import torch


def draw_tbs(seed: int, n: int, tbs: int) -> np.ndarray:
    """(n, tbs) uint8 distinct transport blocks drawn from the seed."""
    rng = np.random.default_rng([seed, 0])
    out = rng.integers(0, 2, (n, tbs), dtype=np.uint8)
    if len({row.tobytes() for row in out}) != n:
        raise RuntimeError("drawn TBs are not distinct")
    return out


def tb_index(mix: dict) -> np.ndarray:
    """(pool_batches, batch) the TB each subframe of the pool carries."""
    p, b = mix["pool_batches"], mix["batch"]
    return (np.arange(p)[:, None] * (b + 1) + np.arange(b)[None, :]) % mix["n_tbs"]


def render(link, cfg: dict, tbs: np.ndarray) -> np.ndarray:
    """(n, nrx, 15 N) complex64 clean subframes, one per TB."""
    return np.stack([link.render(cfg, tb) for tb in tbs])


def build_pool(clean: torch.Tensor, mix: dict, seed: int) -> torch.Tensor:
    """(pool_batches, batch, nrx, 15 N) complex64 noisy batches on the
    device of `clean`, the noise from a generator on that device."""
    gen = torch.Generator(device=clean.device)
    gen.manual_seed(seed)
    idx = torch.from_numpy(tb_index(mix)).to(clean.device)
    pool = torch.empty((mix["pool_batches"], mix["batch"]) + tuple(clean.shape[1:]),
                       dtype=torch.complex64, device=clean.device)
    for i in range(mix["pool_batches"]):
        noise = torch.randn(tuple(pool.shape[1:]) + (2,), generator=gen, device=clean.device)
        pool[i] = clean[idx[i]] + mix["noise_amp"] * torch.view_as_complex(noise)
    return pool
