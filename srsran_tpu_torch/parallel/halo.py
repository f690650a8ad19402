"""Halo-exchange streaming ops over a sample axis split across positions
(counterpart of `srsran_tpu/parallel/halo.py`).

The reference's overlap-save/add block processing (FFT resampler state,
FIR filter state) carries boundary samples between sequential calls.  With
the sample axis split over a mesh axis, the carried state becomes a
neighbour exchange: each position takes the previous chunk's tail and the
next chunk's head.  A chunk on another card arrives by `.to(device)`, a
peer copy; the reference's `ppermute` over the ICI.
"""

from __future__ import annotations

import numpy as np
import torch

from ..phy.resampling import resample_fft
from .mesh import Mesh


def _split_samples(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Equal contiguous chunks of the last axis, chunk i on position i's
    device along `axis`."""
    devs = mesh.axis_devices(axis)
    n = x.shape[-1]
    if n % len(devs):
        raise ValueError(f"{n} samples do not split over {len(devs)} positions")
    return [c.to(d) for c, d in zip(torch.chunk(x, len(devs), dim=-1), devs)]


def stream_halo_exchange(chunks: list, halo: int) -> list:
    """[(left, right)] per position: the previous chunk's tail and the next
    chunk's head, each on the position's own device.  The first position's
    left halo is its own head and the last position's right halo its own
    tail, as the blockwise reference `resample_fft_blocks` has it."""
    out = []
    for i, xc in enumerate(chunks):
        left = chunks[i - 1][..., -halo:].to(xc.device) if i > 0 else xc[..., :halo]
        right = (chunks[i + 1][..., :halo].to(xc.device) if i + 1 < len(chunks)
                 else xc[..., -halo:])
        out.append((left, right))
    return out


def sharded_resample_fft(x: torch.Tensor, p: int, q: int, mesh: Mesh, halo: int = 64,
                         axis: str = "samples") -> torch.Tensor:
    """Rational p/q FFT resampling of a stream whose sample axis is split over
    the positions of `axis`: each position resamples its chunk extended by
    the halos and keeps its own span.  Returns the stream on `x`'s device."""
    chunks = _split_samples(x, mesh, axis)
    h_out = halo * p // q
    ys = []
    for xc, (left, right) in zip(chunks, stream_halo_exchange(chunks, halo)):
        y = resample_fft(torch.cat([left, xc, right], dim=-1), p, q)
        ys.append(y[..., h_out : h_out + xc.shape[-1] * p // q])
    return torch.cat([y.to(x.device) for y in ys], dim=-1)


def sharded_fir(x: torch.Tensor, taps: np.ndarray, mesh: Mesh, axis: str = "samples") -> torch.Tensor:
    """Causal FIR filtering of a stream split over the positions of `axis`:
    each position takes the previous chunk's last ntaps-1 samples as the
    filter state (zeros at the first).  y[i] = sum_k taps[k] x[i - k], the
    reference's `jnp.convolve(..., "valid")`: the window product below runs
    the taps reversed, since a sliding window correlates."""
    ntaps = len(taps)
    chunks = _split_samples(x, mesh, axis)
    h_rev = np.ascontiguousarray(np.asarray(taps)[::-1]).astype(np.complex64)
    ys = []
    for i, xc in enumerate(chunks):
        if i == 0:
            left = xc.new_zeros(xc.shape[:-1] + (ntaps - 1,))
        else:
            left = chunks[i - 1][..., xc.shape[-1] - (ntaps - 1):].to(xc.device)
        win = torch.cat([left, xc], dim=-1).unfold(-1, ntaps, 1)  # (..., n_local, ntaps)
        h = torch.from_numpy(h_rev).to(xc.device)
        ys.append(torch.einsum("...nt,t->...n", win.to(torch.complex64), h))
    return torch.cat([y.to(x.device) for y in ys], dim=-1)
