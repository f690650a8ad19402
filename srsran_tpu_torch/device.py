"""Device selection and per-device caching of host-built tables."""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no GPU (never falls
    back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("srsran_tpu_torch: no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """The device an entry point runs on: None is the card (`require_cuda`),
    anything else what `torch.device` makes of it — with its index ("cuda" →
    "cuda:0"), as tensors report it."""
    dev = require_cuda() if device is None else torch.device(device)
    return torch.empty(0, device=dev).device


def as_samples(samples, device: torch.device) -> torch.Tensor:
    """Samples or a grid (numpy or a tensor) as a complex64 tensor on `device`."""
    if isinstance(samples, torch.Tensor):
        return samples.to(device=device, dtype=torch.complex64)
    return torch.from_numpy(np.require(samples, np.complex64, ["C", "W"])).to(device)


def _table(fn, *args, device: torch.device, dtype: torch.dtype | None = None):
    """`fn(*args)` — a host table (numpy array, or tuple of them) — as
    tensors on `device`, built and copied once per (fn, args, device, dtype).

    `args` must be hashable (ints, tuples, frozen config dataclasses).
    A None entry stays None."""
    out = fn(*args)

    def conv(a):
        if a is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(a), device=device, dtype=dtype)

    return tuple(conv(a) for a in out) if isinstance(out, tuple) else conv(out)


def sized_table(maxsize: int):
    """A `table` with a cache of its own that keeps the `maxsize` entries
    used last: for families of large tables whose working set is bounded."""
    cached = lru_cache(maxsize=maxsize)(_table)

    def lookup(fn, *args, device: torch.device, dtype: torch.dtype | None = None):
        out = cached(fn, *args, device=device, dtype=dtype)
        if _PINNED:
            _PINNED[-1].append(out)
        return out

    lookup.cache_info, lookup.cache_clear = cached.cache_info, cached.cache_clear
    return lookup


# the lists of the `pinned` blocks open, innermost last
_PINNED: list[list] = []


@contextlib.contextmanager
def pinned():
    """Collect every table fetched inside the block into the list it
    yields: a CUDA graph captured in the block reads them by address, so
    its holder keeps them, wherever a cache drops them."""
    got: list = []
    _PINNED.append(got)
    try:
        yield got
    finally:
        _PINNED.pop()


table = sized_table(1024)
