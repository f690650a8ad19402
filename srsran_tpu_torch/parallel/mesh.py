"""Device grids and carrier sharding (counterpart of
`srsran_tpu/parallel/mesh.py`).

The reference is single-controller: one process drives every device of a
`jax.sharding.Mesh`.  The port keeps that shape with one process and an
explicit grid of `torch.device`s: a position of the grid is a place where a
block of work runs, and a chunk of a sharded tensor lives on its position's
device.  Positions may name the same device (eight positions of one card,
or of the CPU in the tests), which is how one card stands in for a grid.

The primary axis is `carriers` (one cc_worker per component carrier in the
reference); a second `samples` axis shards the I/Q stream of one wide
carrier for the overlap-save ops in `parallel.halo`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import require_cuda, resolve


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An n-dimensional grid of positions, each a `torch.device`."""

    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D grid needs as many axis names, "
                             f"got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices of the positions along `axis` (index 0 of every other
        axis, where a chunk sharded over `axis` alone lives)."""
        i = self.axis_names.index(axis)
        sel = tuple(slice(None) if j == i else 0 for j in range(self.devices.ndim))
        return list(self.devices[sel])


class PartitionSpec(tuple):
    """Which mesh axis each tensor axis is sharded over (None: not sharded)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def positions(self) -> list:
        """The devices along the mesh axis that shards the leading axis."""
        if not self.spec or self.spec[0] is None:
            raise ValueError("the leading axis is not sharded")
        return self.mesh.axis_devices(self.spec[0])


def carrier_mesh(n_carriers: int | None = None, samples: int = 1, devices=None) -> Mesh:
    """A (carriers, samples) grid over `devices` (default: every CUDA device,
    raising where there is none).  Entries may repeat a device."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    n = len(devs)
    if n_carriers is None:
        n_carriers = n // samples
    if n_carriers * samples > n:
        raise ValueError(f"need {n_carriers * samples} devices, have {n}")
    grid = np.empty(n_carriers * samples, dtype=object)
    grid[:] = devs[: n_carriers * samples]
    return Mesh(grid.reshape(n_carriers, samples), ("carriers", "samples"))


def split_rows(x: torch.Tensor, devices: list) -> list:
    """Contiguous equal blocks of the leading axis of `x`, block i on
    devices[i]."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} positions")
    return [c.to(d) for c, d in zip(torch.chunk(x, n, dim=0), devices)]


def shard_carriers(mesh: Mesh, x: torch.Tensor, extra_dims: int = 0) -> list:
    """Split a tensor with a leading carriers axis (and `extra_dims` more
    axes) over the mesh's carriers positions: one contiguous chunk per
    position, each on its position's device."""
    if x.dim() < 1 + extra_dims:
        raise ValueError(f"expected at least {1 + extra_dims} axes, got {x.dim()}")
    return split_rows(x, mesh.axis_devices("carriers"))
