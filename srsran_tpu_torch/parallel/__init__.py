"""More than one device: device grids, carrier sharding, and halo exchange
for the split sample stream (counterpart of `srsran_tpu/parallel`).

The reference scales with threads/processes + sockets (one cc_worker per
carrier, sf_worker pipelines).  The JAX package maps those onto
`jax.sharding` mesh axes; the port keeps one process and an explicit grid
of devices, each position running its block of work on its own device:

  carriers axis   <- one cc_worker thread per carrier
  samples axis    <- the ue_sync streaming loop's overlap-save state
                     (a neighbour exchange of halos replaces carried buffers)
"""

from .mesh import carrier_mesh, shard_carriers
from .halo import sharded_fir, sharded_resample_fft, stream_halo_exchange

__all__ = [
    "carrier_mesh",
    "shard_carriers",
    "sharded_fir",
    "sharded_resample_fft",
    "stream_halo_exchange",
]
