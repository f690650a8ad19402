"""`srsran_tpu_torch/parallel` against the JAX reference, on the CPU.

The three cases of `tests/test_parallel.py` on the port: the port's mesh
is one process's grid of devices, here 8 positions of the CPU (the
reference runs on the suite's 8 virtual CPU devices).  Tolerances:
- the sharded resampler against the port's and the reference's
  `resample_fft_blocks` and the reference's own sharded resampler: atol
  1e-4 (the reference's own bar; both run complex64 FFTs, in another
  library), and against the whole-stream resample away from the edges 0.02,
  as there;
- the sharded FIR: within 1e-5 of the reference's sharded FIR and 1e-4 of
  `np.convolve` over the whole stream (the reference's bar), and equal to the
  port's one-position FIR within 1e-6 (the same products, summed alike).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import srsran_tpu.parallel as r_par
import srsran_tpu.phy.resampling as r_res
from srsran_tpu_torch.parallel import (
    carrier_mesh,
    shard_carriers,
    sharded_fir,
    sharded_resample_fft,
    stream_halo_exchange,
)
from srsran_tpu_torch.parallel.mesh import Mesh as TMesh, NamedSharding, PartitionSpec
from srsran_tpu_torch.phy.resampling import resample_fft, resample_fft_blocks

torch.set_num_threads(1)


def samples_mesh(n=8):
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cpu")] * n
    return TMesh(devs, ("samples",))


def test_carrier_mesh_shapes():
    m = carrier_mesh(4, samples=2, devices=["cpu"] * 8)
    assert m.shape == {"carriers": 4, "samples": 2}
    assert m.shape == r_par.carrier_mesh(4, samples=2).shape
    x = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128).to(torch.complex64)
    xs = shard_carriers(m, x, extra_dims=1)
    assert len(xs) == 4 and all(c.shape == (1, 128) and c.device.type == "cpu" for c in xs)
    assert torch.equal(torch.cat(xs), x)
    assert NamedSharding(m, PartitionSpec("carriers", None)).spec == PartitionSpec("carriers", None)
    with pytest.raises(ValueError, match="need 16 devices"):
        carrier_mesh(8, samples=2, devices=["cpu"] * 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carrier_mesh()


def test_sharded_resample_matches_blockwise():
    """The neighbour exchange == the single-device blockwise overlap-save."""
    mesh = samples_mesh()
    n_dev, blk, halo = 8, 512, 64
    t = np.arange(n_dev * blk)
    x = (np.exp(2j * np.pi * 0.01 * t) + 0.5 * np.exp(2j * np.pi * 0.03 * t)).astype(np.complex64)
    y = sharded_resample_fft(torch.from_numpy(x), 2, 1, mesh, halo=halo).numpy()
    y_blocks = resample_fft_blocks(torch.from_numpy(x.reshape(n_dev, blk)), 2, 1, halo=halo).numpy()
    np.testing.assert_allclose(y, y_blocks.reshape(-1), atol=1e-4)
    ref_blocks = np.asarray(r_res.resample_fft_blocks(jnp.asarray(x.reshape(n_dev, blk)), 2, 1, halo=halo))
    np.testing.assert_allclose(y, ref_blocks.reshape(-1), atol=1e-4)
    ref = np.asarray(r_par.sharded_resample_fft(jnp.asarray(x), 2, 1, Mesh(np.array(jax.devices()), ("samples",)),
                                                halo=halo))
    np.testing.assert_allclose(y, ref, atol=1e-4)
    y_full = resample_fft(torch.from_numpy(x), 2, 1).numpy()
    assert np.max(np.abs(y[1024:-1024] - y_full[1024:-1024])) < 0.02


def test_sharded_fir_exact():
    """The sharded causal FIR == np.convolve on the whole stream (the
    previous chunk's tail is the filter state)."""
    mesh = samples_mesh()
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    taps = np.hamming(17).astype(np.float32)
    taps /= taps.sum()
    y = sharded_fir(torch.from_numpy(x), taps, mesh).numpy()
    ref = np.convolve(np.concatenate([np.zeros(16, np.complex64), x]), taps, mode="valid")
    np.testing.assert_allclose(y, ref, atol=1e-4)
    y_ref = np.asarray(r_par.sharded_fir(jnp.asarray(x), taps, Mesh(np.array(jax.devices()), ("samples",))))
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    np.testing.assert_allclose(y, sharded_fir(torch.from_numpy(x), taps, samples_mesh(1)).numpy(), atol=1e-6)
    # asymmetric complex taps: the convolution's direction shows
    taps_c = (rng.standard_normal(5) + 1j * rng.standard_normal(5)).astype(np.complex64)
    got = sharded_fir(torch.from_numpy(x), taps_c, mesh).numpy()
    want = np.convolve(np.concatenate([np.zeros(4, np.complex64), x]), taps_c, mode="valid")
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_stream_halo_exchange_edges():
    """Each position gets its neighbours' edges; the outer ends their own."""
    x = torch.arange(32, dtype=torch.float32).reshape(1, 32)
    chunks = list(torch.chunk(x, 4, dim=-1))
    halos = stream_halo_exchange(chunks, 2)
    assert [h[0].tolist() for h in halos] == [[[0, 1]], [[6, 7]], [[14, 15]], [[22, 23]]]
    assert [h[1].tolist() for h in halos] == [[[8, 9]], [[16, 17]], [[24, 25]], [[30, 31]]]
