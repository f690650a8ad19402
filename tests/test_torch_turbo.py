"""The port's turbo decoder against the JAX reference.

`map_decoder` on a CPU tensor runs the plain version of the MAP kernel
(`map_windows_plain`); it is held within atol 1e-4 of both JAX MAP forms:
`backend="scan"` and the Pallas kernel in interpret mode
(`backend="pallas_interpret"`, as `tests/test_turbo.py` runs it on the
CPU).  The CUDA kernel itself is compared with the plain version on the
card by `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.crc as r_crc
import srsran_tpu.phy.fec.turbo as r_turbo
from srsran_tpu.phy.common import LTE_CRC24B
from srsran_tpu_torch.phy.crc import crc_table
from srsran_tpu_torch.phy.fec import turbo_cuda
from srsran_tpu_torch.phy.fec import turbo as t_turbo

torch.set_num_threads(1)


def map_args(k, b, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n)).astype(np.float32) for n in (k, k, 3, 3)]


@pytest.mark.parametrize("backend", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("k", [40, 512, 2048])
def test_map_decoder_matches_reference(k, backend):
    args = map_args(k, 2, seed=k)
    def ref_fn(*a):
        return r_turbo.map_decoder(*a, k, backend=backend)

    # the scan runs faster jitted, the interpreted kernel eagerly
    if backend == "scan":
        ref_fn = jax.jit(ref_fn)
    ref = np.asarray(ref_fn(*[jnp.asarray(a) for a in args]))
    launches = turbo_cuda.LAUNCHES
    got = t_turbo.map_decoder(*[torch.from_numpy(a) for a in args], k).numpy()
    assert turbo_cuda.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.shape == (2, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_map_windows_plain_odd_window():
    """The kernel's schedule also covers odd window lengths (no K in the
    LTE table has one); the plain version there equals the full scan of
    one window started from the exact states."""
    rng = np.random.default_rng(0)
    T, lw, bn = 5, 7, 3
    ins = [torch.from_numpy(rng.standard_normal((r, bn)).astype(np.float32))
           for r in (T, T, lw, lw, T, T)]
    ones = torch.ones((1, bn))
    b_known = torch.from_numpy(rng.standard_normal((8, bn)).astype(np.float32))
    out = t_turbo.map_windows_plain(*ins, ones, ones, b_known, T, lw)
    # with both masks set the training inputs cannot matter
    zeros = [torch.zeros_like(v) for v in ins]
    same = t_turbo.map_windows_plain(zeros[0], zeros[1], ins[2], ins[3], zeros[4], zeros[5],
                                     ones, ones, b_known, T, lw)
    assert out.shape == (lw, bn) and torch.isfinite(out).all()
    assert torch.equal(out, same)


def test_map_windows_rejects_what_it_cannot_launch():
    """The kernel wrapper launches or raises; it has no plain fallback."""
    T, lw, bn = 4, 8, 5
    ins = [torch.zeros((r, bn)) for r in (T, T, lw, lw, T, T, 1, 1, 8)]
    with pytest.raises(ValueError, match="no kernel"):
        turbo_cuda.map_windows(*ins, T=T, lw=lw)
    with pytest.raises(ValueError, match="no kernel"):
        turbo_cuda.map_windows(*[v.to("meta") for v in ins], T=T, lw=lw)
    with pytest.raises(ValueError, match="dtype"):
        turbo_cuda.map_windows(*ins[:2], ins[2].double(), *ins[3:], T=T, lw=lw)
    with pytest.raises(ValueError, match="shape"):
        turbo_cuda.map_windows(*ins, T=T + 1, lw=lw)
    with pytest.raises(ValueError, match="contiguous"):
        turbo_cuda.map_windows(*ins[:2], torch.zeros((bn, lw)).T, *ins[3:], T=T, lw=lw)


@pytest.mark.parametrize("k,ebn0", [(512, 1.0), (2048, 0.8)])
def test_turbo_decode_matches_reference(k, ebn0):
    """Full iterative decode with CRC early stop near the waterfall: the
    same hard bits and iteration count as the reference; posteriors of
    codeblocks that decoded agree within the MAP bar compounded over the
    iterations (atol 1e-3)."""
    rng = np.random.default_rng(k)
    b = 4
    msgs = rng.integers(0, 2, (b, k - 24)).astype(np.uint8)
    cbs = np.stack([r_crc.crc_attach_np(m, LTE_CRC24B) for m in msgs])
    d = np.stack([r_turbo.turbo_encode_np(row) for row in cbs])
    sigma2 = 1.0 / (2.0 / 3.0 * 10 ** (ebn0 / 10))
    y = (1.0 - 2.0 * d) + rng.standard_normal(d.shape) * np.sqrt(sigma2)
    llr = (-2.0 * y / sigma2).astype(np.float32)
    table = r_crc.crc_matrix_np(LTE_CRC24B, k).astype(np.float32)
    r_bits, r_post, r_n = r_turbo.turbo_decode(jnp.asarray(llr), k, 6, crc_table=jnp.asarray(table))
    bits, post, n_it = t_turbo.turbo_decode(torch.from_numpy(llr), k, 6,
                                            crc_table=crc_table(LTE_CRC24B, k, "cpu"))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    assert n_it == int(r_n)
    ok = (bits.numpy() == cbs).all(axis=1)
    assert ok.any()
    np.testing.assert_allclose(post.numpy()[ok], np.asarray(r_post)[ok], atol=1e-3, rtol=1e-5)
