"""The port's turbo decoder against the JAX reference.

`map_decoder` on a CPU tensor runs the plain version of the MAP kernel
(`map_windows_plain`); it is held within atol 1e-4 of both JAX MAP forms:
`backend="scan"` and the Pallas kernel in interpret mode
(`backend="pallas_interpret"`, as `tests/test_turbo.py` runs it on the
CPU).  The CUDA kernel itself is compared with the plain version on the
card by `chip_smoke.py`.  The same holds for the dynamic-K mode:
`map_decoder_dyn` runs `map_windows_plain(kq=)` here and is held to the
reference's `map_decoder_dyn` (scan: atol 1e-4; Pallas interpret: atol
2e-3, the reference's own bar), below each codeblock's K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.crc as r_crc
import srsran_tpu.phy.fec.turbo as r_turbo
import srsran_tpu.phy.fec.turbo_dyn as r_dyn
from srsran_tpu.phy.common import LTE_CRC24B
from srsran_tpu_torch.phy.crc import crc_table
from srsran_tpu_torch.phy.fec import turbo_cuda
from srsran_tpu_torch.phy.fec import turbo as t_turbo
from srsran_tpu_torch.phy.fec import turbo_dyn as t_dyn

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


# mixed-K batches: K == K_max (beta_K enters at q == lw of the last window),
# the smallest K, multiples of the window length (lw = 96 at K_max 2112,
# 64 at 768), and sizes that leave whole windows as erasures
DYN_BATCHES = {2112: [2112, 40, 1056, 2048, 528, 192, 2080], 768: [768, 40, 512, 384, 704]}


@pytest.mark.parametrize("backend,atol", [("scan", 1e-4), ("pallas_interpret", 2e-3)])
@pytest.mark.parametrize("k_max", list(DYN_BATCHES))
def test_map_decoder_dyn_matches_reference(k_max, backend, atol):
    ks = np.array(DYN_BATCHES[k_max], np.int32)
    b = len(ks)
    rng = np.random.default_rng(k_max)
    below_k = np.arange(k_max)[None, :] < ks[:, None]
    lx, lz = (2.0 * rng.standard_normal((b, k_max)).astype(np.float32) * below_k
              for _ in range(2))
    beta_k = rng.standard_normal((b, 8)).astype(np.float32)
    ref = np.asarray(r_dyn.map_decoder_dyn(jnp.asarray(lx), jnp.asarray(lz), jnp.asarray(beta_k),
                                           jnp.asarray(ks), k_max, backend=backend))
    launches = turbo_cuda.LAUNCHES
    got = t_dyn.map_decoder_dyn(torch.from_numpy(lx), torch.from_numpy(lz),
                                torch.from_numpy(beta_k), torch.from_numpy(ks), k_max).numpy()
    assert turbo_cuda.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.shape == (b, k_max) and got.dtype == np.float32
    np.testing.assert_allclose(got[below_k], ref[below_k], atol=atol)
    np.testing.assert_array_equal(got[below_k] > 0, ref[below_k] > 0)


def test_map_windows_plain_kq_is_the_static_pass_at_full_size():
    """With every codeblock at K == K_max the dynamic-K mode (b_mask zero,
    kq == lw on the last window) equals the static pass bit for bit, and
    kq == 0 everywhere leaves beta to its training."""
    k, b = 768, 3
    lx, lz, lxt, lzt = (torch.from_numpy(a) for a in map_args(k, b, seed=1))
    *ins, T, lw = t_turbo.map_window_inputs(lx, lz, lxt, lzt, k)
    kq = t_dyn.lane_kq(torch.full((b,), k), k)
    assert kq.dtype == torch.int32 and kq.shape == (1, b * (k // lw))
    assert torch.equal(kq > 0, ins[7] > 0) and int(kq.max()) == lw
    static = t_turbo.map_windows_plain(*ins, T, lw)
    no_mask = ins[:7] + [torch.zeros_like(ins[7]), ins[8]]
    assert torch.equal(t_turbo.map_windows_plain(*no_mask, T, lw, kq=kq), static)
    untouched = t_turbo.map_windows_plain(*no_mask, T, lw, kq=torch.zeros_like(kq))
    assert torch.equal(untouched, t_turbo.map_windows_plain(*no_mask, T, lw))
    assert not torch.equal(untouched, static)


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
    # the dynamic-K input is checked like the others
    kq = torch.zeros((1, bn), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        turbo_cuda.map_windows(*ins, T=T, lw=lw, kq=kq)
    with pytest.raises(ValueError, match="kq has dtype"):
        turbo_cuda.map_windows(*ins, T=T, lw=lw, kq=kq.float())
    with pytest.raises(ValueError, match="kq has shape"):
        turbo_cuda.map_windows(*ins, T=T, lw=lw, kq=kq[0])
    with pytest.raises(ValueError, match="kq is on"):
        turbo_cuda.map_windows(*ins, T=T, lw=lw, kq=kq.to("meta"))
    assert turbo_cuda.LAUNCHES == turbo_cuda.LAUNCHES_DYN == 0


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
