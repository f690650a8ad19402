"""The port's turbo decoder against the JAX reference.

`map_decoder` on a CPU tensor runs the plain version of the MAP kernel
(`map_pass_plain`: lane layout, `map_windows_plain`, and back); it is held
within atol 1e-4 of both JAX MAP forms: `backend="scan"` and the Pallas
kernel in interpret mode (`backend="pallas_interpret"`, as
`tests/test_turbo.py` runs it on the CPU).  The CUDA kernel itself is
compared with the plain version on the card by `chip_smoke.py`.  The same
holds for the dynamic-K mode: `map_decoder_dyn` runs
`map_pass_plain(k_vec=)` here and is held to the reference's
`map_decoder_dyn` (scan: atol 1e-4; Pallas interpret: atol 2e-3, the
reference's own bar), below each codeblock's K.

What of the kernel can be held here is: its host side (`launch_plan`, the
shared-memory size for every LTE K) and its schedule — two threads a lane,
checkpoints every `CKPT` steps, segments rebuilt in the second half,
posteriors written over x — which `kernel_schedule` below follows step by
step in torch and which must give `map_pass_plain`'s bits.
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
from srsran_tpu_torch.phy.fec.cbsegm import CB_SIZES
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
    *ins, T, lw = t_turbo.map_window_lanes(lx, lz, t_turbo._beta_tail(lxt, lzt), k)
    kq = t_turbo.lane_kq(torch.full((b,), k), k)
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
    b, nw, lw, T = 3, 2, 8, 4
    lx, lz, beta_k = torch.zeros((b, nw * lw)), torch.zeros((b, nw * lw)), torch.zeros((b, 8))
    with pytest.raises(ValueError, match="no kernel"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T)
    with pytest.raises(ValueError, match="no kernel"):
        turbo_cuda.map_pass(lx.to("meta"), lz.to("meta"), beta_k.to("meta"), nw, lw, T)
    with pytest.raises(ValueError, match="lz has dtype"):
        turbo_cuda.map_pass(lx, lz.double(), beta_k, nw, lw, T)
    with pytest.raises(ValueError, match="lx has shape"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw + 1, lw, T)
    with pytest.raises(ValueError, match="invalid"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, lw + 1)
    with pytest.raises(ValueError, match="lx is not contiguous"):
        turbo_cuda.map_pass(torch.zeros((nw * lw, b)).T, lz, beta_k, nw, lw, T)
    with pytest.raises(ValueError, match="beta_k has shape"):
        turbo_cuda.map_pass(lx, lz, beta_k.T.contiguous(), nw, lw, T)
    with pytest.raises(ValueError, match="lz is on"):
        turbo_cuda.map_pass(lx, lz.to("meta"), beta_k, nw, lw, T)
    # the dynamic-K input is checked like the others
    k_vec = torch.full((b,), nw * lw, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec)
    with pytest.raises(ValueError, match="k_vec has dtype"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec.long())
    with pytest.raises(ValueError, match="k_vec has shape"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec[:2])
    with pytest.raises(ValueError, match="k_vec is on"):
        turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec.to("meta"))
    assert turbo_cuda.LAUNCHES == turbo_cuda.LAUNCHES_DYN == 0


@pytest.mark.parametrize("k", CB_SIZES)
def test_launch_plan_fits_the_card(k):
    """For each of the 188 LTE sizes, and any batch, the kernel's blocks fit
    an SM of the H100 (232,448 bytes of shared memory, 1024 threads); the
    plan does not depend on the mode.  Up to 132 codeblocks it is one
    codeblock per block."""
    nw, lw, T = t_turbo.pass_layout(k)
    assert nw * lw == k and 1 <= T <= lw
    for b in (1, 16, 132, 1408, 100000):
        cpb, smem = turbo_cuda.launch_plan(b, nw, lw)
        lanes = cpb * nw
        assert 1 <= cpb <= max(1, -(-b // 132)) and (cpb == 1 or lanes <= turbo_cuda.MAX_LANES)
        assert smem == turbo_cuda.smem_bytes(lanes, lw) <= turbo_cuda.SMEM_MAX == 232448
        assert turbo_cuda.block_threads(lanes) <= 1024
        # x and z of the block's codeblocks fit beside the checkpoints
        assert smem >= 2 * 4 * cpb * k + lanes * 2 * 32 * -(-(lw // 2) // turbo_cuda.CKPT)
    # at the large K three blocks share an SM
    if k >= 2048:
        assert turbo_cuda.launch_plan(1408, nw, lw)[1] <= turbo_cuda.SMEM_THREE_BLOCKS


def _alpha_step(a, x, z):
    p, q = x + z, x - z
    mx = torch.maximum
    return torch.stack([mx(a[0] - p, a[4] + p), mx(a[0] + p, a[4] - p),
                        mx(a[1] - q, a[5] + q), mx(a[1] + q, a[5] - q),
                        mx(a[2] + q, a[6] - q), mx(a[2] - q, a[6] + q),
                        mx(a[3] + p, a[7] - p), mx(a[3] - p, a[7] + p)])


def _beta_branches(b, x, z):
    p, q = x + z, x - z
    return (torch.stack([b[0] - p, b[2] - q, b[5] - q, b[7] - p,
                         b[1] - p, b[3] - q, b[4] - q, b[6] - p]),
            torch.stack([b[1] + p, b[3] + q, b[4] + q, b[6] + p,
                         b[0] + p, b[2] + q, b[5] + q, b[7] + p]))


def _posterior(a, b, x, z):
    b0, b1 = _beta_branches(b, x, z)
    m0, m1 = a[0] + b0[0], a[0] + b1[0]
    for s in range(1, 8):
        m0, m1 = torch.maximum(m0, a[s] + b0[s]), torch.maximum(m1, a[s] + b1[s])
    return m1 - m0


def kernel_schedule(lx, lz, beta_k, nw, lw, T, k_vec=None):
    """`csrc/map_window.cu` step by step, every thread of a block at once:
    the block's codeblocks staged at a window stride of lw | 1, a forward
    and a backward pass per lane that keep their metric every CKPT steps up
    to the middle, then each rebuilding the other's metrics segment by
    segment, with the posteriors written over x."""
    n_cb, k = lx.shape
    cpb, _ = turbo_cuda.launch_plan(n_cb, nw, lw)
    ckpt, h, stride, dyn = turbo_cuda.CKPT, lw // 2, lw | 1, k_vec is not None
    nseg = -(-h // ckpt)
    out = torch.full_like(lx, float("nan"))
    neg = torch.full((8, 1), float(t_turbo.NEG_INF))
    neg[0] = 0.0
    for cb0 in range(0, n_cb, cpb):
        my = min(cpb, n_cb - cb0)
        e = torch.arange(my * k)
        at = (e // lw) * stride + e % lw
        xs = torch.full((cpb * nw * stride,), float("nan"))
        zs = xs.clone()
        xs[at], zs[at] = 0.5 * lx[cb0:cb0 + my].reshape(-1), 0.5 * lz[cb0:cb0 + my].reshape(-1)
        t = torch.arange(my * nw)
        w, cb, base = t % nw, cb0 + t // nw, t * stride
        first, last = w == 0, w == nw - 1
        bk = beta_k[cb].T
        kq = torch.zeros_like(t)
        if dyn:
            kl = k_vec[cb].long() - w * lw
            kq = torch.where((kl >= 1) & (kl <= lw), kl, 0)

        def inject(b, pos):  # b is beta at local position pos
            return torch.where(kq == pos, bk, b) if dyn else b

        # forward threads, first half
        a = torch.zeros((8, len(t)))
        for i in range(T):
            at_i = (base - stride + lw - T + i).clamp(min=0)
            a = _alpha_step(a, xs[at_i], zs[at_i])
        a = torch.where(first, neg, a)
        ck_a, ck_b = {}, {}
        for i in range(h):
            if i % ckpt == 0:
                ck_a[i // ckpt] = a
            a = _alpha_step(a, xs[base + i], zs[base + i])
        # backward threads, first half
        b = torch.zeros((8, len(t)))
        for i in range(T - 1, -1, -1):
            at_i = (base + stride + i).clamp(max=len(xs) - 1)
            b = torch.where(last, b, torch.maximum(*_beta_branches(b, xs[at_i], zs[at_i])))
        if not dyn:
            b = torch.where(last, bk, b)
        for i in range(h):
            b = inject(b, lw - i)
            if i % ckpt == 0:
                ck_b[i // ckpt] = b
            b = torch.maximum(*_beta_branches(b, xs[base + lw - 1 - i], zs[base + lw - 1 - i]))
        if lw & 1:
            b = inject(b, h + 1)
            ck_b[nseg] = b
            b = torch.maximum(*_beta_branches(b, xs[base + h], zs[base + h]))
        # the barrier in the middle; forward threads, second half
        if lw & 1:
            xh, zh = xs[base + h], zs[base + h]
            xs[base + h] = _posterior(a, ck_b[nseg], xh, zh)
            a = _alpha_step(a, xh, zh)
        for seg in range(nseg - 1, -1, -1):
            i0 = seg * ckpt
            ln = min(ckpt, h - i0)
            xr = [xs[base + lw - 1 - (i0 + r)] for r in range(ln)]
            zr = [zs[base + lw - 1 - (i0 + r)] for r in range(ln)]
            kept = [ck_b[seg]]
            for r in range(1, ln):
                kept.append(inject(torch.maximum(*_beta_branches(kept[-1], xr[r - 1], zr[r - 1])),
                                   lw - (i0 + r)))
            for r in range(ln - 1, -1, -1):
                xs[base + lw - 1 - (i0 + r)] = _posterior(a, kept[r], xr[r], zr[r])
                a = _alpha_step(a, xr[r], zr[r])
        # backward threads, second half
        for seg in range(nseg - 1, -1, -1):
            i0 = seg * ckpt
            ln = min(ckpt, h - i0)
            xr = [xs[base + i0 + r] for r in range(ln)]
            zr = [zs[base + i0 + r] for r in range(ln)]
            kept = [ck_a[seg]]
            for r in range(1, ln):
                kept.append(_alpha_step(kept[-1], xr[r - 1], zr[r - 1]))
            for r in range(ln - 1, -1, -1):
                b = inject(b, i0 + r + 1)
                xs[base + i0 + r] = _posterior(kept[r], b, xr[r], zr[r])
                b = torch.maximum(*_beta_branches(b, xr[r], zr[r]))
        out[cb0:cb0 + my] = xs[at].reshape(my, k)
    return out


# (K, codeblocks, layout where it is not K's own): one window, several
# codeblocks a block with a ragged last block, the two large layouts, an odd
# window length, and windows shorter than a checkpoint segment
SCHEDULE_CASES = [(40, 5, None), (40, 300, None), (512, 7, None), (2048, 3, None),
                  (6144, 2, None), (6080, 1, None), (135, 4, (3, 45, 32)),
                  (35, 300, (5, 7, 5)), (3, 2, (3, 1, 1)), (3, 2, (1, 3, 0))]


@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dyn"])
@pytest.mark.parametrize("k,b,layout", SCHEDULE_CASES)
def test_kernel_schedule_gives_the_plain_bits(k, b, layout, dyn):
    rng = np.random.default_rng(k + b)
    lx, lz, beta_k = (torch.from_numpy(4 * rng.standard_normal(s).astype(np.float32))
                      for s in ((b, k), (b, k), (b, 8)))
    nw, lw, T = layout or t_turbo.pass_layout(k)
    k_vec, below_k = None, torch.ones((b, k), dtype=torch.bool)
    if dyn:  # K == K_max, K at a window boundary, and random sizes
        k_vec = torch.from_numpy(rng.integers(1, k + 1, b).astype(np.int32))
        k_vec[0], k_vec[-1] = k, max(1, k - lw)
        below_k = torch.arange(k)[None, :] < k_vec[:, None]
        lx, lz = lx * below_k, lz * below_k
    ref = t_turbo.map_pass_plain(lx, lz, beta_k, k, k_vec, layout=layout)
    got = kernel_schedule(lx, lz, beta_k, nw, lw, T, k_vec)
    assert torch.equal(got[below_k], ref[below_k])


def test_map_pass_plain_takes_an_explicit_layout():
    """An explicit (nw, lw, T) equal to K's own changes nothing; one with an
    odd window length (no LTE K has one) runs, and with one window and no
    training it is the exact recursion, which ignores the layout's T."""
    k, b = 512, 2
    lx, lz, lxt, lzt = (torch.from_numpy(a) for a in map_args(k, b, seed=2))
    beta_k = t_turbo._beta_tail(lxt, lzt)
    own = t_turbo.map_pass_plain(lx, lz, beta_k, k)
    assert torch.equal(own, t_turbo.map_pass_plain(lx, lz, beta_k, k, layout=t_turbo.pass_layout(k)))
    assert torch.equal(own, t_turbo.map_decoder(lx, lz, lxt, lzt, k))
    k = 135
    lx, lz, lxt, lzt = (torch.from_numpy(a) for a in map_args(k, b, seed=3))
    beta_k = t_turbo._beta_tail(lxt, lzt)
    windowed = t_turbo.map_pass_plain(lx, lz, beta_k, k, layout=(3, 45, 32))
    assert windowed.shape == (b, k) and torch.isfinite(windowed).all()
    exact = t_turbo.map_pass_plain(lx, lz, beta_k, k, layout=(1, 135, 0))
    assert torch.equal(exact, t_turbo.map_pass_plain(lx, lz, beta_k, k, layout=(1, 135, 32)))
    assert not torch.equal(exact, windowed)


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
