"""The benchmark's plain reference receiver, in PyTorch: samples of a batch
of subframes to (TB bits, CRC flags, snr_db), for the PDSCH on port 0 and
for the PUSCH without UCI.

It works out every table again from the standard (`tables.py`) and
imports nothing of the program.  It follows the algorithms that define
the program's outputs: CRS (DL) or DM-RS (UL) least squares with the
frequency smoothing and the linear time interpolation of srsLTE's
estimators, MRC, the zone-based max-log soft demapper, the windowed
max-log-MAP turbo decoder with T-step boundary training and an early stop
once every code block of the batch passes its CRC.  It runs the recursion
step by step in plain tensor operations, with no kernel of its own.

`precision` makes the control: None is float32 throughout (TF32 off);
"tf32" rounds the operands of every matrix product to TF32's 10-bit
mantissa, as the tensor cores would; "bf16" rounds the result of every
stage, and the turbo recursion's state metrics at every step, to bfloat16.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tables as T

NEG = -1e30
FILLER_LLR = -1e4


def lower(x: torch.Tensor, precision: str | None) -> torch.Tensor:
    """x rounded to `precision` (to nearest) and back to its own dtype."""
    if precision is None or not (x.is_floating_point() or x.is_complex()):
        return x
    if x.is_complex():
        return torch.view_as_complex(lower(torch.view_as_real(x).contiguous(), precision))
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "tf32":
        v = x.contiguous().view(torch.int32)
        return ((v + 0x1000) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"unknown precision {precision}")


class Lower:
    """Where the control rounds: `stage` after each stage under "bf16",
    `mm` on the operands of each product under "tf32"."""

    def __init__(self, precision: str | None):
        self.precision = precision

    def stage(self, x):
        return lower(x, self.precision) if self.precision == "bf16" else x

    def mm(self, x):
        return lower(x, self.precision) if self.precision == "tf32" else x


# --- OFDM ----------------------------------------------------------------------


@lru_cache(maxsize=8)
def _window_index(nof_prb: int) -> np.ndarray:
    n = T.symbol_sz(nof_prb)
    return np.asarray(T.symbol_starts(nof_prb))[:, None] + np.arange(n)[None, :]


def ofdm_rx(x: torch.Tensor, nof_prb: int, shift: float | None, lo: Lower) -> torch.Tensor:
    """(..., 15 N) samples to the (..., 14, nre) grid: optional
    half-subcarrier shift, the 14 FFT windows, FFT, the REs around DC,
    scaled by 1/sqrt(N)."""
    n = T.symbol_sz(nof_prb)
    nre = 12 * nof_prb
    if shift is not None:
        x = x * torch.from_numpy(T.half_shift(nof_prb, shift)).to(x.device)
    bins = torch.fft.fft(x[..., torch.from_numpy(_window_index(nof_prb)).to(x.device)], dim=-1)
    grid = torch.cat([bins[..., n - nre // 2 :], bins[..., 1 : 1 + nre // 2]], dim=-1)
    return lo.stage((grid * (1.0 / np.sqrt(n))).to(torch.complex64))


# --- channel estimation --------------------------------------------------------


def smooth_matrix(npil: int, length: int) -> np.ndarray:
    """(npil, npil) triangular smoothing of `length` taps, renormalised at
    the edges."""
    half = length // 2
    kern = np.array([half - abs(i - half) + 1 for i in range(2 * half + 1)], np.float64)
    kern /= kern.sum()
    w = np.zeros((npil, npil))
    for j, c in enumerate(kern):
        off = j - half
        i = np.arange(max(0, -off), min(npil, npil - off))
        w[i, i + off] += c
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _linear(pos, x: np.ndarray) -> np.ndarray:
    """(len(x), len(pos)) weights of linear interpolation between the two
    positions around each x, extrapolating past the first and the last."""
    pos = np.asarray(pos, np.float64)
    i1 = np.clip(np.searchsorted(pos, x), 1, len(pos) - 1)
    i0 = i1 - 1
    t = (x - pos[i0]) / (pos[i1] - pos[i0])
    w = np.zeros((len(x), len(pos)))
    w[np.arange(len(x)), i0] = 1.0 - t
    w[np.arange(len(x)), i1] += t
    return w.astype(np.float32)


def interp_matrix(pos, n: int) -> np.ndarray:
    """(n, len(pos)) linear interpolation over 0 .. n-1, extrapolated past
    the first and the last position (the CRS in frequency)."""
    return _linear(pos, np.arange(n, dtype=np.float64))


def time_matrix(pos, n: int) -> np.ndarray:
    """(n, len(pos)) linear interpolation over 0 .. n-1, held constant
    outside the positions (the reference symbols in time)."""
    return _linear(pos, np.clip(np.arange(n, dtype=np.float64), pos[0], pos[-1]))


@lru_cache(maxsize=8)
def _crs_tables(nof_prb: int, cell_id: int, sf_idx: int):
    syms, k = T.crs_layout(nof_prb, cell_id, 0)
    sm = smooth_matrix(2 * nof_prb, 3)
    wf = np.stack([interp_matrix(k[s], 12 * nof_prb) @ sm for s in range(4)])
    wt = time_matrix(tuple(syms.tolist()), T.NSYMB_SF)
    return syms, k, np.conj(T.crs_values(nof_prb, cell_id, sf_idx)), wf, wt


def chest_crs(grid: torch.Tensor, cfg: dict, lo: Lower):
    """Port 0's channel over the grid (B, nrx, 14, nre) from its CRS: least
    squares at the pilots, a 3-tap smoothing and linear interpolation in
    frequency, linear in time.  Returns (ce (B, nrx, 14, nre), noise
    (B, nrx), snr (B, nrx)): the noise is the power of the pilots'
    [-1/2, 1, -1/2] high-pass residual over 1.5, the SNR the pilots'
    mean power over it."""
    c = cfg["cell"]
    syms, k, ref, wf, wt = _crs_tables(c["nof_prb"], c["cell_id"], c["sf_idx"])
    dev = grid.device
    ls = lo.stage(grid[..., torch.from_numpy(syms)[:, None].to(dev), torch.from_numpy(k).to(dev)]
                  * torch.from_numpy(ref).to(dev))
    per_sym = torch.einsum("snp,...sp->...sn", lo.mm(torch.from_numpy(wf).to(dev).to(torch.complex64)),
                           lo.mm(ls))
    ce = lo.stage(torch.einsum("ls,...sn->...ln", lo.mm(torch.from_numpy(wt).to(dev).to(torch.complex64)),
                               lo.mm(per_sym)))
    resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
    noise = lo.stage(torch.mean(resid.abs() ** 2, dim=(-1, -2)) / 1.5)
    rsrp = lo.stage(torch.mean(ls.abs() ** 2, dim=(-1, -2)))
    return ce, noise, lo.stage(rsrp / torch.clamp(noise, min=1e-12))


@lru_cache(maxsize=8)
def _dmrs_tables(nof_prb_alloc: int, cell_id: int):
    m_sc = 12 * nof_prb_alloc
    return (np.conj(T.dmrs(nof_prb_alloc, cell_id)), smooth_matrix(m_sc, 5),
            time_matrix(T.DMRS_SYMS, T.NSYMB_SF))


def chest_dmrs(grid: torch.Tensor, cfg: dict, lo: Lower):
    """The channel over the PUSCH allocation from its two DM-RS symbols:
    least squares, a 5-tap smoothing in frequency, linear in time.
    Returns (ce (B, nrx, 14, m_sc), noise (B, nrx)): the noise is the power
    of the least squares' departure from the smoothed estimate."""
    gr = cfg["grant"]
    m_sc = 12 * gr["nof_prb"]
    k0 = 12 * gr["prb_start"]
    r, sm, t = (torch.from_numpy(a).to(grid.device).to(torch.complex64)
                for a in _dmrs_tables(gr["nof_prb"], cfg["cell"]["cell_id"]))
    ls = lo.stage(grid[..., list(T.DMRS_SYMS), k0 : k0 + m_sc] * r)
    ls_s = lo.stage(torch.einsum("np,...sp->...sn", lo.mm(sm), lo.mm(ls)))
    noise = lo.stage(torch.mean((ls - ls_s).abs() ** 2, dim=(-1, -2)))
    ce = lo.stage(torch.einsum("ls,...sn->...ln", lo.mm(t), lo.mm(ls_s)))
    return ce, noise


# --- equalisation and soft demapping ---------------------------------------------


def mrc(y: torch.Tensor, h: torch.Tensor, noise: torch.Tensor):
    """x = h^H y / (|h|^2 + n) over the receive antennas (axis -2), and the
    CSI |h|^2 + n."""
    hh = torch.sum(h.abs() ** 2, dim=-2) + noise
    return torch.sum(torch.conj(h) * y, dim=-2) / hh, hh


def demap(mod: str, x: torch.Tensor) -> torch.Tensor:
    """Zone-based max-log LLRs, positive for bit 1, bit-major per symbol."""
    re, im = x.real, x.imag
    if mod == "QPSK":
        cols = [-re * np.sqrt(2.0), -im * np.sqrt(2.0)]
    elif mod == "QAM16":
        th = 2.0 / np.sqrt(10.0)
        cols = [-re, -im, re.abs() - th, im.abs() - th]
    elif mod == "QAM64":
        t1, t2 = 4.0 / np.sqrt(42.0), 2.0 / np.sqrt(42.0)
        l2, l3 = re.abs() - t1, im.abs() - t1
        cols = [-re, -im, l2, l3, l2.abs() - t2, l3.abs() - t2]
    else:
        raise ValueError(mod)
    llr = torch.stack(cols, dim=-1)
    return llr.reshape(llr.shape[:-2] + (-1,)).to(torch.float32)


def signs(c_init: int, n: int, device) -> torch.Tensor:
    return torch.from_numpy(1.0 - 2.0 * T.gold(c_init, n).astype(np.float32)).to(device)


# --- turbo decoder -------------------------------------------------------------------


@lru_cache(maxsize=1)
def _trellis():
    """Predecessor and successor states of the 8-state RSC, with the ±1
    signs of the input and parity bits on each branch."""
    nxt = np.zeros((8, 2), np.int64)
    par = np.zeros((8, 2), np.int64)
    for s in range(8):
        r0, r1, r2 = s & 1, (s >> 1) & 1, (s >> 2) & 1
        for u in (0, 1):
            a = u ^ r1 ^ r2
            nxt[s, u] = a + 2 * r0 + 4 * r1
            par[s, u] = r2 ^ r0 ^ a
    prev = np.zeros((8, 2), np.int64)
    prev_u = np.zeros((8, 2), np.int64)
    prev_p = np.zeros((8, 2), np.int64)
    cnt = np.zeros(8, np.int64)
    for s in range(8):
        for u in (0, 1):
            ns = nxt[s, u]
            prev[ns, cnt[ns]], prev_u[ns, cnt[ns]], prev_p[ns, cnt[ns]] = s, u, par[s, u]
            cnt[ns] += 1

    def sign(v):
        return (2.0 * v - 1.0).astype(np.float32)[:, None]

    return (prev[:, 0], prev[:, 1], sign(prev_u[:, 0]), sign(prev_u[:, 1]),
            sign(prev_p[:, 0]), sign(prev_p[:, 1]), nxt[:, 0], nxt[:, 1],
            sign(par[:, 0]), sign(par[:, 1]))


def layout(k: int) -> tuple[int, int, int]:
    """(windows, window length, training steps) of a pass over K: for
    K > 2048 the divisor of K in [64, 160] nearest 96 (even first), else
    the widest lanes on a base of 8 / 16 / 32; 24 training steps for
    windows of 96 or more, else 32, never more than the window."""
    lw = None
    if k > 2048:
        for parity in (0, 1):
            cands = [w for w in range(64 + parity, 161, 2) if k % w == 0]
            if cands:
                lw = min(cands, key=lambda w: (abs(w - 96), w))
                break
    if lw is None:
        base = 64 if k > 2048 else 8 if k <= 512 else 16 if k <= 1024 else 32
        n_base = k // base
        m = next(c for c in range(min(64 // base, n_base), 0, -1) if n_base % c == 0)
        lw = base * m
    return k // lw, lw, min(24 if lw >= 96 else 32, lw)


def map_pass(lx, lz, beta_k, k: int, lo: Lower) -> torch.Tensor:
    """One constituent max-log-MAP pass: (B, K) LLRs and the exact tail
    beta_K (B, 8) to (B, K) posteriors.  Each window of a code block starts
    from T training steps over its neighbours (all states equal), window 0
    from state 0 and the last window from beta_K."""
    nw, lw, tt = layout(k)
    b = lx.shape[0]
    bn = b * nw
    dev = lx.device
    ps0, ps1, su0, su1, sp0, sp1, ns0, ns1, sq0, sq1 = (
        torch.from_numpy(a).to(dev) for a in _trellis())

    def lanes(v, rows):
        return v.permute(2, 0, 1).reshape(rows, bn)

    x, z = 0.5 * lx, 0.5 * lz
    pad_lo = torch.cat([x.new_zeros((b, tt)), x], -1)[:, :k], torch.cat([z.new_zeros((b, tt)), z], -1)[:, :k]
    pad_hi = torch.cat([x, x.new_zeros((b, lw))], -1)[:, lw:], torch.cat([z, z.new_zeros((b, lw))], -1)[:, lw:]
    ax_tr, az_tr = (lanes(v.reshape(b, nw, lw)[:, :, :tt], tt) for v in pad_lo)
    bx_tr, bz_tr = (lanes(v.reshape(b, nw, lw)[:, :, :tt], tt) for v in pad_hi)
    ax, az = (lanes(v.reshape(b, nw, lw), lw) for v in (x, z))
    first = torch.from_numpy(np.tile(np.arange(nw) == 0, b)).to(dev)[None, :]
    last = torch.from_numpy(np.tile(np.arange(nw) == nw - 1, b)).to(dev)[None, :]
    b_known = beta_k.T[:, :, None].expand(8, b, nw).reshape(8, bn)

    def alpha(a, xt, zt):
        return lo.stage(torch.maximum(a[ps0] + (su0 * xt + sp0 * zt), a[ps1] + (su1 * xt + sp1 * zt)))

    def branches(bb, xt, zt):
        return bb[ns0] + (-xt + sq0 * zt), bb[ns1] + (xt + sq1 * zt)

    a = torch.zeros((8, bn), device=dev)
    bb = torch.zeros_like(a)
    for t in range(tt):
        a = alpha(a, ax_tr[t], az_tr[t])
        bb = lo.stage(torch.maximum(*branches(bb, bx_tr[tt - 1 - t], bz_tr[tt - 1 - t])))
    start = torch.full((8, 1), NEG, device=dev)
    start[0] = 0.0
    a = torch.where(first, start, a)
    bb = torch.where(last, b_known, bb)
    alphas = torch.empty((lw, 8, bn), device=dev)
    for j in range(lw):
        alphas[j] = a
        a = alpha(a, ax[j], az[j])
    out = torch.empty((lw, bn), device=dev)
    for j in range(lw - 1, -1, -1):
        b0, b1 = branches(bb, ax[j], az[j])
        out[j] = torch.max(alphas[j] + b1, 0).values - torch.max(alphas[j] + b0, 0).values
        bb = lo.stage(torch.maximum(b0, b1))
    return lo.stage(out.reshape(lw, b, nw).permute(1, 2, 0).reshape(b, k))


def beta_tail(lx_t: torch.Tensor, lz_t: torch.Tensor) -> torch.Tensor:
    """Exact beta at position K from the three tail steps (B, 3) of LLRs."""
    s = np.arange(8)
    r0, r1, r2 = s & 1, (s >> 1) & 1, (s >> 2) & 1
    dev = lx_t.device
    sb = torch.from_numpy((1.0 - 2.0 * (r1 ^ r2)).astype(np.float32)).to(dev)
    sp = torch.from_numpy((1.0 - 2.0 * (r2 ^ r0)).astype(np.float32)).to(dev)
    nxt = torch.from_numpy(2 * r0 + 4 * r1).to(dev)
    beta = torch.full(lx_t.shape[:-1] + (8,), NEG, device=dev)
    beta[..., 0] = 0.0
    for step in (2, 1, 0):
        beta = -(sb * 0.5 * lx_t[..., step : step + 1] + sp * 0.5 * lz_t[..., step : step + 1]) + beta[..., nxt]
    return beta


def crc_rows(bits: torch.Tensor, poly: int) -> torch.Tensor:
    """(..., 24) CRC of {0,1} rows: one float32 product with the CRC matrix,
    exact for rows below 2^24 bits."""
    m = torch.from_numpy(T.crc_matrix(poly, bits.shape[-1]).astype(np.float32)).to(bits.device)
    return (torch.matmul(bits.to(torch.float32), m).to(torch.int32) & 1).to(torch.uint8)


def turbo_decode(d: torch.Tensor, k: int, max_iterations: int, poly: int, lo: Lower):
    """Code blocks (N, 3, K+4) of d-stream LLRs to (bits (N, K) uint8,
    CRC ok (N,)): iterations stop once every block passes its CRC, and a
    block that passes is frozen."""
    n = d.shape[0]
    dev = d.device
    per = torch.from_numpy(T.qpp(k)).to(dev)
    inv = torch.empty_like(per)
    inv[per] = torch.arange(k, device=dev)
    sys, p1, p2 = d[:, 0, :k], d[:, 1, :k], d[:, 2, :k]
    t = d[:, :, k:]
    lx1 = torch.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], -1)
    lz1 = torch.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], -1)
    lx2 = torch.stack([t[:, 0, 2], t[:, 2, 2], t[:, 1, 3]], -1)
    lz2 = torch.stack([t[:, 1, 2], t[:, 0, 3], t[:, 2, 3]], -1)
    bt1, bt2 = beta_tail(lx1, lz1), beta_tail(lx2, lz2)
    sys_int = sys[:, per]
    ext2 = torch.zeros((n, k), device=dev)
    post = torch.zeros_like(ext2)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    it = 0
    while it < max_iterations and not bool(done.all()):
        x1 = sys + ext2
        ext1 = lo.stage(map_pass(x1, p1, bt1, k, lo) - x1)
        in2 = sys_int + ext1[:, per]
        new2 = lo.stage((map_pass(in2, p2, bt2, k, lo) - in2)[:, inv])
        ext2 = torch.where(done[:, None], ext2, new2)
        post = torch.where(done[:, None], post, sys + ext1 + new2)
        done = done | torch.all(crc_rows((post > 0).to(torch.uint8), poly) == 0, dim=-1)
        it += 1
    return (post > 0).to(torch.uint8), done


def sch_decode(llr: torch.Tensor, tbs: int, qm: int, rv: int, max_iterations: int, lo: Lower):
    """Codeword LLRs (B, g) to (TB bits (B, tbs) uint8, ok (B,)): per code
    block the circular-buffer positions summed back into the d-streams,
    filler bits pinned to a known 0, all blocks of the batch decoded
    together, CRC24B per block, CRC24A over the TB."""
    b, g = llr.shape
    sizes, f = T.segment(tbs)
    if len(set(sizes)) != 1:
        raise ValueError("the reference decodes TBs of one code block size")
    k = sizes[0]
    c = len(sizes)
    es = T.e_sizes(g, c, qm)
    off = np.concatenate([[0], np.cumsum(es)])
    rows = []
    for r in range(c):
        fr = f if r == 0 else 0
        idx = torch.from_numpy(T.rm_indices(k, es[r], rv, fr)).to(llr.device)
        flat = torch.zeros((b, 3 * (k + 4)), device=llr.device)
        flat.index_add_(1, idx, llr[:, off[r] : off[r + 1]])
        dd = flat.reshape(b, 3, k + 4)
        if fr:
            dd[:, 0, :fr] = FILLER_LLR
        rows.append(dd)
    poly = T.CRC24B if c > 1 else T.CRC24A
    bits, cb_ok = turbo_decode(lo.stage(torch.stack(rows, 1).reshape(b * c, 3, k + 4)), k,
                               max_iterations, poly, lo)
    bits, cb_ok = bits.reshape(b, c, k), cb_ok.reshape(b, c)
    crc_len = 24 if c > 1 else 0
    whole = torch.cat([bits[:, r, (f if r == 0 else 0) : k - crc_len] for r in range(c)], -1)
    tb = whole[:, :tbs]
    ok = torch.all(crc_rows(tb, T.CRC24A) == whole[:, tbs:], -1) & cb_ok.all(-1)
    return tb, ok


# --- the two receivers ------------------------------------------------------------------


def pdsch_receive(samples: torch.Tensor, cfg: dict, precision: str | None = None):
    """(B, nrx, 15 N) samples of PDSCH subframes (port 0, CRS of one port)
    to (tb (B, tbs) uint8, ok (B,), snr_db (B,))."""
    lo = Lower(precision)
    c, gr = cfg["cell"], cfg["grant"]
    grid = ofdm_rx(samples, c["nof_prb"], None, lo)
    ce, noise, snr = chest_crs(grid, cfg, lo)
    b, nrx = grid.shape[:2]
    prb = tuple(range(gr["prb_start"], gr["prb_start"] + gr["nof_prb"]))
    idx = torch.from_numpy(T.pdsch_re(c["nof_prb"], c["cell_id"], c["nof_ports"], c["sf_idx"],
                                      c["cfi"], prb)).to(samples.device)
    y = grid.reshape(b, nrx, -1)[..., idx]
    h = ce.reshape(b, nrx, -1)[..., idx]
    x, csi = mrc(y, h, torch.mean(noise, dim=1)[:, None])
    qm = T.QM[gr["mod"]]
    g = idx.numel() * qm
    llr = lo.stage(demap(gr["mod"], lo.stage(x)) * torch.repeat_interleave(lo.stage(csi), qm, -1))
    llr = llr * signs(T.pdsch_cinit(gr["rnti"], c["sf_idx"], c["cell_id"]), g, samples.device)
    tb, ok = sch_decode(llr, gr["tbs"], qm, gr["rv"], cfg["max_iterations"], lo)
    return tb, ok, 10.0 * torch.log10(torch.mean(snr, dim=1))


def pusch_receive(samples: torch.Tensor, cfg: dict, precision: str | None = None):
    """(B, nrx, 15 N) samples of PUSCH subframes to (tb (B, tbs) uint8,
    ok (B,), snr_db (B,))."""
    lo = Lower(precision)
    c, gr = cfg["cell"], cfg["grant"]
    dev = samples.device
    grid = ofdm_rx(samples, c["nof_prb"], -1.0, lo)
    ce, noise = chest_dmrs(grid, cfg, lo)
    noise = torch.mean(noise, dim=1)
    b, nrx = grid.shape[:2]
    m_sc = 12 * gr["nof_prb"]
    k0 = 12 * gr["prb_start"]
    data = list(T.PUSCH_DATA_SYMS)
    nsym = len(data)
    xf, csi = mrc(grid[:, :, data, k0 : k0 + m_sc].reshape(b, nrx, -1),
                  ce[:, :, data, :].reshape(b, nrx, -1), noise[:, None])
    idft = torch.from_numpy(T.dft_matrix(m_sc, True)).to(dev)
    x = lo.stage(torch.matmul(lo.mm(lo.stage(xf).reshape(b, nsym, m_sc)), lo.mm(idft)))
    qm = T.QM[gr["mod"]]
    g = nsym * m_sc * qm
    csi_t = torch.mean(lo.stage(csi).reshape(b, nsym, m_sc), dim=-1)
    llr = lo.stage(demap(gr["mod"], x.reshape(b, -1)) * torch.repeat_interleave(csi_t, m_sc * qm, -1))
    inter = torch.from_numpy(T.ul_interleaver(g, qm)).to(dev)
    deint = torch.empty_like(inter)
    deint[inter] = torch.arange(g, device=dev)
    llr = (llr * signs(T.pusch_cinit(gr["rnti"], c["sf_idx"], c["cell_id"]), g, dev))[:, deint]
    tb, ok = sch_decode(llr, gr["tbs"], qm, gr["rv"], cfg["max_iterations"], lo)
    sig = torch.mean(ce.abs() ** 2, dim=(1, 2, 3))
    return tb, ok, 10.0 * torch.log10(sig / (noise + 1e-12))
