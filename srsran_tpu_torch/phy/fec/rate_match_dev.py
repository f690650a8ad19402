"""Turbo de-rate-matching with the index arithmetic done on the device
(TS 36.212 §5.1.4.1).

Counterpart of `srsran_tpu/phy/fec/rate_match_dev.py`.  The static path
(`rate_match.py`) builds one host index vector per (K, E, rv, filler) and
caches it; here the sub-block interleaver, the <NULL>-skipping circular
buffer and the rv start are closed-form index arithmetic on a few integers
per codeblock that arrive as data, so one set of shapes serves every
(K, E, rv, filler).

A transport block has at most 3 codeblock layouts (codeblock 0 with its
filler bits, K-, K+): the per-position tables are built per layout variant,
batched over a leading variant axis, and each codeblock picks its variant's
row.  The grid-form helpers work on one transport block's codeblocks
(`turbo_rm_positions_dev`, `codeword_scatter_dev`, `codeword_d_fill_dev`,
`tb_reassembly_gather_dev`), each on the device of its inputs.  Modulo and
division on possibly negative operands are floor operations
(`torch.remainder`, `//` on tensors) throughout; indices are int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import table
from .cbsegm import qpp_interleaver_np
from .rate_match import NCOLS, RM_PERM_TC


def ncb_max(k_max: int) -> int:
    """Static circular-buffer bound for codeblocks up to k_max."""
    d = k_max + 4
    return 3 * (-(-d // NCOLS)) * NCOLS


def _perm_tables():
    inv_perm = np.empty(NCOLS, np.int64)
    inv_perm[RM_PERM_TC] = np.arange(NCOLS)
    return RM_PERM_TC, inv_perm


def _buffer_dev(k: torch.Tensor, f: torch.Tensor, k_max: int):
    """The circular buffer in unrotated order.  k, f: (V,) int64 codeblock
    size and filler count.  Returns (valid (V, NCB) bool, w_flat (V, NCB) —
    the flat d-stream index stream * (k_max+4) + position of each buffer
    entry —, r, kp, nd, ncb (V, 1))."""
    NCB = ncb_max(k_max)
    perm, _ = table(_perm_tables, device=k.device)
    k, f = k[:, None], f[:, None]
    d = k + 4
    r = (d + NCOLS - 1) // NCOLS
    kp = NCOLS * r
    nd = kp - d
    ncb = 3 * kp
    m = torch.arange(NCB, device=k.device)[None, :]
    ca = torch.clamp(m // r, 0, NCOLS - 1)
    ya = (m % r) * NCOLS + perm[ca]
    j = m - kp
    i1 = torch.clamp(j // 2, min=0)  # j < 0 only where region A wins the select
    cb = torch.clamp(i1 // r, 0, NCOLS - 1)
    yb1 = (i1 % r) * NCOLS + perm[cb]
    yb2 = (perm[cb] + NCOLS * (i1 % r) + 1) % kp
    is_even = torch.remainder(j, 2) == 0
    in_a = m < kp
    stream = torch.where(in_a, 0, torch.where(is_even, 1, 2))
    y = torch.where(in_a, ya, torch.where(is_even, yb1, yb2))
    dpos = y - nd
    # filler bits are <NULL> in streams 0 and 1
    valid = (y >= nd) & (m < ncb) & ~((stream < 2) & (dpos < f))
    w_flat = stream * (k_max + 4) + torch.clamp(dpos, min=0)
    return valid, w_flat, r, kp, nd, ncb


def _valid_rank_dev(k: torch.Tensor, f: torch.Tensor, k_max: int):
    """Validity mask and inclusive rank over the circular buffer, in
    unrotated order.  k, f: (V,) int64 codeblock size and filler count.
    Returns (valid (V, NCB) bool, rank_incl (V, NCB), r, kp, nd, ncb (V, 1))."""
    valid, _w_flat, r, kp, nd, ncb = _buffer_dev(k, f, k_max)
    return valid, torch.cumsum(valid.to(torch.int64), dim=1), r, kp, nd, ncb


def _as_int64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def turbo_rm_positions_dev(k, f, rv, k_max: int):
    """The circular-buffer position table of codeblocks, on the device of k.

    k, f: integer tensors of one shape S (0-d for one codeblock) — size and
    filler bits; rv: an integer or a tensor of shape S.  k_max: the static
    bound.  Returns (pos_valid S + (NCB_MAX,) int64, n_valid S int64):
    pos_valid[..., m] is the flat d-stream index (stream * (k_max+4) +
    position) of the m-th transmitted bit when the buffer is read from
    k0(rv) on, <NULL> and filler positions skipped; entries from n_valid on
    are the dump index 3*(k_max+4).  n_valid = 3*(k+4) - 2*f is the number
    of distinct transmitted positions."""
    k = torch.as_tensor(k)
    shape, dev = k.shape, k.device
    NCB = ncb_max(k_max)
    k, f = k.reshape(-1).to(torch.int64), _as_int64(f, dev).reshape(-1)
    valid, w_flat, r, kp, nd, ncb = _buffer_dev(k, f, k_max)
    # rv start: ncb = 96r, so ceil(ncb / (8r)) = 12 and k0 = r * (24*rv + 2)
    k0 = r * (24 * _as_int64(rv, dev).reshape(-1, 1) + 2)
    m = torch.arange(NCB, device=dev)[None, :]
    rot = torch.remainder(k0 + m, ncb)
    v_rot = torch.gather(valid, 1, rot) & (m < ncb)  # exactly one sweep
    rank = torch.cumsum(v_rot.to(torch.int64), dim=1) - 1
    tgt = torch.where(v_rot, rank, NCB)  # the spare column NCB is dropped
    pos = torch.full((k.shape[0], NCB + 1), 3 * (k_max + 4), dtype=torch.int64, device=dev)
    pos.scatter_(1, tgt, torch.gather(w_flat, 1, rot))
    n_valid = 3 * (k + 4) - 2 * f
    return pos[:, :NCB].reshape(*shape, NCB), n_valid.reshape(shape)


def _segment_of(u: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """The segment each position u falls in, for segments ending at the
    inclusive-scan `bounds` (B,): the count of bounds <= u, at most B - 1."""
    seg = (u[:, None] >= bounds[None, :]).sum(dim=1)
    return torch.clamp(seg, max=bounds.shape[0] - 1)


def codeword_scatter_dev(cb_k, cb_e, cb_f, cb_valid, rv, k_max: int, g_max: int):
    """Scatter targets of one transport block's de-rate-match, on the
    device of cb_k.

    cb_k/cb_e/cb_f: (B,) integer per-codeblock size, rate-matched length
    and filler count; cb_valid: (B,) bool; rv: an integer or 0-d tensor.
    Returns (G_MAX,) int64: codeword position g goes to flat index
    cb * 3*(k_max+4) + d-stream index of the (B, 3, k_max+4) softbuffer;
    positions past the codeword, or mapping to <NULL>, get the dump index
    B * 3*(k_max+4)."""
    dev = cb_k.device
    bsz = cb_k.shape[0]
    dflat = 3 * (k_max + 4)
    cb_k, cb_e, cb_f = (_as_int64(x, dev) for x in (cb_k, cb_e, cb_f))
    pos_valid, n_valid = turbo_rm_positions_dev(cb_k, cb_f, rv, k_max)  # (B, NCB), (B,)
    n_valid = torch.where(cb_valid, torch.clamp(n_valid, min=1), 1)
    bounds = torch.cumsum(torch.where(cb_valid, cb_e, 0), dim=0)
    g = torch.arange(g_max, device=dev)
    cb = _segment_of(g, bounds)
    start = torch.cat([bounds.new_zeros(1), bounds[:-1]])
    mm = torch.remainder(g - start[cb], n_valid[cb])
    pos = pos_valid[cb, mm]
    # a position past the codeword, or one at its codeblock's own dump slot
    keep = (g < bounds[-1]) & (pos < dflat)
    return torch.where(keep, cb * dflat + pos, bsz * dflat)


def codeword_d_fill_dev(llr_pad, off, e, k, f, rv, k_max: int, rep: int):
    """De-rate-match one codeblock by gathers, on the device of llr_pad.

    llr_pad: (G + NCB_MAX,) codeword LLRs, zero-padded (shared by the
    transport block's codeblocks).  off/e/k/f: integers or 0-d tensors —
    this codeblock's codeword offset, rate-matched length, size and filler
    count; rv likewise.  rep: the static bound on the repetition folds
    ceil(e / n_valid); a codeblock that needs more raises ValueError (one
    read of e, k, f when they are tensors).
    Returns (3, k_max+4) accumulated d-stream LLRs: position p holds the sum
    of every transmitted bit that maps to it (the HARQ `+=` of the
    rate-matching receiver); <NULL>, filler and beyond-K positions are 0.
    The work is a cumsum, the strided folds the codeblock needs (at most
    `rep`) and two gather passes (`codeword_d_fill_grouped_dev` over one
    codeblock)."""
    dev = llr_pad.device
    e_, k_, f_ = (int(x) for x in torch.stack([_as_int64(x, dev) for x in (e, k, f)]).tolist())
    need = -(-e_ // max(3 * (k_ + 4) - 2 * f_, 1))
    if need > rep:
        raise ValueError(f"codeword_d_fill_dev: e={e_} needs {need} repetition folds of a "
                         f"K={k_} codeblock (filler {f_}), more than rep={rep}")
    one = lambda x: _as_int64(x, dev).reshape(1)  # noqa: E731
    cls = torch.zeros(1, dtype=torch.int64, device=dev)
    return codeword_d_fill_grouped_dev(llr_pad, one(off), one(e), cls, one(k), one(f),
                                       _as_int64(rv, dev), k_max, rep, folds=need)[0]


def _j0_variant_dev(k: torch.Tensor, f: torch.Tensor, rv: torch.Tensor, k_max: int):
    """Per-layout-variant first-fold index table.  k, f: (V,) int64; rv:
    0-d integer tensor.  Returns (j0 (V, 3*(k_max+4)), n_valid (V,)):
    j0[v, p] is the rank of flat d-stream position p in the rv-rotated
    transmitted sequence — position p accumulates llr[off + j0 + t*n_valid]
    over the folds t — or the dump index NCB where p is <NULL>, filler or
    beyond K."""
    dflat = 3 * (k_max + 4)
    NCB = ncb_max(k_max)
    _, inv_perm = table(_perm_tables, device=k.device)

    _valid, rank_incl, r, kp, nd, _ncb = _valid_rank_dev(k, f, k_max)
    d = k[:, None] + 4
    n_valid = torch.clamp(3 * d - 2 * f[:, None], min=1)
    k0 = r * (24 * rv + 2)  # ncb = 96r, so ceil(ncb / (8r)) = 12
    r0 = torch.gather(rank_incl, 1, k0 - 1)  # k0 >= 2r >= 2

    p = torch.arange(dflat, device=k.device)[None, :]
    stream = p // (k_max + 4)
    dpos = p % (k_max + 4)
    y = dpos + nd
    m01 = inv_perm[y % NCOLS] * r + y // NCOLS
    u = torch.remainder(y + kp - 1, kp)  # stream 2: (y2 - 1) mod kp = P[c] + 32*row
    m2 = inv_perm[u % NCOLS] * r + u // NCOLS
    m_flat = torch.where(stream == 0, m01,
                         torch.where(stream == 1, kp + 2 * m01, kp + 2 * m2 + 1))
    ok = (dpos < d) & ~((stream < 2) & (dpos < f[:, None]))
    rank = torch.gather(rank_incl, 1, torch.clamp(m_flat, 0, NCB - 1))
    j0 = torch.remainder(rank - 1 - r0, n_valid)
    return torch.where(ok, j0, NCB), n_valid[:, 0]


def codeword_d_fill_grouped_dev(llr_pad, start, e_eff, cls, k3, f3, rv, k_max: int,
                                rep: int, folds: int | None = None):
    """De-rate-match one TTI's whole codeword.

    llr_pad: (G_MAX + NCB_MAX,) zero-padded codeword LLRs.
    start/e_eff: (B_CB,) int64 per-codeblock codeword offsets / lengths
    (0 = unused slot).  cls: (B_CB,) int64 variant index in [0, 3).
    k3/f3: (3,) int64 variant size / filler count.  rv: 0-d integer tensor.
    rep: static bound on the repetition folds ceil(e / n_valid); folds: the
    number of folds this codeword needs where the host knows it (the
    reference's rolled loop stops there too), else `rep` are taken.
    Returns (B_CB, 3, k_max+4) accumulated d-stream LLRs: position p holds
    the sum of every transmitted bit that maps to it (the HARQ `+=` of the
    rate-matching receiver); <NULL>, filler and beyond-K positions are 0."""
    NCB = ncb_max(k_max)
    b_cb = start.shape[0]
    j0_3, nv3 = _j0_variant_dev(k3, f3, rv, k_max)
    nv = nv3[cls][:, None]  # (B_CB, 1)

    # fold the codeword onto the circular positions of each codeblock:
    # acc[c, m] = sum_t llr[start_c + m + t*nv_c], masked to m + t*nv_c < e_c.
    # A fold that starts past the buffer is masked out whole, so its index
    # is clamped into range rather than read.
    marange = torch.arange(NCB, device=llr_pad.device)[None, :]
    last = llr_pad.shape[0] - 1
    acc = llr_pad.new_zeros((b_cb, NCB))
    for t in range(rep if folds is None else min(folds, rep)):
        pos = marange + t * nv
        seg = llr_pad[torch.clamp(start[:, None] + pos, max=last)]
        acc = acc + torch.where(pos < e_eff[:, None], seg, 0.0)
    acc = torch.cat([acc, acc.new_zeros((b_cb, 1))], dim=1)  # dump slot NCB

    fill = torch.gather(acc, 1, j0_3[cls])
    fill = torch.where((e_eff > 0)[:, None], fill, 0.0)
    return fill.reshape(b_cb, 3, k_max + 4)


def qpp_dev(cb_k, f1, f2, k_max: int):
    """QPP interleaver and its inverse on the device:
    per[i] = (f1·i + f2·i²) mod k, identity beyond k (as `turbo_decode_dyn`
    expects).  cb_k/f1/f2: (B,) int64; a size below 1 (an unused variant)
    counts as 1.  Returns (per, inv), each (B, k_max) int64."""
    bsz = cb_k.shape[0]
    i = torch.arange(k_max, device=cb_k.device)[None, :]
    k = torch.clamp(cb_k, min=1)[:, None]
    # (f1·i + f2·i²) mod k == (i · ((f1 + f2·i) mod k)) mod k
    t = (f1[:, None] + (f2[:, None] * i) % k) % k
    per = torch.where(i < k, (i * t) % k, i)
    # rows are permutations, so the scatter writes every slot exactly once
    inv = torch.empty_like(per).scatter_(1, per, i.expand(bsz, k_max))
    return per, inv


def j0_variant_np(k: int, f: int, rv: int, k_max: int):
    """`_j0_variant_dev` of one layout on the host: the first-fold index
    table (3*(k_max+4),) int32 and n_valid, in plain numpy.

    The table depends only on (k, f, rv), so the windowed pipelines build it
    once per layout class ever seen and keep it on the device."""
    dflat = 3 * (k_max + 4)
    NCB = ncb_max(k_max)
    perm = np.asarray(RM_PERM_TC, np.int64)
    inv_perm = np.empty(NCOLS, np.int64)
    inv_perm[perm] = np.arange(NCOLS)

    d = k + 4
    r = (d + NCOLS - 1) // NCOLS
    kp = NCOLS * r
    nd = kp - d
    ncb = 3 * kp
    m = np.arange(NCB, dtype=np.int64)
    ca = np.clip(m // r, 0, NCOLS - 1)
    ya = (m % r) * NCOLS + perm[ca]
    j = m - kp
    i1 = np.maximum(j // 2, 0)
    cb = np.clip(i1 // r, 0, NCOLS - 1)
    yb1 = (i1 % r) * NCOLS + perm[cb]
    yb2 = (perm[cb] + NCOLS * (i1 % r) + 1) % kp
    is_even = (j % 2) == 0
    stream = np.where(m < kp, 0, np.where(is_even, 1, 2))
    y = np.where(m < kp, ya, np.where(is_even, yb1, yb2))
    dpos = y - nd
    valid = (y >= nd) & (m < ncb) & ~((stream < 2) & (dpos < f))
    rank_incl = np.cumsum(valid.astype(np.int64))

    n_valid = max(3 * d - 2 * f, 1)
    k0 = r * (24 * rv + 2)
    r0 = rank_incl[k0 - 1]

    p = np.arange(dflat, dtype=np.int64)
    stream_p = p // (k_max + 4)
    dpos_p = p % (k_max + 4)
    yp = dpos_p + nd
    m01 = inv_perm[yp % NCOLS] * r + yp // NCOLS
    u = (yp + kp - 1) % kp
    m2 = inv_perm[u % NCOLS] * r + u // NCOLS
    m_flat = np.where(stream_p == 0, m01,
                      np.where(stream_p == 1, kp + 2 * m01, kp + 2 * m2 + 1))
    ok = (dpos_p < d) & ~((stream_p < 2) & (dpos_p < f))
    j0 = (rank_incl[np.clip(m_flat, 0, NCB - 1)] - 1 - r0) % n_valid
    return np.where(ok, j0, NCB).astype(np.int32), int(n_valid)


def qpp_np(k: int, k_max: int):
    """The QPP permutation of size k and its inverse on the host, identity
    beyond k: two (k_max,) int32 arrays (the windowed pipelines keep one
    pair per codeblock size)."""
    per = np.arange(k_max, dtype=np.int32)
    inv = np.arange(k_max, dtype=np.int32)
    p = qpp_interleaver_np(k).astype(np.int32)
    per[:k] = p
    inv[p] = np.arange(k, dtype=np.int32)
    return per, inv


def tx_table_np(k: int, f: int, rv: int, k_max: int):
    """The transmit direction of `j0_variant_np` for one layout class:
    tx[j] is the flat d-stream index (stream * (k_max+4) + position) of the
    j-th transmitted bit, j in [0, n_valid) — the table inverted, position
    → rank becoming rank → position.  Returns (tx (n_valid,) int32,
    n_valid); repetition past n_valid wraps as j mod n_valid."""
    j0, n_valid = j0_variant_np(k, f, rv, k_max)
    dflat = 3 * (k_max + 4)
    d = k + 4
    tx = np.zeros(n_valid, np.int32)
    p = np.arange(dflat, dtype=np.int64)
    stream = p // (k_max + 4)
    dpos = p % (k_max + 4)
    ok = (dpos < d) & ~((stream < 2) & (dpos < f))
    sel = ok & (j0 < ncb_max(k_max))
    tx[j0[sel]] = p[sel].astype(np.int32)
    return tx, n_valid


def tb_reassembly_gather_dev(cb_k, cb_f, cb_valid, crc_is_b, tbs, k_max: int, tbs_max: int):
    """Transport-block gather indices on the device of cb_k: the
    concatenation of the codeblocks' bits, inverted.

    cb_k/cb_f: (B,) integer codeblock sizes and filler counts; cb_valid,
    crc_is_b: (B,) bool; tbs: an integer or 0-d tensor.  Codeblock i gives
    bits [f_i, k_i - 24·crc_is_b_i); the last 24 bits of the concatenation
    are the TB CRC.  Returns (tb_idx (tbs_max,) int64 — a left-padded
    gather into the flat (B*k_max,) decoded bits, the dump index B*k_max at
    the pad positions —, crc_idx (24,) int64 — the received CRC24A bits)."""
    dev = cb_k.device
    bsz = cb_k.shape[0]
    cb_k, cb_f = _as_int64(cb_k, dev), _as_int64(cb_f, dev)
    tbs = _as_int64(tbs, dev)
    nbits = torch.where(cb_valid, cb_k - cb_f - 24 * crc_is_b.to(torch.int64), 0)
    bounds = torch.cumsum(nbits, dim=0)
    start = torch.cat([bounds.new_zeros(1), bounds[:-1]])

    def src_of(u):
        cb = _segment_of(u, bounds)
        local = u - start[cb] + cb_f[cb]
        return cb * k_max + torch.clamp(local, 0, k_max - 1)

    u = torch.arange(tbs_max, device=dev) - (tbs_max - tbs)
    tb_idx = torch.where(u >= 0, src_of(torch.clamp(u, min=0)), bsz * k_max)
    crc_idx = src_of(tbs + torch.arange(24, device=dev))
    return tb_idx, crc_idx
