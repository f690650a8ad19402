"""LTE turbo decoder: windowed max-log-MAP with CRC early stop.

Counterpart of the decoder in `srsran_tpu/phy/fec/turbo.py`:

* 8-state RSC pair (feedback 1+D^2+D^3, forward 1+D+D^3), QPP interleaver
  (`cbsegm.qpp_interleaver_np`), 12 tail bits (TS 36.212 §5.1.3.2).
* Each constituent pass splits a codeblock into `nw` windows of `lw`
  positions; (codeblock × window) pairs are lanes.  Window boundaries come
  from T-step training (zero start); window 0 takes the exact state-0
  start and the last window the exact tail beta.
* `map_decoder` is one constituent pass, (B, K) LLRs to (B, K) posteriors:
  on a CUDA tensor it launches the Hopper kernel (`turbo_cuda.map_pass`),
  which reads the LLRs as they are; on a CPU tensor it runs the kernel's
  plain version, `map_pass_plain`: the lane layout (`map_window_lanes`),
  the reference's scan recursion over it (`map_windows_plain`), and back
  (`unlane`).
* Iterations stop once every codeblock passes its CRC; converged
  codeblocks are frozen (one host read of ``done.all()`` per iteration).
  The exact tail betas are computed once a call.  `_run`, the loop of
  this decoder and `turbo_dyn`'s, marks each read (`turbo.stop_read`,
  counted as `host_reads`) and each iteration (`turbo.iter`) with the
  spans of `runtime.trace`, and counts the iterations (`turbo_iterations`)
  and those a CUDA graph replayed (`turbo_graph_replays`).  A caller of fixed shape asks for CUDA graphs
  (`graphed=True`): one launch for the set-up and one an iteration, of the
  eager loop's kernels.
* `turbo_encode_np` is the reference's host encoder (numpy), for stimuli;
  `turbo_encode_device` is the batched encoder on the device, a closed-form
  GF(2) polynomial division with no sequential step, and
  `turbo_encode_device_dyn` the same for a batch of mixed K.

LLRs are float32 with **positive LLR = bit 1**.  All codeblocks in a batch
share one K.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ...runtime.trace import count, span
from . import turbo_cuda
from .cbsegm import qpp_interleaver_np

NEG_INF = np.float32(-1e30)
RATE = 3
TOTAL_TAIL = 12
TRAIN = 32  # boundary training length for windows shorter than 96


# --- trellis tables ---------------------------------------------------------


@lru_cache(maxsize=1)
def _trellis():
    """8-state RSC tables.

    state s encodes (reg0 + 2*reg1 + 4*reg2); for input bit u:
      in  = u ^ reg1 ^ reg2          (value shifted in)
      out = reg2 ^ reg0 ^ in         (parity)
      s'  = in + 2*reg0 + 4*reg1
    Returns dict with next_state (8,2), parity (8,2), prev_state (8,2),
    prev_u (8,2), prev_parity (8,2), tail_bit (8), tail_next (8),
    tail_parity (8).
    """
    next_state = np.zeros((8, 2), np.int32)
    parity = np.zeros((8, 2), np.int32)
    for s in range(8):
        r0, r1, r2 = s & 1, (s >> 1) & 1, (s >> 2) & 1
        for u in (0, 1):
            inp = u ^ r1 ^ r2
            next_state[s, u] = inp + 2 * r0 + 4 * r1
            parity[s, u] = r2 ^ r0 ^ inp
    prev_state = np.zeros((8, 2), np.int32)
    prev_u = np.zeros((8, 2), np.int32)
    prev_parity = np.zeros((8, 2), np.int32)
    cnt = np.zeros(8, np.int32)
    for s in range(8):
        for u in (0, 1):
            ns = next_state[s, u]
            prev_state[ns, cnt[ns]] = s
            prev_u[ns, cnt[ns]] = u
            prev_parity[ns, cnt[ns]] = parity[s, u]
            cnt[ns] += 1
    # tail transitions: forced in=0 → systematic bit = r1^r2
    tail_bit = np.zeros(8, np.int32)
    tail_next = np.zeros(8, np.int32)
    tail_parity = np.zeros(8, np.int32)
    for s in range(8):
        r0, r1, r2 = s & 1, (s >> 1) & 1, (s >> 2) & 1
        tail_bit[s] = r1 ^ r2
        tail_parity[s] = r2 ^ r0
        tail_next[s] = 2 * r0 + 4 * r1
    return dict(
        next_state=next_state,
        parity=parity,
        prev_state=prev_state,
        prev_u=prev_u,
        prev_parity=prev_parity,
        tail_bit=tail_bit,
        tail_next=tail_next,
        tail_parity=tail_parity,
    )


# --- encoder (host, for stimuli) ---------------------------------------------


def _rsc_encode_np(bits: np.ndarray):
    """Parity stream of one RSC encoder; returns (parity, final_regs).

    Vectorized over the whole block: the feedback register sequence
    a = (1/g0)·u over GF(2) with g0 = 1+D²+D³ has an impulse response of
    period 7 ([1,0,1,1,1,0,0]), so a[i] reduces to four per-phase
    prefix-XORs Q[i]^Q[i-2]^Q[i-3]^Q[i-4] where Q[j] is the running XOR of
    u over the j mod 7 phase class.  Parity is then g1(D)·a with
    g1 = 1+D+D³."""
    u = np.asarray(bits, np.uint8)
    k = len(u)
    if k == 0:
        return np.zeros(0, np.uint8), 0
    q = np.empty(k, np.uint8)
    for p in range(7):
        q[p::7] = np.bitwise_xor.accumulate(u[p::7])
    a = q.copy()
    for c in (2, 3, 4):
        a[c:] ^= q[: k - c]
    z = a.copy()
    z[1:] ^= a[:-1]
    z[3:] ^= a[:-3]
    # register (a[i-1], a[i-2], a[i-3]) in the _trellis() state encoding
    s = int(a[-3] if k >= 3 else 0) << 2 | int(a[-2] if k >= 2 else 0) << 1 | int(a[-1])
    return z, s


def _rsc_tail_np(s: int):
    """3 tail steps: returns (sys_bits[3], parity_bits[3])."""
    t = _trellis()
    xs, zs = [], []
    for _ in range(3):
        xs.append(int(t["tail_bit"][s]))
        zs.append(int(t["tail_parity"][s]))
        s = int(t["tail_next"][s])
    assert s == 0
    return np.array(xs, np.uint8), np.array(zs, np.uint8)


def turbo_encode_np(bits: np.ndarray) -> np.ndarray:
    """Encode one codeblock → d-streams array (3, K+4), TS 36.212 §5.1.3.2.

    Rows are d^(0), d^(1), d^(2); the 12 tail bits are distributed over the
    last 4 columns as the spec orders them."""
    k = len(bits)
    per = qpp_interleaver_np(k)
    p1, s1 = _rsc_encode_np(bits)
    p2, s2 = _rsc_encode_np(bits[per])
    x1, z1 = _rsc_tail_np(s1)  # encoder 1 tail: x_K..x_K+2, z_K..z_K+2
    x2, z2 = _rsc_tail_np(s2)
    d = np.zeros((3, k + 4), np.uint8)
    d[0, :k], d[1, :k], d[2, :k] = bits, p1, p2
    d[0, k:] = [x1[0], z1[1], x2[0], z2[1]]
    d[1, k:] = [z1[0], x1[2], z2[0], x2[2]]
    d[2, k:] = [x1[1], z1[2], x2[1], z2[2]]
    return d


# --- device encoder -----------------------------------------------------------


def _rsc_parity_closed_form(u: torch.Tensor):
    """RSC parity of u (..., K) {0,1} with no sequential step.

    The recursion is linear over GF(2): a(D)·(1+D²+D³) = u(D), where a_i is
    the bit shifted into the register, and the parity is p(D) =
    a(D)·(1+D+D³).  The feedback polynomial is primitive, so
    (1+D²+D³)·(1+D²+D³+D⁴) = 1+D⁷ and a = u·h / (1+D⁷) with
    h = 1+D²+D³+D⁴: a FIR filter, then a_i = v_i ⊕ a_{i-7} — seven
    independent prefix-XORs, one int32 cumulative sum (mod 2) over a
    (K/7, 7) reshape.

    Returns (parity (..., K) uint8, a (..., K) int32); the register after
    step K is (a_{K-1}, a_{K-2}, a_{K-3})."""
    k = u.shape[-1]
    ui = u.to(torch.int32)

    def lag(x, n):
        return torch.nn.functional.pad(x, (n, 0))[..., :k]

    v = ui ^ lag(ui, 2) ^ lag(ui, 3) ^ lag(ui, 4)
    m = -(-k // 7)
    vp = torch.nn.functional.pad(v, (0, 7 * m - k))
    a = torch.cumsum(vp.reshape(tuple(v.shape[:-1]) + (m, 7)), dim=-2, dtype=torch.int32) & 1
    a = a.reshape(tuple(v.shape[:-1]) + (7 * m,))[..., :k]
    p = (a ^ lag(a, 1) ^ lag(a, 3)).to(torch.uint8)
    return p, a


def _tail_tables_int():
    t = _trellis()
    return tuple(t[name].astype(np.int64) for name in ("tail_bit", "tail_parity", "tail_next"))


def turbo_encode_device(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Batched turbo encoder on the device: bits (B, K) uint8 → d-streams
    (B, 3, K+4) uint8, the layout and the bits of `turbo_encode_np`."""
    if bits.shape[-1] != k:
        raise ValueError(f"bits have {bits.shape[-1]} columns, expected K={k}")
    b = bits.shape[0]
    bits = bits.to(torch.uint8)
    per, _inv = table(_perm_tables, k, device=bits.device, dtype=torch.int64)
    tb_bit, tb_par, tb_nxt = table(_tail_tables_int, device=bits.device)
    p1, a1 = _rsc_parity_closed_form(bits)
    p2, a2 = _rsc_parity_closed_form(bits[:, per])

    def tails(a):
        s = (a[:, k - 1] + 2 * a[:, k - 2] + 4 * a[:, k - 3]).to(torch.int64)
        xs, zs = [], []
        for _ in range(3):
            xs.append(tb_bit[s].to(torch.uint8))
            zs.append(tb_par[s].to(torch.uint8))
            s = tb_nxt[s]
        return xs, zs

    x1, z1 = tails(a1)
    x2, z2 = tails(a2)
    d = torch.empty((b, 3, k + 4), dtype=torch.uint8, device=bits.device)
    d[:, 0, :k], d[:, 1, :k], d[:, 2, :k] = bits, p1, p2
    # TS 36.212 tail mapping (as `turbo_encode_np`)
    d[:, 0, k:] = torch.stack([x1[0], z1[1], x2[0], z2[1]], dim=1)
    d[:, 1, k:] = torch.stack([z1[0], x1[2], z2[0], x2[2]], dim=1)
    d[:, 2, k:] = torch.stack([x1[1], z1[2], x2[1], z2[2]], dim=1)
    return d


def turbo_encode_device_dyn(bits: torch.Tensor, k_vec: torch.Tensor, perm_cls) -> torch.Tensor:
    """Dynamic-K batched encoder: bits (N, K_max) uint8, zero beyond each
    codeblock's K; k_vec (N,) integer; perm_cls = (perC (NCLS, K_max) int64
    QPP tables, identity beyond K, cls (N,) integer class of each row).

    The closed form of `turbo_encode_device` is elementwise, so one call
    serves any mix of sizes: each row interleaves through its class's table
    (`perC[cls]`, one gather), the tail registers are read at K-1, K-2, K-3
    of that row, and the four tail columns go to [K, K+4).  Returns the
    d-streams (N, 3, K_max+4) uint8, zero beyond each row's tail."""
    n, k_max = bits.shape
    per_c, cls = perm_cls
    bits = bits.to(torch.uint8)
    k_vec = k_vec.to(torch.int64)
    tb_bit, tb_par, tb_nxt = table(_tail_tables_int, device=bits.device)
    p1, a1 = _rsc_parity_closed_form(bits)
    p2, a2 = _rsc_parity_closed_form(torch.gather(bits, 1, per_c[cls.to(torch.int64)]))
    back = torch.arange(1, 4, device=bits.device)[None, :]

    def tails(a):
        # registers after K steps: (r0, r1, r2) = (a_{K-1}, a_{K-2}, a_{K-3})
        regs = torch.gather(a, 1, (k_vec[:, None] - back).clamp(0, k_max - 1)).to(torch.int64)
        s = regs[:, 0] + 2 * regs[:, 1] + 4 * regs[:, 2]
        xs, zs = [], []
        for _ in range(3):
            xs.append(tb_bit[s].to(torch.uint8))
            zs.append(tb_par[s].to(torch.uint8))
            s = tb_nxt[s]
        return xs, zs

    x1, z1 = tails(a1)
    x2, z2 = tails(a2)
    # TS 36.212 tail mapping (as `turbo_encode_np`), at column K of each row
    tail = torch.stack([torch.stack([x1[0], z1[1], x2[0], z2[1]], dim=1),
                        torch.stack([z1[0], x1[2], z2[0], x2[2]], dim=1),
                        torch.stack([x1[1], z1[2], x2[1], z2[2]], dim=1)], dim=1)  # (N, 3, 4)
    in_k = (torch.arange(k_max, device=bits.device)[None, :] < k_vec[:, None])[:, None, :]
    d = torch.where(in_k, torch.stack([bits, p1, p2], dim=1), 0).to(torch.uint8)
    d = torch.cat([d, d.new_zeros((n, 3, 4))], dim=2)
    cols = (k_vec[:, None, None] + torch.arange(4, device=bits.device)).expand(n, 3, 4)
    return d.scatter_(2, cols, tail)


def _window_layout(k: int) -> tuple[int, int]:
    """(nof_windows, window_len) with window_len dividing K: for K > 2048
    the divisor in [64, 160] nearest 96 (even lengths first), else the
    widest-lanes layout on a base of 8/16/32."""
    if k > 2048:
        best = None
        for lw in range(64, 161, 2):
            if k % lw == 0 and (best is None or abs(lw - 96) < abs(best - 96)):
                best = lw
        if best is None:
            for lw in range(65, 161, 2):
                if k % lw == 0 and (best is None or abs(lw - 96) < abs(best - 96)):
                    best = lw
        if best is not None:
            return k // best, best
        base = 64
    elif k <= 512:
        base = 8
    elif k <= 1024:
        base = 16
    else:
        base = 32
    n_base = k // base
    m = 1
    for cand in range(min(64 // base, n_base), 0, -1):
        if n_base % cand == 0:
            m = cand
            break
    lw = base * m
    return k // lw, lw


def _train_len(lw: int) -> int:
    """Boundary training steps T: 24 for windows of 96 or more, else 32,
    never more than the window."""
    return min(24 if lw >= 96 else TRAIN, lw)


def pass_layout(k: int) -> tuple[int, int, int]:
    """(nw, lw, T) of a pass over codeblocks of size k."""
    nw, lw = _window_layout(k)
    return nw, lw, _train_len(lw)


def _tail_tables():
    t = _trellis()
    return ((1.0 - 2.0 * t["tail_bit"]).astype(np.float32),
            (1.0 - 2.0 * t["tail_parity"]).astype(np.float32),
            t["tail_next"].astype(np.int64))


def _beta_tail(lx_t: torch.Tensor, lz_t: torch.Tensor) -> torch.Tensor:
    """Exact beta at position K from the 3 tail steps.

    lx_t, lz_t: (B, 3) tail systematic/parity LLRs (decoder order).
    Returns (B, 8) beta_K."""
    sb, sp, nxt = table(_tail_tables, device=lx_t.device)
    beta = torch.full(lx_t.shape[:-1] + (8,), float(NEG_INF), device=lx_t.device)
    beta[..., 0] = 0.0
    for step in (2, 1, 0):
        x, z = 0.5 * lx_t[..., step : step + 1], 0.5 * lz_t[..., step : step + 1]
        # metric of hypothesis b is (2b-1)*L/2 (LLR > 0 ⇒ bit 1)
        beta = -(sb * x + sp * z) + beta[..., nxt]
    return beta


# --- windowed max-log-MAP ----------------------------------------------------


def _step_tables():
    """Predecessor/successor states and ±1 branch signs, signs as (8, 1)
    columns broadcasting over lanes."""
    t = _trellis()

    def sign(v):
        return (2.0 * v - 1.0).astype(np.float32)[:, None]

    ps, ns = t["prev_state"].astype(np.int64), t["next_state"].astype(np.int64)
    spu, spp, sp = t["prev_u"], t["prev_parity"], t["parity"]
    return (ps[:, 0], ps[:, 1], sign(spu[:, 0]), sign(spu[:, 1]),
            sign(spp[:, 0]), sign(spp[:, 1]),
            ns[:, 0], ns[:, 1], sign(sp[:, 0]), sign(sp[:, 1]))


def map_windows_plain(ax_tr, az_tr, ax, az, bx_tr, bz_tr, a_mask, b_mask, b_known,
                      T: int, lw: int, kq: torch.Tensor | None = None) -> torch.Tensor:
    """The windowed MAP pass over all lanes in plain torch — the scan
    recursion of the reference's `map_decoder`, on the kernel's inputs.

    ax_tr/az_tr: (T, bn) the T half-scaled positions before each window;
    bx_tr/bz_tr: (T, bn) the T positions after it; ax/az: (lw, bn) the
    window; a_mask/b_mask: (1, bn) 1.0 on window-0 / last-window lanes;
    b_known: (8, bn) exact beta_K for last-window lanes.
    kq: optional (1, bn) int32, the dynamic-K mode: where the backward
    carry is beta at local position q == kq (1..lw, 0 = never) it is
    replaced by b_known (the reference's mid-scan injection).
    Returns the posterior LLRs (lw, bn) float32."""
    ps0, ps1, spu0, spu1, spp0, spp1, ns0, ns1, sp0, sp1 = table(
        _step_tables, device=ax.device)
    bn = ax.shape[1]

    def alpha_step(a, xt, zt):
        return torch.maximum(a[ps0] + (spu0 * xt + spp0 * zt),
                             a[ps1] + (spu1 * xt + spp1 * zt))

    def beta_branches(b, xt, zt):
        return b[ns0] + (-xt + sp0 * zt), b[ns1] + (xt + sp1 * zt)

    a = torch.zeros((8, bn), dtype=torch.float32, device=ax.device)
    b = torch.zeros_like(a)
    for t in range(T):
        a = alpha_step(a, ax_tr[t], az_tr[t])
        b = torch.maximum(*beta_branches(b, bx_tr[T - 1 - t], bz_tr[T - 1 - t]))
    known = torch.full((8, 1), float(NEG_INF), device=ax.device)
    known[0] = 0.0  # exact state-0 start
    a = torch.where(a_mask > 0, known, a)
    b = torch.where(b_mask > 0, b_known, b)

    alphas = torch.empty((lw, 8, bn), dtype=torch.float32, device=ax.device)
    for j in range(lw):
        alphas[j] = a
        a = alpha_step(a, ax[j], az[j])
    out = torch.empty((lw, bn), dtype=torch.float32, device=ax.device)
    for j in range(lw - 1, -1, -1):
        if kq is not None:  # b is beta at position j + 1
            b = torch.where(kq == j + 1, b_known, b)
        b0, b1 = beta_branches(b, ax[j], az[j])
        out[j] = (torch.max(alphas[j] + b1, dim=0).values
                  - torch.max(alphas[j] + b0, dim=0).values)
        b = torch.maximum(b0, b1)
    return out


def _lane_masks(b: int, nw: int):
    """(1, bn) float32 masks of window-0 and last-window lanes; lane
    l = codeblock * nw + window."""
    lane_w = np.tile(np.arange(nw), b)
    return ((lane_w == 0).astype(np.float32)[None, :],
            (lane_w == nw - 1).astype(np.float32)[None, :])


def map_window_lanes(lx, lz, beta_k, k: int, layout: tuple[int, int, int] | None = None):
    """The lane layout of one constituent pass from (B, K) LLRs and the
    exact tail beta_K (B, 8): returns
    (ax_tr, az_tr, ax, az, bx_tr, bz_tr, a_mask, b_mask, b_known, T, lw)
    for `map_windows_plain` (see there for the shapes).  `layout` is
    (nw, lw, T) where it is not the one of `_window_layout(k)`."""
    nw, lw, T = layout or pass_layout(k)
    assert nw * lw == k and 0 <= T <= lw
    b = lx.shape[0]
    bn = b * nw

    def lanes(v, rows):  # (B, nw, rows) -> (rows, B*nw), lane fastest
        return v.permute(2, 0, 1).reshape(rows, bn).contiguous()

    def main(v):
        return lanes(v.reshape(b, nw, lw), lw)

    def before(v):  # positions w*lw-T .. w*lw-1, zeros before 0
        pad = torch.cat([v.new_zeros((b, T)), v], dim=-1)[:, :k]
        return lanes(pad.reshape(b, nw, lw)[:, :, :T], T)

    def after(v):  # positions (w+1)*lw .. (w+1)*lw+T-1, zeros past K
        pad = torch.cat([v, v.new_zeros((b, lw))], dim=-1)[:, lw:]
        return lanes(pad.reshape(b, nw, lw)[:, :, :T], T)

    x, z = 0.5 * lx, 0.5 * lz
    a_mask, b_mask = table(_lane_masks, b, nw, device=lx.device)
    b_known = beta_k.T[:, :, None].expand(8, b, nw).reshape(8, bn).contiguous()
    return (before(x), before(z), main(x), main(z), after(x), after(z),
            a_mask, b_mask, b_known, T, lw)


def unlane(llr: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """Posteriors (lw, B*nw) in lane layout → (B, K)."""
    lw = llr.shape[0]
    return llr.reshape(lw, b, k // lw).permute(1, 2, 0).reshape(b, k)


def _window_starts(b: int, nw: int, lw: int) -> np.ndarray:
    """(1, B*nw) int32 first position of every lane's window."""
    return np.tile(np.arange(nw, dtype=np.int32) * lw, b)[None, :]


def lane_kq(k_vec: torch.Tensor, k_max: int,
            layout: tuple[int, int, int] | None = None) -> torch.Tensor:
    """`map_windows_plain`'s `kq` input, (1, B*nw) int32: K_i - w*lw where
    that lies in [1, lw] (the lane whose window holds beta_K), else 0."""
    nw, lw, _ = layout or pass_layout(k_max)
    starts = table(_window_starts, k_vec.shape[0], nw, lw, device=k_vec.device)
    k_local = torch.repeat_interleave(k_vec.to(torch.int32), nw)[None, :] - starts
    return torch.where((k_local >= 1) & (k_local <= lw), k_local, 0).to(torch.int32)


def map_pass_plain(lx, lz, beta_k, k: int, k_vec: torch.Tensor | None = None,
                   layout: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The plain version of the Hopper kernel (`turbo_cuda.map_pass`): one
    constituent pass, (B, K) LLRs and beta_K (B, 8) → (B, K) posteriors,
    through the lane layout and the scan recursion.

    k_vec, when given, holds the (B,) true sizes K_i <= k and the
    dynamic-K mode runs: LLRs are zero beyond K_i, beta_k is beta at K_i
    and enters where the backward recursion passes K_i; posteriors beyond
    K_i are garbage."""
    *ins, b_mask, b_known, T, lw = map_window_lanes(lx, lz, beta_k, k, layout)
    kq = None
    if k_vec is not None:
        b_mask = torch.zeros_like(b_mask)  # kq == lw takes its place
        kq = lane_kq(k_vec, k, layout)
    return unlane(map_windows_plain(*ins, b_mask, b_known, T, lw, kq=kq), lx.shape[0], k)


def map_pass(lx, lz, beta_k, k: int, k_vec: torch.Tensor | None = None) -> torch.Tensor:
    """One constituent pass on the device the tensors lie on: the Hopper
    kernel for CUDA tensors (it launches or raises), `map_pass_plain` for
    CPU tensors."""
    if lx.device.type == "cpu":
        return map_pass_plain(lx, lz, beta_k, k, k_vec)
    if k_vec is not None:
        k_vec = k_vec.to(torch.int32)
    return turbo_cuda.map_pass(lx, lz, beta_k, *pass_layout(k), k_vec=k_vec)


def map_decoder(lx, lz, lx_tail, lz_tail, k: int) -> torch.Tensor:
    """One constituent max-log-MAP pass.

    lx: (B, K) systematic-plus-apriori LLRs; lz: (B, K) parity LLRs;
    lx_tail, lz_tail: (B, 3) this decoder's tail LLRs.
    Returns posterior LLRs (B, K) float32 (positive ⇒ bit 1).
    The exact tail beta_K is plain torch (`_beta_tail`); the pass itself is
    one launch of the Hopper kernel on CUDA tensors and `map_pass_plain` on
    CPU tensors."""
    return map_pass(lx, lz, _beta_tail(lx_tail, lz_tail), k)


# --- full iterative decoder ---------------------------------------------------


@lru_cache(maxsize=256)
def _perm_tables(k: int):
    per = qpp_interleaver_np(k)
    inv = np.empty_like(per)
    inv[per] = np.arange(k, dtype=per.dtype)
    return per, inv


def dstream_tails(d_tail: torch.Tensor):
    """Split d-stream tail LLRs (B, 3, 4) into per-decoder tail LLRs.

    Returns (lx1, lz1, lx2, lz2), each (B, 3), inverting the TS 36.212 tail
    distribution of the encoder."""
    d0, d1, d2 = d_tail[:, 0], d_tail[:, 1], d_tail[:, 2]
    lx1 = torch.stack([d0[:, 0], d2[:, 0], d1[:, 1]], dim=-1)  # x_K, x_K+1, x_K+2
    lz1 = torch.stack([d1[:, 0], d0[:, 1], d2[:, 1]], dim=-1)  # z_K, z_K+1, z_K+2
    lx2 = torch.stack([d0[:, 2], d2[:, 2], d1[:, 3]], dim=-1)
    lz2 = torch.stack([d1[:, 2], d0[:, 3], d2[:, 3]], dim=-1)
    return lx1, lz1, lx2, lz2


class _Loop:
    """The inputs and the state of one `turbo_decode`, and its iteration.

    `start` makes, from the d-stream LLRs, the inputs: the systematic LLRs
    `sys` and their interleaving `sys_int`, the parities `p1`, `p2` (B, K)
    and the exact tail betas `beta1`, `beta2` (B, 8), fixed for the call
    and so computed once; and the state `ext2`, `post` (B, K) and `done`
    (B,), cleared.  `step` runs one iteration on the state, in place."""

    def __init__(self, d_llr: torch.Tensor, k: int, per, inv, crc_table):
        self.k, self.per, self.inv, self.crc_table = k, per, inv, crc_table
        self.start(d_llr)

    def start(self, d_llr: torch.Tensor):
        b, k = d_llr.shape[0], self.k
        self.sys = d_llr[:, 0, :k]
        self.p1 = d_llr[:, 1, :k].contiguous()  # the kernel reads whole rows
        self.p2 = d_llr[:, 2, :k].contiguous()
        lx1_t, lz1_t, lx2_t, lz2_t = dstream_tails(d_llr[:, :, k:])
        self.sys_int = self.sys[:, self.per]
        self.beta1, self.beta2 = _beta_tail(lx1_t, lz1_t), _beta_tail(lx2_t, lz2_t)
        self.ext2 = torch.zeros((b, k), dtype=torch.float32, device=d_llr.device)
        self.post = torch.zeros_like(self.ext2)
        self.done = torch.zeros((b,), dtype=torch.bool, device=d_llr.device)

    def step(self):
        """One iteration, in place: two constituent passes, the extrinsic
        exchange through the QPP interleaver, the posterior, the CRC test."""
        k, per, inv = self.k, self.per, self.inv
        x1 = self.sys + self.ext2
        ext1 = map_pass(x1, self.p1, self.beta1, k) - x1
        in2 = self.sys_int + ext1[:, per]
        new_ext2 = (map_pass(in2, self.p2, self.beta2, k) - in2)[:, inv]
        # the APP in natural order is the extrinsic sum; converged
        # codeblocks stay frozen
        frozen = self.done[:, None]
        torch.where(frozen, self.ext2, new_ext2, out=self.ext2)
        torch.where(frozen, self.post, self.sys + ext1 + new_ext2, out=self.post)
        if self.crc_table is not None:
            acc = torch.matmul((self.post > 0).to(torch.float32), self.crc_table)
            self.done |= torch.all((acc.to(torch.int32) & 1) == 0, dim=-1)

    def iterate(self) -> bool:
        """Run one iteration; True where a CUDA graph replayed it."""
        self.step()
        return False

    def posteriors(self) -> torch.Tensor:
        return self.post


# CUDA graphs of the batched decode's loop kept per device, the least
# recently used dropped first, and the keys seen once (whose next call
# captures)
GRAPHS_PER_DEVICE = 4
SEEN_KEYS = 64
_GRAPHS: dict[torch.device, OrderedDict] = {}
_SEEN: OrderedDict = OrderedDict()
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def _on_capture_stream(dev: torch.device):
    """Run the block on the device's capture stream (a graph cannot be
    captured on the default one), after the current stream's work and
    before its next."""
    current = torch.cuda.current_stream(dev)
    side = _CAPTURE_STREAMS.get(dev)
    if side is None:
        side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        yield
    current.wait_stream(side)


def _captured(fn) -> torch.cuda.CUDAGraph:
    """`fn()` captured as a CUDA graph on the current stream: nothing runs;
    the tensors it makes are the graph's, rewritten by every replay."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin()
    fn()
    graph.capture_end()
    return graph


class _GraphedLoop(_Loop):
    """A `_Loop` for one key (device, B, K, CRC matrix) whose `start` and
    `step` are each captured once as a CUDA graph and replayed from then
    on: the same kernels in the same order on the same buffers, so the
    bits, posteriors and iteration counts are the eager loop's.

    `load` copies a call's LLRs into the buffer `d_llr` and replays
    `start` over it, whose outputs (the graph's own tensors) are the
    inputs and state that the graph of `step` reads and rewrites."""

    def __init__(self, d_llr: torch.Tensor, k: int, per, inv, crc_table):
        self.k, self.per, self.inv, self.crc_table = k, per, inv, crc_table
        self.d_llr = torch.empty(d_llr.shape, dtype=torch.float32, device=d_llr.device)
        self.graphs: list[torch.cuda.CUDAGraph] = []  # start's, then step's
        self.launches = None  # the MAP launches the graph of step holds, by shape
        table(_tail_tables, device=d_llr.device)  # on the device before a capture

    def load(self, d_llr: torch.Tensor):
        self.d_llr.copy_(d_llr)
        if not self.graphs:
            with _on_capture_stream(self.d_llr.device):
                self.graphs.append(_captured(lambda: self.start(self.d_llr)))
        self.graphs[0].replay()

    def iterate(self) -> bool:
        if len(self.graphs) == 1:
            # the first iteration runs for real on the capture stream, which
            # warms it (cuBLAS's workspace for it); capturing the same step
            # then runs nothing, so the state stays as that iteration left it
            with _on_capture_stream(self.d_llr.device):
                self.step()
                with turbo_cuda.uncounted() as self.launches:
                    self.graphs.append(_captured(self.step))
            return False
        self.graphs[1].replay()
        turbo_cuda.replayed(self.launches)
        return True

    def posteriors(self) -> torch.Tensor:
        return self.post.clone()  # the graph's tensor is the next call's


def _graphed_loop(d_llr: torch.Tensor, k: int, per, inv, crc_table) -> _GraphedLoop | None:
    """The graphed loop of this call's key with the call's LLRs loaded,
    made on the key's second call; None on its first, which runs eagerly,
    so that a shape decoded once is never captured."""
    dev = d_llr.device
    # the CRC matrix by identity: the loop holds it, so the id stays its own
    key = (d_llr.shape[0], k, None if crc_table is None else id(crc_table))
    graphs = _GRAPHS.setdefault(dev, OrderedDict())
    loop = graphs.get(key)
    if loop is not None:
        graphs.move_to_end(key)
    elif _SEEN.pop((dev, key), None) is None:
        _SEEN[(dev, key)] = True
        if len(_SEEN) > SEEN_KEYS:
            _SEEN.popitem(last=False)
        return None
    else:
        loop = graphs[key] = _GraphedLoop(d_llr, k, per, inv, crc_table)
        if len(graphs) > GRAPHS_PER_DEVICE:
            graphs.popitem(last=False)
    loop.load(d_llr)
    return loop


def turbo_decode(d_llr: torch.Tensor, k: int, max_iterations: int = 5,
                 crc_table: torch.Tensor | None = None, graphed: bool = False):
    """Iteratively decode a batch of codeblocks.

    d_llr: (B, 3, K+4) float32 LLRs in d-stream layout (positive ⇒ bit 1).
    crc_table: optional (K, 24) float32 CRC matrix over the whole K (its
    trailing CRC included); iterations stop once every codeblock passes.
    graphed: the caller decodes the same (B, K) call after call (a batched
    entry of fixed shape).  On a CUDA device the loop's set-up and its
    iteration are then captured as CUDA graphs on the second call with a
    key (device, B, K, crc_table) and replayed from then on
    (`_GraphedLoop`); elsewhere, and on a key's first call, the loop runs
    eagerly.
    Returns (bits (B, K) uint8, llr (B, K) float32, n_iterations int).
    """
    per, inv = table(_perm_tables, k, device=d_llr.device, dtype=torch.int64)
    loop = None
    if graphed and d_llr.device.type == "cuda":
        loop = _graphed_loop(d_llr, k, per, inv, crc_table)
    if loop is None:
        loop = _Loop(d_llr, k, per, inv, crc_table)
    n_it = _run(loop, max_iterations)
    return (loop.post > 0).to(torch.uint8), loop.posteriors(), n_it


def _run(loop: _Loop, max_iterations: int) -> int:
    """Run at most `max_iterations` iterations of `loop`, each after a read
    of `loop.done.all()` that stops it once every codeblock is done; return
    how many ran."""
    n_it = 0
    while n_it < max_iterations:
        with span("turbo.stop_read"):
            count("host_reads")
            stop = bool(loop.done.all())
        if stop:
            break
        with span("turbo.iter"):
            replayed = loop.iterate()
        count("turbo_iterations")
        if replayed:
            count("turbo_graph_replays")
        n_it += 1
    return n_it
