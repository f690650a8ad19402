"""Dynamic-K turbo decoding: codeblocks of any of the 188 LTE sizes
K <= K_max decode in one batch with one set of shapes.

Counterpart of `srsran_tpu/phy/fec/turbo_dyn.py`.  The codeblock size is
data:

* LLRs live in (B, 3, K_max+4) buffers; positions >= K are zeroed, so every
  trellis step beyond K is an erasure and alpha/beta below K are untouched.
* The exact tail state (beta at position K) is injected mid-pass: the lane
  whose window holds position K swaps its backward carry for the
  tail-derived beta there (the MAP kernel's dynamic-K mode, its `k_vec` input).
* The QPP interleaver and its inverse are inputs, (B, K_max) per-row gather
  indices, identity beyond K — given row by row, as a table of the batch's
  distinct sizes with a class index per row (`class_perms`), or as three
  layouts per transport block of a window (`perm_groups`).
* CRC early stop uses the leading-zeros invariance of CRCs with zero
  initial value: each row's bits are rolled to the tail of the K_max buffer
  and multiplied with one fixed (K_max, 48) CRC24A|CRC24B matrix.

The early stop is `turbo.turbo_decode`'s loop (`turbo._run`), with one
`done.all()` read per iteration, spanned and counted.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..common import LTE_CRC24A, LTE_CRC24B
from ..crc import crc_matrix_np
from .turbo import _beta_tail, _Loop, _run, dstream_tails, map_pass


def map_decoder_dyn(lx, lz, beta_k, k_vec, k_max: int) -> torch.Tensor:
    """One constituent max-log-MAP pass over dynamic-size codeblocks.

    lx, lz: (B, K_max) systematic+apriori / parity LLRs, zero beyond each
    codeblock's true size.  beta_k: (B, 8) exact beta at position K (from
    the tail bits).  k_vec: (B,) integer true sizes.
    Returns posteriors (B, K_max) float32, garbage beyond K (callers mask).
    On CUDA tensors this is one launch of the Hopper kernel in its
    dynamic-K mode, which finds the window that holds position K_i from
    k_vec itself; on CPU tensors it runs `turbo.map_pass_plain`."""
    return map_pass(lx, lz, beta_k, k_max, k_vec)


def roll_to_tail(bits: torch.Tensor, k_vec: torch.Tensor) -> torch.Tensor:
    """Right-align each row's first K_i entries in the (B, K_max) buffer,
    zeros before them (entries beyond K_i are dropped)."""
    k_max = bits.shape[1]
    src = torch.arange(k_max, device=bits.device)[None, :] + (k_vec[:, None] - k_max)
    return torch.where(src >= 0, torch.gather(bits, 1, src.clamp(min=0)), 0)


def crc_ok_ab(bits: torch.Tensor, k_vec, crc_table, crc_is_b) -> torch.Tensor:
    """Per-row CRC verdict (B,) bool of {0,1} bits (B, K_max), zero beyond
    K_i, against the fixed (K_max, 48) CRC24A|CRC24B matrix; crc_is_b picks
    the polynomial per row."""
    acc = torch.matmul(roll_to_tail(bits, k_vec).to(torch.float32), crc_table)
    zero = (acc.to(torch.int32) & 1) == 0
    return torch.where(crc_is_b, zero[:, 24:].all(dim=-1), zero[:, :24].all(dim=-1))


class _DynLoop(_Loop):
    """`turbo_decode_dyn`'s inputs, masked beyond each K_i, its state and
    its iteration, with per-row interleaves; `it_vec` keeps the iteration
    at which each row's CRC first passed."""

    def __init__(self, d_llr, k_vec, valid, k_max: int, perms, crc_table, crc_is_b):
        self.k, self.crc_table, self.crc_is_b = k_max, crc_table, crc_is_b
        self.start(d_llr, k_vec, valid, perms)

    def start(self, d_llr, k_vec, valid, perms):
        b, k_max, dev = d_llr.shape[0], self.k, d_llr.device
        per, inv, perm_groups, class_perms = perms
        self.k_vec = k_vec.to(torch.int64)
        if perm_groups is not None:
            per3, inv3, cls = perm_groups
            cls = cls.to(torch.int64)
            w_idx = torch.arange(cls.shape[0], device=cls.device)[:, None]
            per, inv = (t[w_idx, cls].reshape(b, k_max).to(torch.int64) for t in (per3, inv3))
        elif class_perms is not None:
            per_c, inv_c, cls = class_perms
            per, inv = per_c[cls], inv_c[cls]
        self.per, self.inv = per, inv
        self.in_mask = in_mask = torch.arange(k_max, device=dev)[None, :] < self.k_vec[:, None]
        self.sys, self.p1, self.p2 = (torch.where(in_mask, d_llr[:, i, :k_max], 0.0)
                                      for i in range(3))
        tail_cols = (self.k_vec[:, None, None] + torch.arange(4, device=dev)).expand(b, 3, 4)
        lx1_t, lz1_t, lx2_t, lz2_t = dstream_tails(torch.gather(d_llr, 2, tail_cols))
        self.beta1 = _beta_tail(lx1_t, lz1_t)  # (B, 8)
        self.beta2 = _beta_tail(lx2_t, lz2_t)
        self.sys_int = torch.where(in_mask, torch.gather(self.sys, 1, per), 0.0)
        self.k_i32 = self.k_vec.to(torch.int32)  # the kernel's k_vec
        self.ext2 = torch.zeros((b, k_max), dtype=torch.float32, device=dev)
        self.post = torch.zeros_like(self.ext2)
        self.done = ~valid
        self.it_vec = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.n_it = 0

    def step(self):
        """One iteration: two interleaves (natural→interleaved of ext1,
        interleaved→natural of ext2); the posterior for output and early
        stop is the natural-order sum sys + ext1 + ext2."""
        k_max, in_mask, done = self.k, self.in_mask, self.done
        x1 = self.sys + self.ext2
        ext1 = torch.where(in_mask, map_decoder_dyn(x1, self.p1, self.beta1, self.k_i32, k_max)
                           - x1, 0.0)
        in2 = self.sys_int + torch.gather(ext1, 1, self.per)
        ext2_int = map_decoder_dyn(in2, self.p2, self.beta2, self.k_i32, k_max) - in2
        new_ext2 = torch.where(in_mask, torch.gather(ext2_int, 1, self.inv), 0.0)
        # converged rows stay frozen
        self.ext2 = torch.where(done[:, None], self.ext2, new_ext2)
        self.post = torch.where(done[:, None], self.post, self.sys + ext1 + new_ext2)
        if self.crc_table is None:
            passed = torch.zeros_like(done)
        else:
            passed = crc_ok_ab((in_mask & (self.post > 0)).to(torch.uint8), self.k_vec,
                               self.crc_table, self.crc_is_b)
        new_done = done | passed
        self.n_it += 1
        self.it_vec = torch.where(new_done & ~done, self.n_it, self.it_vec)
        self.done = new_done


def turbo_decode_dyn(d_llr, k_vec, per, inv, valid, k_max: int, max_iterations: int = 5,
                     crc_table=None, crc_is_b=None, perm_groups=None, class_perms=None):
    """Decode a batch of dynamic-size codeblocks.

    d_llr: (B, 3, K_max+4) d-stream LLRs — each codeblock's data in columns
    [0, K_i), its 4 tail columns at [K_i, K_i+4), zeros elsewhere.
    k_vec: (B,) integer true sizes.  per/inv: (B, K_max) int64 QPP
    permutation and inverse, identity beyond K_i.  valid: (B,) bool —
    padded slots count as already done.
    crc_table: optional (K_max, 48) float32, columns [:24] the CRC24A
    matrix and [24:] CRC24B (`crc_table_ab`); crc_is_b: (B,) bool selects
    the polynomial that gates a row's early stop.
    perm_groups: optional (per3 (W, 3, K_max), inv3 (W, 3, K_max), cls (W, B_CB))
    in place of per/inv, for a window of W transport blocks of B_CB codeblock
    slots each (B = W·B_CB) with at most 3 codeblock layouts a block: row
    (w, b) takes `per3[w, cls[w, b]]`.  The tables are resolved to per-row
    indices once, so the bits, posteriors and n_iters equal those of the
    call with these per/inv.
    class_perms: optional (perC (NCLS, K_max), invC (NCLS, K_max), cls (B,)),
    all int64, in place of per/inv: every row takes one of NCLS permutation
    tables shared by the whole batch, so `perC[cls]` is the per-row index and
    each interleave stays one gather.
    Returns (bits (B, K_max) uint8, zero beyond K; posteriors (B, K_max);
    n_iters (B,) int32 — the iteration at which each row's CRC first
    passed, or the loop's iteration count if it never did).

    The loop is `turbo._run`'s, spans and counters included."""
    loop = _DynLoop(d_llr, k_vec, valid, k_max, (per, inv, perm_groups, class_perms),
                    crc_table, crc_is_b)
    n_it = _run(loop, max_iterations)
    it_vec = torch.where(loop.done, loop.it_vec, n_it)  # never converged: the loop count
    return (loop.in_mask & (loop.post > 0)).to(torch.uint8), loop.post, it_vec


@lru_cache(maxsize=64)
def crc_table_ab(k_max: int) -> np.ndarray:
    """Fixed (K_max, 48) float32 CRC24A|CRC24B matrix for dynamic-K checks."""
    a = crc_matrix_np(LTE_CRC24A, k_max).astype(np.float32)
    bb = crc_matrix_np(LTE_CRC24B, k_max).astype(np.float32)
    return np.concatenate([a, bb], axis=1)
