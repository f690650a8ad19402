"""Gold (pseudo-random) sequence, TS 36.211 §7.2 — host side.

Copy of the numpy generator in `srsran_tpu/phy/sequence.py`: length-31
Gold sequence, x1 seeded with 1, x2 with c_init, output after Nc = 1600
steps, 28 new bits per Python step.  Sequences are data: callers cache
them per (cell, rnti, subframe) and move them to the device once.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

NC = 1600
_STEP = 28  # bits generated per word step (tap span is 3 → 31-3=28 safe)
_MASK31 = (1 << 31) - 1


def _x1_word(s: int) -> int:
    # x1(n+31) = x1(n+3) ^ x1(n)
    return ((s >> 3) ^ s) & ((1 << _STEP) - 1)


def _x2_word(s: int) -> int:
    # x2(n+31) = x2(n+3) ^ x2(n+2) ^ x2(n+1) ^ x2(n)
    return ((s >> 3) ^ (s >> 2) ^ (s >> 1) ^ s) & ((1 << _STEP) - 1)


def _advance(state: int, nbits: int, word_fn) -> int:
    """Advance a 31-bit LFSR state by nbits (python ints, exact)."""
    while nbits >= _STEP:
        new = word_fn(state)
        state = ((state >> _STEP) | (new << (31 - _STEP))) & _MASK31
        nbits -= _STEP
    if nbits:
        new = word_fn(state) & ((1 << nbits) - 1)
        state = ((state >> nbits) | (new << (31 - nbits))) & _MASK31
    return state


@lru_cache(maxsize=4096)
def _gold_cached(c_init: int, length: int) -> bytes:
    x1 = _advance(1, NC, _x1_word)
    x2 = _advance(c_init & _MASK31, NC, _x2_word)
    nwords = -(-length // _STEP)
    words = np.empty(nwords, dtype=np.uint32)
    for i in range(nwords):
        # state bit k == sequence bit n+k, so the low 28 state bits are output
        words[i] = (x1 ^ x2) & ((1 << _STEP) - 1)
        x1 = _advance(x1, _STEP, _x1_word)
        x2 = _advance(x2, _STEP, _x2_word)
    bits = (words[:, None] >> np.arange(_STEP, dtype=np.uint32)[None, :]) & 1
    return bits.astype(np.uint8).reshape(-1)[:length].tobytes()


def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """Gold sequence c(n), n=0..length-1 as uint8 {0,1} numpy array."""
    return np.frombuffer(_gold_cached(int(c_init), int(length)), dtype=np.uint8).copy()


def gold_sequence_signs(c_init: int, length: int) -> np.ndarray:
    """(-1)^c(n) as float32 — the form used to scramble LLRs/symbols."""
    return (1.0 - 2.0 * gold_sequence(c_init, length)).astype(np.float32)
