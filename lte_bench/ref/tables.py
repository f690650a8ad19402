"""Host tables of the LTE physical layer that the benchmark's transmitter
and reference receiver share (TS 36.211 / 36.212, Rel-8), in numpy.

A frozen copy: it imports nothing of the program, so a change to the
program can change neither the stimuli nor the yardstick.  Only what the
benchmark's configurations use is here: normal CP, standard sampling
rates, FDD, turbo-coded shared channels, PDSCH on port 0 with the CRS of
1 or 2 ports, PUSCH without UCI and with one DM-RS of 3 PRB or more.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

MAX_PRB = 110
NSYMB_SLOT = 7
NSYMB_SF = 14
CRC24A = 0x1864CFB
CRC24B = 0x1800063
QM = {"QPSK": 2, "QAM16": 4, "QAM64": 6}


# --- cell geometry (TS 36.211 §6.12, Table 6.12-1) ----------------------------


def symbol_sz(nof_prb: int) -> int:
    for prb, sz in ((6, 128), (15, 256), (25, 512), (50, 1024), (75, 1536), (100, 2048)):
        if nof_prb <= prb:
            return sz
    raise ValueError(f"no FFT size for {nof_prb} PRB")


def cp_len(l: int, n: int) -> int:
    """CP of symbol l of a slot: 160 / 144 samples at 2048, scaled to n."""
    return int(math.ceil((160 if l == 0 else 144) * n / 2048.0))


@lru_cache(maxsize=16)
def symbol_starts(nof_prb: int) -> tuple[int, ...]:
    """First sample of every symbol's FFT window (after its CP)."""
    n = symbol_sz(nof_prb)
    starts = []
    for slot in range(2):
        t = slot * n * 15 // 2
        for l in range(NSYMB_SLOT):
            t += cp_len(l, n)
            starts.append(t)
            t += n
    return tuple(starts)


@lru_cache(maxsize=16)
def half_shift(nof_prb: int, sign: float) -> np.ndarray:
    """exp(j 2 pi sign/2 (t - t0) / N) over a subframe, with t0 the FFT
    window start of the symbol that sample t belongs to (CP included):
    the half-subcarrier shift of SC-FDMA (TS 36.211 §5.6)."""
    n = symbol_sz(nof_prb)
    sf = 15 * n
    starts = symbol_starts(nof_prb)
    ref = np.zeros(sf, np.float64)
    cp_start = 0
    for i, s in enumerate(starts):
        end = sf if i == NSYMB_SF - 1 else s + n
        ref[cp_start:end] = s
        cp_start = end
    t = np.arange(sf, dtype=np.float64)
    return np.exp(2j * np.pi * (sign * 0.5) * (t - ref) / n).astype(np.complex64)


# --- Gold sequence (TS 36.211 §7.2) ---------------------------------------------


@lru_cache(maxsize=64)
def _gold(c_init: int, length: int) -> bytes:
    nc = 1600
    total = nc + length
    x1 = np.zeros(total + 31, np.uint8)
    x2 = np.zeros(total + 31, np.uint8)
    x1[0] = 1
    x2[:31] = [(c_init >> i) & 1 for i in range(31)]
    # the recursions reach 31 back, so blocks of 28 new bits depend only on
    # bits that already exist
    for start in range(0, total, 28):
        stop = min(start + 28, total)
        x1[start + 31 : stop + 31] = x1[start + 3 : stop + 3] ^ x1[start:stop]
        x2[start + 31 : stop + 31] = (x2[start + 3 : stop + 3] ^ x2[start + 2 : stop + 2]
                                      ^ x2[start + 1 : stop + 1] ^ x2[start:stop])
    return (x1[nc : nc + length] ^ x2[nc : nc + length]).tobytes()


def gold(c_init: int, length: int) -> np.ndarray:
    """c(n), n = 0 .. length-1, as uint8."""
    return np.frombuffer(_gold(int(c_init), int(length)), np.uint8).copy()


# --- CRC (TS 36.212 §5.1.1) ---------------------------------------------------------


@lru_cache(maxsize=32)
def crc_matrix(poly: int, length: int) -> np.ndarray:
    """(length, 24) uint8 M with crc = bits @ M mod 2, MSB first: row i is
    x^(length - 1 - i + 24) mod g(x)."""
    order = 24
    m = np.zeros((length, order), np.uint8)
    r = 1
    for _ in range(order):
        r <<= 1
        if (r >> order) & 1:
            r ^= poly
    for i in range(length - 1, -1, -1):
        m[i] = [(r >> (order - 1 - j)) & 1 for j in range(order)]
        r <<= 1
        if (r >> order) & 1:
            r ^= poly
    return m


def crc_attach(bits: np.ndarray, poly: int) -> np.ndarray:
    # a float64 product is exact here: each sum counts at most len(bits) ones
    m = crc_matrix(poly, bits.shape[-1]).astype(np.float64)
    crc = (bits.astype(np.float64) @ m).astype(np.int64) & 1
    return np.concatenate([bits.astype(np.uint8), crc.astype(np.uint8)], axis=-1)


# --- code block segmentation and the QPP interleaver (TS 36.212 §5.1.2, §5.1.3) ---

CB_SIZES = tuple(list(range(40, 513, 8)) + list(range(528, 1025, 16))
                 + list(range(1056, 2049, 32)) + list(range(2112, 6145, 64)))
# TS 36.212 Table 5.1.3-3: f1 and f2 of each K of CB_SIZES, in order
_F1 = (
    3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57, 23, 13,
    27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21, 115, 193, 21, 133, 81,
    45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29, 247, 29, 89, 91, 157, 55, 31, 17, 35, 227,
    65, 19, 37, 41, 39, 185, 43, 21, 155, 79, 139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215,
    29, 15, 147, 29, 59, 65, 55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21, 43, 149,
    45, 49, 71, 13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31, 59, 185, 113, 31, 17, 171,
    209, 253, 367, 265, 181, 39, 27, 127, 143, 43, 29, 45, 157, 47, 13, 111, 443, 51, 51, 451, 257,
    57, 313, 271, 179, 331, 363, 375, 127, 31, 33, 43, 33, 477, 35, 233, 357, 337, 37, 71, 71, 37,
    39, 127, 39, 39, 31, 113, 41, 251, 43, 21, 43, 45, 45, 161, 89, 323, 47, 23, 47, 263,
)
_F2 = (
    10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84, 44, 46, 48, 50,
    52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76, 78, 120, 82, 84, 86, 44, 90, 46,
    94, 48, 98, 40, 102, 52, 106, 72, 110, 168, 114, 58, 118, 180, 122, 62, 84, 64, 66, 68, 420,
    96, 74, 76, 234, 80, 82, 252, 86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110, 112,
    114, 58, 118, 60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78, 240, 82, 252, 86, 88, 60,
    92, 846, 48, 28, 80, 102, 104, 954, 96, 110, 112, 114, 116, 354, 120, 610, 124, 420, 64, 66, 136,
    420, 216, 444, 456, 468, 80, 164, 504, 172, 88, 300, 92, 188, 96, 28, 240, 204, 104, 212, 192, 220,
    336, 228, 232, 236, 120, 244, 248, 168, 64, 130, 264, 134, 408, 138, 280, 142, 480, 146, 444, 120, 152,
    462, 234, 158, 80, 96, 902, 166, 336, 170, 86, 174, 176, 178, 120, 182, 184, 186, 94, 190, 480,
)


@lru_cache(maxsize=64)
def segment(tbs: int) -> tuple[tuple[int, ...], int]:
    """(code block sizes K_r, filler bits F) of a TB of `tbs` bits."""
    b = tbs + 24
    if b <= 6144:
        c, b_p = 1, b
    else:
        c = -(-b // (6144 - 24))
        b_p = b + 24 * c
    idx = int(np.searchsorted(CB_SIZES, -(-b_p // c)))
    while CB_SIZES[idx] * c < b_p:
        idx += 1
    k_plus = CB_SIZES[idx]
    if c == 1:
        sizes = (k_plus,)
    else:
        k_minus = CB_SIZES[idx - 1]
        c_minus = (c * k_plus - b_p) // (k_plus - k_minus)
        sizes = (k_minus,) * c_minus + (k_plus,) * (c - c_minus)
    return sizes, sum(sizes) - b_p


@lru_cache(maxsize=64)
def qpp(k: int) -> np.ndarray:
    """pi(i) = (f1 i + f2 i^2) mod K."""
    j = CB_SIZES.index(k)
    i = np.arange(k, dtype=np.int64)
    return (_F1[j] * i + _F2[j] * i * i) % k


def e_sizes(g: int, c: int, qm: int) -> list[int]:
    """Rate-matching output size of every code block (§5.1.4.1.2)."""
    gp = g // qm
    gamma = gp % c
    return [qm * (gp // c) if r <= c - 1 - gamma else qm * -(-gp // c) for r in range(c)]


# --- turbo rate matching (TS 36.212 §5.1.4.1) -----------------------------------------

_PERM = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                  1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31], np.int64)


@lru_cache(maxsize=64)
def rm_indices(k: int, e: int, rv: int, n_filler: int) -> np.ndarray:
    """The e positions in the flat (3*(K+4),) d-stream array that the
    circular buffer sends, from k0 on, skipping <NULL> and filler bits."""
    d = k + 4
    r = -(-d // 32)
    kp = 32 * r
    nd = kp - d
    y01 = (np.arange(r)[None, :] * 32 + _PERM[:, None]).reshape(-1)
    m = np.arange(kp)
    y2 = (_PERM[m // r] + 32 * (m % r) + 1) % kp
    w = np.empty(3 * kp, np.int64)
    w[:kp] = np.where(y01 < nd, -1, y01 - nd)
    w[kp::2] = np.where(y01 < nd, -1, d + y01 - nd)
    w[kp + 1 :: 2] = np.where(y2 < nd, -1, 2 * d + y2 - nd)
    keep = w >= 0
    if n_filler:
        keep &= ~(((w >= 0) & (w < n_filler)) | ((w >= d) & (w < d + n_filler)))
    k0 = r * (2 * int(np.ceil(3 * kp / (8.0 * r))) * rv + 2)
    order = np.concatenate([np.arange(k0, 3 * kp), np.arange(0, k0)])
    stream = w[order][keep[order]]
    return np.tile(stream, -(-e // len(stream)))[:e]


# --- modulation (TS 36.211 §7.1) ---------------------------------------------------------


@lru_cache(maxsize=8)
def constellation(mod: str) -> np.ndarray:
    """Symbols indexed by the MSB-first bit word: even bits steer I, odd
    bits Q; per axis the first bit is the sign and the rest a Gray-coded
    amplitude."""
    m = QM[mod]
    half = m // 2
    norm = {2: 2.0, 4: 10.0, 6: 42.0}[m] ** 0.5

    table = np.empty(2**m, np.complex64)
    for word in range(2**m):
        bits = [(word >> (m - 1 - i)) & 1 for i in range(m)]
        axes = []
        for ab in (bits[0::2], bits[1::2]):
            amp = 1.0
            for j in range(half - 1, 0, -1):
                amp = 2.0 ** (half - j) - (1 - 2 * ab[j]) * amp
            axes.append((1 - 2 * ab[0]) * amp)
        table[word] = (axes[0] + 1j * axes[1]) / norm
    return table


def modulate(mod: str, bits: np.ndarray) -> np.ndarray:
    m = QM[mod]
    words = bits.reshape(bits.shape[:-1] + (-1, m)).astype(np.int64) @ (1 << np.arange(m - 1, -1, -1))
    return constellation(mod)[words]


# --- reference signals -------------------------------------------------------------------


def crs_layout(nof_prb: int, cell_id: int, port: int) -> tuple[np.ndarray, np.ndarray]:
    """(symbols (4,), subcarriers (4, 2*nof_prb)) of port 0's or 1's CRS."""
    syms = np.array([0, 4, 7, 11])
    v = np.array([0, 3, 0, 3]) if port == 0 else np.array([3, 0, 3, 0])
    k = ((v + cell_id % 6) % 6)[:, None] + 6 * np.arange(2 * nof_prb)[None, :]
    return syms, k


def crs_values(nof_prb: int, cell_id: int, sf_idx: int) -> np.ndarray:
    """(4, 2*nof_prb) complex64 CRS of ports 0 and 1, symbols in subframe order."""
    out = []
    for ns in (2 * sf_idx, 2 * sf_idx + 1):
        for l in (0, 4):
            c_init = 1024 * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1) + 2 * cell_id + 1
            c = gold(c_init, 4 * MAX_PRB).astype(np.float64)
            m = np.arange(2 * nof_prb) + MAX_PRB - nof_prb
            out.append(((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) * np.sqrt(0.5))
    return np.array(out, np.complex64)


@lru_cache(maxsize=16)
def pdsch_re(nof_prb: int, cell_id: int, nof_ports: int, sf_idx: int, cfi: int,
             prb: tuple[int, ...]) -> np.ndarray:
    """Flat indices (symbol * nre + k) of the PDSCH REs of an FDD subframe
    in mapping order: after the control region, around the CRS of every
    port and, in the central 6 PRB, the PSS/SSS (subframes 0, 5) and the
    PBCH (subframe 0)."""
    nre = 12 * nof_prb
    reserved = np.zeros((NSYMB_SF, nre), bool)
    for p in range(nof_ports):
        syms, k = crs_layout(nof_prb, cell_id, p)
        for s in range(4):
            reserved[syms[s], k[s]] = True
    c0 = nof_prb // 2 * 12 - 36 + 6 * (nof_prb % 2)
    central = np.arange(c0, c0 + 72)
    if sf_idx in (0, 5):
        reserved[5, central] = reserved[6, central] = True
    if sf_idx == 0:
        reserved[7:11, central] = True
    sc = np.sort((np.asarray(prb)[:, None] * 12 + np.arange(12)).reshape(-1))
    nctrl = cfi + (1 if nof_prb < 10 else 0)
    return np.concatenate([l * nre + sc[~reserved[l, sc]] for l in range(nctrl, NSYMB_SF)])


def pdsch_cinit(rnti: int, sf_idx: int, cell_id: int) -> int:
    return (rnti << 14) + (sf_idx << 9) + cell_id


def pusch_cinit(rnti: int, sf_idx: int, cell_id: int) -> int:
    return (rnti << 14) + (sf_idx << 9) + cell_id


PUSCH_DATA_SYMS = (0, 1, 2, 4, 5, 6, 7, 8, 9, 11, 12, 13)
DMRS_SYMS = (3, 10)


@lru_cache(maxsize=8)
def dmrs(nof_prb_alloc: int, cell_id: int) -> np.ndarray:
    """(12 * nof_prb_alloc,) PUSCH DM-RS with cyclic shift 0, group hopping
    off (u = cell_id mod 30, v = 0): the cyclically extended Zadoff-Chu
    sequence of the largest prime below the length (§5.5.1.1)."""
    m_sc = 12 * nof_prb_alloc
    if m_sc < 36:
        raise ValueError("the benchmark's DM-RS needs 3 PRB or more")
    nzc = next(c for c in range(m_sc - 1, 1, -1) if all(c % d for d in range(2, int(c**0.5) + 1)))
    q_bar = nzc * (cell_id % 30 + 1) / 31.0
    q = int(np.floor(q_bar + 0.5))
    m = np.arange(nzc)
    zc = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    return zc[np.arange(m_sc) % nzc].astype(np.complex64)


@lru_cache(maxsize=8)
def ul_interleaver(g: int, qm: int) -> np.ndarray:
    """out[i] = in[idx[i]] of the PUSCH channel interleaver without UCI
    (§5.2.2.8): Qm-bit groups written row by row into 12 columns, read
    column by column."""
    return np.arange(g).reshape(g // (qm * 12), 12, qm).transpose(1, 0, 2).reshape(-1)


@lru_cache(maxsize=8)
def dft_matrix(m: int, inverse: bool) -> np.ndarray:
    n = np.arange(m)
    return (np.exp((2j if inverse else -2j) * np.pi * np.outer(n, n) / m) / np.sqrt(m)).astype(np.complex64)
