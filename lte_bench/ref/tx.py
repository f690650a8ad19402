"""The benchmark's transmitter: a transport block to one 1 ms subframe of
baseband samples, in numpy (TS 36.211 / 36.212, Rel-8).

A frozen copy of the program's host transmitter (the PDSCH encoder, the
CRS, the OFDM modulator; the PUSCH encoder, its DM-RS, the SC-FDMA
modulator), so that later changes to the program cannot change the
stimuli.  CPU tests hold it equal to the program's transmitter.
"""

from __future__ import annotations

import numpy as np

from . import tables as T

# per RSC state s = r0 + 2 r1 + 4 r2 in the three tail steps: the
# systematic bit r1 ^ r2, the parity r2 ^ r0 and the next state 2 r0 + 4 r1
_S = np.arange(8)
_R0, _R1, _R2 = _S & 1, (_S >> 1) & 1, (_S >> 2) & 1
TAIL_BIT, TAIL_PARITY, TAIL_NEXT = _R1 ^ _R2, _R2 ^ _R0, 2 * _R0 + 4 * _R1


def _rsc(u: np.ndarray) -> tuple[np.ndarray, int]:
    """Parity of the RSC encoder (feedback 1+D^2+D^3, forward 1+D+D^3) and
    its final state.  The feedback sequence a = u / (1+D^2+D^3) has period
    7 in its impulse response, so a is four per-phase prefix XORs."""
    k = len(u)
    q = np.empty(k, np.uint8)
    for p in range(7):
        q[p::7] = np.bitwise_xor.accumulate(u[p::7])
    a = q.copy()
    for c in (2, 3, 4):
        a[c:] ^= q[: k - c]
    z = a.copy()
    z[1:] ^= a[:-1]
    z[3:] ^= a[:-3]
    return z, int(a[-3]) << 2 | int(a[-2]) << 1 | int(a[-1])


def _tail(s: int) -> tuple[list[int], list[int]]:
    xs, zs = [], []
    for _ in range(3):
        xs.append(int(TAIL_BIT[s]))
        zs.append(int(TAIL_PARITY[s]))
        s = int(TAIL_NEXT[s])
    return xs, zs


def turbo_encode(bits: np.ndarray) -> np.ndarray:
    """One code block to its d-streams (3, K+4), tail bits as §5.1.3.2.2
    orders them."""
    k = len(bits)
    p1, s1 = _rsc(bits)
    p2, s2 = _rsc(bits[T.qpp(k)])
    x1, z1 = _tail(s1)
    x2, z2 = _tail(s2)
    d = np.zeros((3, k + 4), np.uint8)
    d[0, :k], d[1, :k], d[2, :k] = bits, p1, p2
    d[0, k:] = [x1[0], z1[1], x2[0], z2[1]]
    d[1, k:] = [z1[0], x1[2], z2[0], x2[2]]
    d[2, k:] = [x1[1], z1[2], x2[1], z2[2]]
    return d


def sch_encode(tb: np.ndarray, g: int, qm: int, rv: int = 0) -> np.ndarray:
    """DL-SCH / UL-SCH: TB bits (tbs,) to the g coded bits: CRC24A,
    segmentation with filler bits, CRC24B per block when there are
    several, turbo code, rate match, concatenation."""
    sizes, f = T.segment(len(tb))
    b = T.crc_attach(tb.astype(np.uint8), T.CRC24A)
    es = T.e_sizes(g, len(sizes), qm)
    out, pos = [], 0
    for r, k in enumerate(sizes):
        fr = f if r == 0 else 0
        take = k - fr - (24 if len(sizes) > 1 else 0)
        cb = np.concatenate([np.zeros(fr, np.uint8), b[pos : pos + take]])
        pos += take
        if len(sizes) > 1:
            cb = T.crc_attach(cb, T.CRC24B)
        out.append(turbo_encode(cb).reshape(-1)[T.rm_indices(k, es[r], rv, fr)])
    return np.concatenate(out)


def ofdm_tx(grid: np.ndarray, nof_prb: int) -> np.ndarray:
    """(..., 14, nre) grid to (..., 15 N) samples: the REs around the DC
    bin, an IFFT scaled by 1/sqrt(N), the cyclic prefixes."""
    n = T.symbol_sz(nof_prb)
    nre = 12 * nof_prb
    bins = np.zeros(grid.shape[:-1] + (n,), np.complex64)
    bins[..., 1 : 1 + nre // 2] = grid[..., nre // 2 :]
    bins[..., n - nre // 2 :] = grid[..., : nre // 2]
    sym = np.fft.ifft(bins, axis=-1) * n
    sym = sym * (1.0 / np.sqrt(n))
    pieces = []
    for i in range(T.NSYMB_SF):
        cp = T.cp_len(i % T.NSYMB_SLOT, n)
        pieces += [sym[..., i, n - cp :], sym[..., i, :]]
    return np.concatenate(pieces, axis=-1).astype(np.complex64)


def pdsch_grid(cfg: dict, tb: np.ndarray) -> np.ndarray:
    """(14, nre) grid of one PDSCH subframe on port 0 with its CRS."""
    c = cfg["cell"]
    gr = cfg["grant"]
    nof_prb, cell_id, sf = c["nof_prb"], c["cell_id"], c["sf_idx"]
    prb = tuple(range(gr["prb_start"], gr["prb_start"] + gr["nof_prb"]))
    idx = T.pdsch_re(nof_prb, cell_id, c["nof_ports"], sf, c["cfi"], prb)
    qm = T.QM[gr["mod"]]
    bits = sch_encode(tb, len(idx) * qm, qm, gr["rv"])
    bits ^= T.gold(T.pdsch_cinit(gr["rnti"], sf, cell_id), len(bits))
    grid = np.zeros((T.NSYMB_SF, 12 * nof_prb), np.complex64)
    grid.reshape(-1)[idx] = T.modulate(gr["mod"], bits)
    syms, k = T.crs_layout(nof_prb, cell_id, 0)
    values = T.crs_values(nof_prb, cell_id, sf)
    for s in range(4):
        grid[syms[s], k[s]] = values[s]
    return grid


def pdsch_subframe(cfg: dict, tb: np.ndarray) -> np.ndarray:
    """(1, 15 N) complex64 samples of one clean PDSCH subframe."""
    return ofdm_tx(pdsch_grid(cfg, tb), cfg["cell"]["nof_prb"])[None, :]


def pusch_grid(cfg: dict, tb: np.ndarray) -> np.ndarray:
    """(14, nre) grid of one PUSCH subframe (no UCI) with its DM-RS."""
    c = cfg["cell"]
    gr = cfg["grant"]
    nof_prb, cell_id, sf = c["nof_prb"], c["cell_id"], c["sf_idx"]
    m_sc = 12 * gr["nof_prb"]
    k0 = 12 * gr["prb_start"]
    qm = T.QM[gr["mod"]]
    nsym = len(T.PUSCH_DATA_SYMS)
    g = nsym * m_sc * qm
    bits = sch_encode(tb, g, qm, gr["rv"])[T.ul_interleaver(g, qm)]
    bits ^= T.gold(T.pusch_cinit(gr["rnti"], sf, cell_id), g)
    sym = T.modulate(gr["mod"], bits).reshape(nsym, m_sc)
    grid = np.zeros((T.NSYMB_SF, 12 * nof_prb), np.complex64)
    grid[list(T.PUSCH_DATA_SYMS), k0 : k0 + m_sc] = sym @ T.dft_matrix(m_sc, False)
    grid[list(T.DMRS_SYMS), k0 : k0 + m_sc] = T.dmrs(gr["nof_prb"], cell_id)
    return grid


def pusch_subframe(cfg: dict, tb: np.ndarray) -> np.ndarray:
    """(1, 15 N) complex64 samples of one clean PUSCH subframe, shifted by
    half a subcarrier."""
    nof_prb = cfg["cell"]["nof_prb"]
    return (ofdm_tx(pusch_grid(cfg, tb), nof_prb) * T.half_shift(nof_prb, 1.0))[None, :]
