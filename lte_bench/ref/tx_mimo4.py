"""The benchmark's 4x4 transmitter: two transport blocks to one subframe of
closed-loop spatial multiplexing (TM4) at rank 4 on four antenna ports,
received on four antennas through a fixed channel, in numpy (TS 36.211 /
36.212 / 36.213 Rel-8).

Worked out again from the standard, beside `tx_mimo.py`'s 2-port chain:

- the CRS of ports 2 and 3 (§6.10.1.2): symbol l = 1 of each slot, v = 3
  (n_s mod 2) on port 2 and 3 + 3 (n_s mod 2) on port 3, their values the
  Gold sequence of (n_s, l = 1); ports 0 and 1 as in `tables.py`;
- the PDSCH REs around the CRS of all four ports (§6.3.5), in mapping
  order;
- each TB through the DL-SCH chain with its codeword on two layers: the
  rate matcher's unit is N_L Q_m with N_L = 2 (TS 36.212 §5.1.4.1.2),
  so code block r gets E = N_L Q_m floor or ceil(G' / C), G' = G / (N_L
  Q_m), and G = 2 Q_m times the REs;
- scrambling per codeword (c_init with q = 0, 1, §6.3.1), the layer map of
  two codewords on four layers (§6.3.3.2, Table 6.3.3.2-1: x0 = d0(2i),
  x1 = d0(2i + 1), x2 = d1(2i), x3 = d1(2i + 1));
- the precoder W_n^{c1 c2 c3 c4} / 2 of Table 6.3.4.2.3-2 at rank 4, with
  W_n = I - 2 u_n u_n^H / (u_n^H u_n), and one OFDM modulator per port;
- the configuration's `channel` (rx antenna x tx port).

The TBS of a TB on two layers is TS 36.213 §7.1.7.2.2's: for N_PRB <= 55
the one-layer table (§7.1.7.2.1) at 2 N_PRB, which the configuration
states.  Departures, as in `tx_mimo.py`: one subframe index, one codebook
index and one fixed channel, no control region content and no PSS, SSS or
PBCH (subframe 2 has none).  It may read `tables.py` and `tx.py` and
imports nothing of the program.

Codeword 1 carries `tx_mimo.second_tb(cfg, tb)`, the TB drawn for the
subframe XOR a mask drawn once from the configuration's `cw1_mask_seed`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import tables as T
from .tx import ofdm_tx, sch_encode
from .tx_mimo import channel, cinit

NOF_PORTS = 4
LAYERS_PER_CW = 2
_S = 1.0 / np.sqrt(2.0)
# Table 6.3.4.2.3-2: u_n, and the columns (1-based) of W_n at rank 4
U = np.array([
    [1, -1, -1, -1],
    [1, -1j, 1, 1j],
    [1, 1, -1, 1],
    [1, 1j, 1, -1j],
    [1, (-1 - 1j) * _S, -1j, (1 - 1j) * _S],
    [1, (1 - 1j) * _S, 1j, (-1 - 1j) * _S],
    [1, (1 + 1j) * _S, -1j, (-1 + 1j) * _S],
    [1, (-1 + 1j) * _S, 1j, (1 + 1j) * _S],
    [1, -1, 1, 1],
    [1, -1j, -1, -1j],
    [1, 1, 1, -1],
    [1, 1j, -1, 1j],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, 1, 1, 1],
])
RANK4_COLUMNS = ("1234", "1234", "3214", "3214", "1234", "1234", "1324", "1324",
                 "1234", "1234", "1324", "1324", "1234", "1324", "3214", "1234")


def precoder(index: int) -> np.ndarray:
    """(4 ports, 4 layers) complex64 W of codebook index `index` at rank 4."""
    u = U[index].reshape(4, 1)
    w = np.eye(4) - 2.0 * (u @ u.conj().T) / (u.conj().T @ u).real.item()
    return (w[:, [int(ch) - 1 for ch in RANK4_COLUMNS[index]]] / 2.0).astype(np.complex64)


def crs_layout(nof_prb: int, cell_id: int, port: int) -> tuple[np.ndarray, np.ndarray]:
    """(symbols, subcarriers (len(symbols), 2 nof_prb)) of port `port`'s
    CRS in the subframe: ports 0 and 1 on symbols 0, 4, 7, 11, ports 2 and 3
    on symbols 1 and 8."""
    if port < 2:
        return T.crs_layout(nof_prb, cell_id, port)
    syms = np.array([1, 8])
    v = np.array([3 * slot + 3 * (port == 3) for slot in (0, 1)]) % 6
    return syms, ((v + cell_id % 6) % 6)[:, None] + 6 * np.arange(2 * nof_prb)[None, :]


def crs_values(nof_prb: int, cell_id: int, sf_idx: int, port: int) -> np.ndarray:
    """(len(symbols), 2 nof_prb) complex64 CRS of port `port`: r_{l,n_s}(m'),
    m' = m + N_max - N_DL, with c_init = 2^10 (7 (n_s + 1) + l + 1) (2 N_ID
    + 1) + 2 N_ID + N_CP (normal CP)."""
    if port < 2:
        return T.crs_values(nof_prb, cell_id, sf_idx)
    out = []
    for ns in (2 * sf_idx, 2 * sf_idx + 1):
        c_init = 1024 * (7 * (ns + 1) + 1 + 1) * (2 * cell_id + 1) + 2 * cell_id + 1
        c = T.gold(c_init, 4 * T.MAX_PRB).astype(np.float64)
        m = np.arange(2 * nof_prb) + T.MAX_PRB - nof_prb
        out.append(((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) * np.sqrt(0.5))
    return np.array(out, np.complex64)


@lru_cache(maxsize=16)
def pdsch_re(nof_prb: int, cell_id: int, cfi: int, prb: tuple[int, ...]) -> np.ndarray:
    """Flat indices (symbol * nre + k) of the PDSCH REs of subframe 2 of a
    4-port FDD cell, in mapping order: after the control region (CFI
    symbols, one more below 10 PRB), around every port's CRS."""
    nre = 12 * nof_prb
    reserved = np.zeros((T.NSYMB_SF, nre), bool)
    for p in range(NOF_PORTS):
        syms, k = crs_layout(nof_prb, cell_id, p)
        for s in range(len(syms)):
            reserved[syms[s], k[s]] = True
    sc = np.sort((np.asarray(prb)[:, None] * 12 + np.arange(12)).reshape(-1))
    nctrl = cfi + (1 if nof_prb < 10 else 0)
    return np.concatenate([l * nre + sc[~reserved[l, sc]] for l in range(nctrl, T.NSYMB_SF)])


def re_indices(cfg: dict) -> np.ndarray:
    c, gr = cfg["cell"], cfg["grant"]
    if c["sf_idx"] in (0, 5):
        raise ValueError("the 4x4 transmitter leaves out PSS, SSS and PBCH: not subframe 0 or 5")
    prb = tuple(range(gr["prb_start"], gr["prb_start"] + gr["nof_prb"]))
    return pdsch_re(c["nof_prb"], c["cell_id"], c["cfi"], prb)


def codeword_bits(cfg: dict, tb: np.ndarray, q: int) -> np.ndarray:
    """Codeword q's scrambled bits: G = 2 Q_m per RE, rate matched in units
    of N_L Q_m (`tx.sch_encode`'s `qm` is that unit)."""
    gr = cfg["grant"]
    qm = T.QM[gr["mod"]]
    g = len(re_indices(cfg)) * qm * LAYERS_PER_CW
    bits = sch_encode(tb, g, LAYERS_PER_CW * qm, gr["rv"])
    return bits ^ T.gold(cinit(cfg, q), g)


def layer_map(d0: np.ndarray, d1: np.ndarray) -> np.ndarray:
    """(4 layers, M) of two codewords' symbols (2M each)."""
    return np.stack([d0[0::2], d0[1::2], d1[0::2], d1[1::2]])


def ports_grid(cfg: dict, tb0: np.ndarray, tb1: np.ndarray, crs: bool = True) -> np.ndarray:
    """(4 ports, 14, nre) complex64 grid of the two codewords, precoded,
    with every port's CRS unless `crs` is False."""
    c, gr = cfg["cell"], cfg["grant"]
    nof_prb = c["nof_prb"]
    idx = re_indices(cfg)
    d = [T.modulate(gr["mod"], codeword_bits(cfg, tb, q)) for q, tb in enumerate((tb0, tb1))]
    grid = np.zeros((NOF_PORTS, T.NSYMB_SF, 12 * nof_prb), np.complex64)
    grid.reshape(NOF_PORTS, -1)[:, idx] = precoder(gr["pmi"]) @ layer_map(*d).astype(np.complex64)
    if crs:
        for p in range(NOF_PORTS):
            syms, k = crs_layout(nof_prb, c["cell_id"], p)
            values = crs_values(nof_prb, c["cell_id"], c["sf_idx"], p)
            for s in range(len(syms)):
                grid[p, syms[s], k[s]] = values[s]
    return grid


def pdsch4_subframe(cfg: dict, tb0: np.ndarray, tb1: np.ndarray) -> np.ndarray:
    """(4 rx, 15 N) complex64 samples of one clean subframe behind the
    configuration's channel."""
    ports = ofdm_tx(ports_grid(cfg, tb0, tb1), cfg["cell"]["nof_prb"])
    return (channel(cfg) @ ports).astype(np.complex64)
