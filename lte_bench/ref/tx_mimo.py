"""The benchmark's 2x2 transmitter: two transport blocks to one subframe
of closed-loop spatial multiplexing (TM4) on two antenna ports, received
on two antennas through a fixed channel, in numpy (TS 36.211 Rel-8).

Each TB goes through its own DL-SCH chain (`tx.sch_encode`) and its own
scrambling (c_init with q = 0, 1, §6.3.1), 64QAM or another modulation of
the grant, the layer mapping of two codewords onto two layers (§6.3.3.2:
codeword q on layer q), the 2-port codebook precoder W(PMI) (§6.3.4.2.3,
Table 6.3.4.2.3-1), the CRS of ports 0 and 1 (§6.10.1), one OFDM
modulator per port and the configuration's `channel` (rx antenna x tx
port).  Like `tx.py` it imports nothing of the program.

Codeword 1 carries `second_tb(cfg, tb)`: the TB drawn for the subframe
XOR a mask drawn once from the configuration's `cw1_mask_seed`, so that
the traffic generator draws one TB a subframe and the two codewords still
differ.
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .tx import ofdm_tx, sch_encode

# TS 36.211 Table 6.3.4.2.3-1, two layers: (port, layer)
CODEBOOK_2L = {0: np.array([[1, 0], [0, 1]]) / np.sqrt(2.0),
               1: np.array([[1, 1], [1, -1]]) / 2.0,
               2: np.array([[1, 1], [1j, -1j]]) / 2.0}


def precoder(pmi: int) -> np.ndarray:
    """(2 ports, 2 layers) complex64 W of the PMI."""
    return CODEBOOK_2L[pmi].astype(np.complex64)


def channel(cfg: dict) -> np.ndarray:
    """(rx antenna, tx port) complex64 channel of the configuration."""
    h = np.asarray(cfg["channel"], np.float64)
    return (h[..., 0] + 1j * h[..., 1]).astype(np.complex64)


def cinit(cfg: dict, q: int) -> int:
    """Codeword q's scrambling c_init (§6.3.1): n_RNTI 2^14 + q 2^13 +
    floor(n_s / 2) 2^9 + N_ID."""
    c, gr = cfg["cell"], cfg["grant"]
    return T.pdsch_cinit(gr["rnti"], c["sf_idx"], c["cell_id"]) + (q << 13)


def second_tb(cfg: dict, tb: np.ndarray) -> np.ndarray:
    """Codeword 1's TB: `tb` XOR the mask of `cw1_mask_seed`."""
    mask = np.random.default_rng(cfg["cw1_mask_seed"]).integers(0, 2, tb.shape[-1], dtype=np.uint8)
    return tb ^ mask


def re_indices(cfg: dict) -> np.ndarray:
    """Flat indices of the PDSCH REs around both ports' CRS."""
    c, gr = cfg["cell"], cfg["grant"]
    prb = tuple(range(gr["prb_start"], gr["prb_start"] + gr["nof_prb"]))
    return T.pdsch_re(c["nof_prb"], c["cell_id"], c["nof_ports"], c["sf_idx"], c["cfi"], prb)


def ports_grid(cfg: dict, tb0: np.ndarray, tb1: np.ndarray, crs: bool = True) -> np.ndarray:
    """(2 ports, 14, nre) complex64 grid of the two codewords, precoded,
    with both ports' CRS unless `crs` is False."""
    c, gr = cfg["cell"], cfg["grant"]
    nof_prb = c["nof_prb"]
    idx = re_indices(cfg)
    qm = T.QM[gr["mod"]]
    layers = []
    for q, tb in enumerate((tb0, tb1)):
        bits = sch_encode(tb, len(idx) * qm, qm, gr["rv"])
        bits ^= T.gold(cinit(cfg, q), len(bits))
        layers.append(T.modulate(gr["mod"], bits))
    grid = np.zeros((2, T.NSYMB_SF, 12 * nof_prb), np.complex64)
    grid.reshape(2, -1)[:, idx] = precoder(gr["pmi"]) @ np.stack(layers).astype(np.complex64)
    if crs:
        values = T.crs_values(nof_prb, c["cell_id"], c["sf_idx"])
        for p in range(2):
            syms, k = T.crs_layout(nof_prb, c["cell_id"], p)
            for s in range(4):
                grid[p, syms[s], k[s]] = values[s]
    return grid


def pdsch2_subframe(cfg: dict, tb0: np.ndarray, tb1: np.ndarray) -> np.ndarray:
    """(2 rx, 15 N) complex64 samples of one clean subframe behind the
    configuration's channel."""
    ports = ofdm_tx(ports_grid(cfg, tb0, tb1), cfg["cell"]["nof_prb"])
    return (channel(cfg) @ ports).astype(np.complex64)
