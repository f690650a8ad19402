"""PMCH + MBSFN reference signals (eMBMS), TS 36.211 §6.5/§6.10.2
(counterpart of `srsran_tpu/phy/phch/pmch.py`).

MBSFN subframes use the extended CP in the MBSFN region; the first
`NON_MBSFN_SYMS` symbols (the control region) carry no PMCH.  MBSFN RS:
symbols 2/6/10, six pilots per PRB (2-subcarrier spacing, frequency offsets
0/1/0), sequence c_init = 512·(7·(slot+1)+l'+1)·(2·N_area+1) + N_area.
PMCH: the DL-SCH transport-block chain scrambled with c_init = (sf << 9) +
N_area over the MBSFN-region REs.

Host copies: the RS positions and sequence, `put_mbsfn_rs_np`,
`pmch_re_indices`, `pmch_cinit`, `pmch_encode_np`.  `chest_mbsfn` and
`pmch_decode` run on the device of the received grid; the decode ends in
`sch.dlsch_decode_device`, whose turbo decoder launches the MAP kernel on a
card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..common import MAX_PRB, Cell
from ..modem import demod_soft, modulate_np
from ..scrambling import scramble_bits, scramble_soft
from ..sequence import gold_sequence, gold_sequence_signs
from .pdsch import MOD_QM
from .sch import TbCoding, dlsch_decode_device, dlsch_encode_np

MBSFN_RS_SYMS = (2, 6, 10)  # extended-CP symbol indices
_FIDX0 = (0, 1, 0)
NON_MBSFN_SYMS = 2  # control region, no PMCH


@lru_cache(maxsize=64)
def mbsfn_rs_positions(cell: Cell):
    """(syms (3,), freqs (3, 6*nof_prb))."""
    freqs = []
    for j in range(3):
        freqs.append(_FIDX0[j] + 2 * np.arange(6 * cell.nof_prb))
    return np.asarray(MBSFN_RS_SYMS, np.int32), np.stack(freqs).astype(np.int32)


@lru_cache(maxsize=256)
def mbsfn_rs_sequence(cell: Cell, sf_idx: int, area_id: int) -> np.ndarray:
    """(3, 6*nof_prb) pilot values (refsignal_mbsfn_gen_seq)."""
    out = np.zeros((3, 6 * cell.nof_prb), np.complex64)
    for j, nsym in enumerate(MBSFN_RS_SYMS):
        lp = nsym % 6
        slot = 2 * sf_idx + (1 if j else 0)
        c_init = 512 * (7 * (slot + 1) + lp + 1) * (2 * area_id + 1) + area_id
        c = gold_sequence(c_init, 20 * MAX_PRB)
        m = np.arange(6 * cell.nof_prb) + 3 * (MAX_PRB - cell.nof_prb)
        re = (1.0 - 2.0 * c[2 * m]) * np.sqrt(0.5)
        im = (1.0 - 2.0 * c[2 * m + 1]) * np.sqrt(0.5)
        out[j] = (re + 1j * im).astype(np.complex64)
    return out


def put_mbsfn_rs_np(grid: np.ndarray, cell: Cell, sf_idx: int, area_id: int):
    syms, freqs = mbsfn_rs_positions(cell)
    seq = mbsfn_rs_sequence(cell, sf_idx, area_id)
    for j in range(3):
        grid[syms[j], freqs[j]] = seq[j]
    return grid


def _chest_tables(cell: Cell, sf_idx: int, area_id: int):
    """(syms (3, 1), freqs (3, npil), conj(seq) (3, npil), and the linear
    interpolation of the even-subcarrier pilots to every subcarrier: i0, i1
    (nre,) and the weight of i1 (nre,); past the last pilot the last value
    holds, as `jnp.interp` has it)."""
    syms, freqs = mbsfn_rs_positions(cell)
    npil = freqs.shape[1]
    k = np.arange(cell.nof_re_per_symbol)
    i0 = np.minimum(k // 2, npil - 1)
    i1 = np.minimum(i0 + 1, npil - 1)
    w = np.where(k < 2 * (npil - 1), (k - 2 * i0) / 2.0, 0.0)
    return (syms.astype(np.int64)[:, None], freqs.astype(np.int64),
            np.conj(mbsfn_rs_sequence(cell, sf_idx, area_id)), i0.astype(np.int64),
            i1.astype(np.int64), w.astype(np.float32))


def chest_mbsfn(grid: torch.Tensor, cell: Cell, sf_idx: int, area_id: int):
    """LS at the dense MBSFN pilots of a (..., nsymb, nre) grid → (ce (...,
    nsymb, nre), noise (...)): the three pilot symbols averaged, linearly
    interpolated in frequency, constant in time."""
    syms, freqs, ref_conj, i0, i1, w = table(_chest_tables, cell, sf_idx, area_id,
                                             device=grid.device)
    ls = grid[..., syms, freqs] * ref_conj  # (..., 3, npil)
    h = torch.mean(ls, dim=-2)
    full = h[..., i0] + w * (h[..., i1] - h[..., i0])
    noise = torch.mean(torch.abs(ls - h[..., None, :]) ** 2, dim=(-1, -2))
    ce = full[..., None, :].expand(full.shape[:-1] + (cell.nsymb_per_sf, full.shape[-1]))
    return ce, noise


@lru_cache(maxsize=64)
def pmch_re_indices(cell: Cell) -> np.ndarray:
    """Flat (l*nre + k) PMCH REs: the MBSFN region minus MBSFN RS."""
    nre = cell.nof_re_per_symbol
    reserved = np.zeros((cell.nsymb_per_sf, nre), bool)
    syms, freqs = mbsfn_rs_positions(cell)
    for j in range(3):
        reserved[syms[j], freqs[j]] = True
    out = []
    for l in range(NON_MBSFN_SYMS, cell.nsymb_per_sf):
        ks = np.nonzero(~reserved[l])[0]
        out.append(l * nre + ks)
    return np.concatenate(out).astype(np.int32)


def pmch_cinit(sf_idx: int, area_id: int) -> int:
    return (sf_idx << 9) + area_id


def pmch_encode_np(cell: Cell, sf_idx: int, area_id: int, mod, tbs: int, tb_bits: np.ndarray) -> np.ndarray:
    """TB → (nsymb, nre) grid (PMCH + MBSFN RS)."""
    idx = pmch_re_indices(cell)
    qm = MOD_QM[mod]
    coding = TbCoding(tbs=tbs, g=len(idx) * qm, qm=qm, rv=0, nof_layers=1)
    e = np.asarray(dlsch_encode_np(tb_bits, coding)).astype(np.uint8)
    seq = gold_sequence(pmch_cinit(sf_idx, area_id), len(e))
    scr = np.asarray(scramble_bits(e, seq))
    sym = modulate_np(mod, scr)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    grid.reshape(-1)[idx] = sym
    put_mbsfn_rs_np(grid, cell, sf_idx, area_id)
    return grid


def pmch_decode(rx_grid: torch.Tensor, cell: Cell, sf_idx: int, area_id: int, mod, tbs: int,
                max_iterations: int = 5):
    """(nsymb, nre) received grid → (tb_bits (tbs,) uint8 tensor on the
    grid's device, crc_ok bool): MBSFN-RS equalisation, soft demod,
    descrambling, the DL-SCH decode.  One host read, the CRC verdict."""
    dev = rx_grid.device
    ce, noise = chest_mbsfn(rx_grid, cell, sf_idx, area_id)
    idx = table(pmch_re_indices, cell, device=dev, dtype=torch.int64)
    y = rx_grid.reshape(-1)[idx]
    h = ce.reshape(-1)[idx]
    eq = y * torch.conj(h) / (torch.abs(h) ** 2 + noise)
    qm = MOD_QM[mod]
    llr = demod_soft(mod, eq)
    llr = scramble_soft(llr, table(gold_sequence_signs, pmch_cinit(sf_idx, area_id),
                                   idx.numel() * qm, device=dev))
    coding = TbCoding(tbs=tbs, g=idx.numel() * qm, qm=qm, rv=0, nof_layers=1)
    tb, ok = dlsch_decode_device(llr[None], coding, max_iterations)
    return tb[0], bool(ok[0])
