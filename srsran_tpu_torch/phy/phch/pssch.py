"""PSSCH: sidelink shared channel (SL-SCH), TS 36.211 §9.3 / TS 36.212
§5.4.2 (counterpart of `srsran_tpu/phy/phch/pssch.py`).

TM1/2: 12 data symbols budgeted per subframe (11 transmitted), QPSK/16QAM
from the UL MCS table; SL-SCH coding = the UL-SCH transport-block chain
(CRC24A, segmentation, turbo, rate matching) followed by the C_mux=12
time-first interleaver, scrambling c_init = N_x_id·2^14 + (sf%10)·2^9 + 510,
and SC-FDMA DFT precoding.  DMRS on symbols 3/10 with group hopping driven
by N_x_id (f_gh pattern from a Gold sequence seeded N_x_id/30).  TM3/4: 10
data symbols budgeted, 4 DMRS symbols and a common-phase ramp fitted over
them.

Host copies: the DMRS, the coding parameters and the encoder.  The decodes
run on the device of the grid and end in `sch.dlsch_decode_device`, whose
turbo decoder launches the MAP kernel on a card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...device import table
from ..chest.refsignal_ul import base_sequence
from ..common import Cell
from ..dft_precoding import dft_precode, dft_predecode
from ..modem import demod_soft, modulate_np
from ..sequence import gold_sequence, gold_sequence_signs
from .pdsch import MOD_QM
from .pscch import DATA_SYMS, DATA_SYMS_TM34, DMRS_SYMS, DMRS_SYMS_TM34, sl_equalize
from .pusch import _deinterleaver_indices, _interleaver_indices
from .ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
from .sch import TbCoding, dlsch_decode_device, dlsch_encode_np

N_DATA_BUDGET = 12
N_DATA_BUDGET_TM34 = 10


def pssch_cinit(n_x_id: int, sf_idx: int) -> int:
    return n_x_id * 16384 + (sf_idx % 10) * 512 + 510


@lru_cache(maxsize=256)
def pssch_dmrs_np(n_x_id: int, nof_prb: int) -> np.ndarray:
    """(2, nof_prb*12) PSSCH DMRS (chest_sl_pssch_gen, TM1/2)."""
    m_sc = nof_prb * 12
    c = gold_sequence(n_x_id // 30, 8 * 2)  # f_gh pattern, first 2 slots
    f_ss = n_x_id % 30
    n_cs = (n_x_id // 2) % 8
    alpha = 2 * np.pi * n_cs / 12
    out = []
    w = (1.0, 1.0) if n_x_id % 2 == 0 else (1.0, -1.0)
    for ns in range(2):
        f_gh = sum(int(c[8 * ns + i]) << i for i in range(8))
        u = (f_gh + f_ss) % 30
        r = base_sequence(u, m_sc) * np.exp(1j * alpha * np.arange(m_sc))
        out.append(w[ns] * r)
    return np.stack(out).astype(np.complex64)


def _coding(mcs_idx: int, nof_prb: int, rv: int, budget: int = N_DATA_BUDGET) -> TbCoding:
    qm = MOD_QM[ul_mcs_to_mod(mcs_idx)]
    tbs = tbs_lookup(ul_mcs_to_itbs(mcs_idx), nof_prb)
    return TbCoding(tbs=tbs, g=budget * nof_prb * 12 * qm, qm=qm, rv=rv, nof_layers=1)


def pssch_encode_np(
    tb_bits: np.ndarray, n_x_id: int, mcs_idx: int, nof_prb: int, sf_idx: int, rv: int = 0
) -> np.ndarray:
    """TB → (11, nof_prb*12) transmitted SC-FDMA symbols."""
    coding = _coding(mcs_idx, nof_prb, rv)
    mod = ul_mcs_to_mod(mcs_idx)
    e = np.asarray(dlsch_encode_np(tb_bits, coding)).astype(np.uint8)
    inter = e[_interleaver_indices(coding.g, coding.qm, c_mux=N_DATA_BUDGET)]
    scr = (inter ^ gold_sequence(pssch_cinit(n_x_id, sf_idx), coding.g)).astype(np.uint8)
    sym = modulate_np(mod, scr).reshape(N_DATA_BUDGET, nof_prb * 12)
    return dft_precode(torch.from_numpy(sym)).numpy()[: len(DATA_SYMS)]


def put_pssch_np(grid, cell: Cell, tb_bits, n_x_id: int, mcs_idx: int, prb_start: int, nof_prb: int,
                 sf_idx: int, rv: int = 0):
    k0 = prb_start * 12
    m_sc = nof_prb * 12
    sym = pssch_encode_np(tb_bits, n_x_id, mcs_idx, nof_prb, sf_idx, rv)
    for i, l in enumerate(DATA_SYMS):
        grid[l, k0 : k0 + m_sc] = sym[i]
    dmrs = pssch_dmrs_np(n_x_id, nof_prb)
    for j, l in enumerate(DMRS_SYMS):
        grid[l, k0 : k0 + m_sc] = dmrs[j]
    return grid


def _slsch_decode(eq: torch.Tensor, coding: TbCoding, mcs_idx: int, n_x_id: int, sf_idx: int,
                  budget: int):
    """(nt, m_sc) equalised symbols → (tb (tbs,) uint8 tensor, crc_ok): IDFT
    de-precoding, soft demod, zero LLRs for the budgeted symbol never sent,
    descrambling, de-interleaving, the SL-SCH (UL-SCH) turbo decode."""
    dev = eq.device
    llr_tx = demod_soft(ul_mcs_to_mod(mcs_idx), dft_predecode(eq).reshape(-1))
    llr = torch.nn.functional.pad(llr_tx, (0, coding.g - llr_tx.shape[-1]))
    llr = llr * table(gold_sequence_signs, pssch_cinit(n_x_id, sf_idx), coding.g, device=dev)
    deinter = llr[table(_deinterleaver_indices, coding.g, coding.qm, budget, device=dev,
                        dtype=torch.int64)]
    tb, ok = dlsch_decode_device(deinter[None], coding)
    return tb[0], bool(ok[0])


def pssch_decode(grid: torch.Tensor, cell: Cell, n_x_id: int, mcs_idx: int, prb_start: int,
                 nof_prb: int, sf_idx: int, rv: int = 0):
    """(nsymb, nre) grid tensor → (tb_bits (tbs,) uint8 tensor on the grid's
    device — empty where the DMRS carry no signal — and crc_ok)."""
    dmrs = table(pssch_dmrs_np, n_x_id, nof_prb, device=grid.device)
    eq, empty = sl_equalize(grid, [prb_start * 12], dmrs[None], DMRS_SYMS, DATA_SYMS)
    if bool(empty[0]):
        return torch.zeros(0, dtype=torch.uint8, device=grid.device), False
    return _slsch_decode(eq[0], _coding(mcs_idx, nof_prb, rv), mcs_idx, n_x_id, sf_idx, N_DATA_BUDGET)


# --- TM3/4 (V2X) variant ----------------------------------------------------


@lru_cache(maxsize=256)
def pssch_dmrs_tm34_np(n_x_id: int, nof_prb: int, sf_idx: int) -> np.ndarray:
    """(4, nof_prb*12) TM3/4 PSSCH DMRS: f_gh pattern indexed by
    (4·(sf%10) + ns), f_ss = (N_x_id/16) % 30, w = ±1 by id parity."""
    m_sc = nof_prb * 12
    c = gold_sequence(n_x_id // 30, 8 * 40)
    f_ss = (n_x_id // 16) % 30
    n_cs = (n_x_id // 2) % 8
    alpha = 2 * np.pi * n_cs / 12
    w = (1.0, 1.0, 1.0, 1.0) if n_x_id % 2 == 0 else (1.0, -1.0, 1.0, -1.0)
    out = []
    for ns in range(4):
        pat = (2 * 2 * (sf_idx % 10)) + ns
        f_gh = sum(int(c[8 * pat + i]) << i for i in range(8))
        u = (f_gh + f_ss) % 30
        r = base_sequence(u, m_sc) * np.exp(1j * alpha * np.arange(m_sc))
        out.append(w[ns] * r)
    return np.stack(out).astype(np.complex64)


def _unwrap(ph: torch.Tensor) -> torch.Tensor:
    """`np.unwrap` along the last axis (discontinuity π)."""
    dd = ph[..., 1:] - ph[..., :-1]
    ddmod = torch.remainder(dd + np.pi, 2 * np.pi) - np.pi
    ddmod = torch.where((ddmod == -np.pi) & (dd > 0), np.pi, ddmod)
    corr = torch.where(torch.abs(dd) < np.pi, 0.0, ddmod - dd)
    return torch.cat([ph[..., :1], ph[..., 1:] + torch.cumsum(corr, dim=-1)], dim=-1)


def _ramp_tables(dmrs_syms: tuple, data_syms: tuple):
    """The DMRS symbol positions centred, and the data symbols' distances
    from their mean (float32)."""
    x = np.asarray(dmrs_syms, np.float64)
    return ((x - x.mean()).astype(np.float32),
            (np.asarray(data_syms, np.float64) - x.mean()).astype(np.float32))


def pssch_decode_tm34(grid: torch.Tensor, cell: Cell, n_x_id: int, mcs_idx: int, prb_start: int,
                      nof_prb: int, sf_idx: int, rv: int = 0):
    """TM3/4 PSSCH decode of a grid tensor → (tb_bits (tbs,) uint8 tensor on
    the grid's device — empty where the DMRS carry no signal — and crc_ok).

    Per-DMRS-symbol LS estimates: their mean gives magnitude and shape; a
    linear common-phase ramp fitted over the symbol index (residual CFO on
    real radio captures, the chest_sl sync_error/CFO handling analog) is
    taken out of the estimate and the data symbols."""
    dev = grid.device
    k0, m_sc = prb_start * 12, nof_prb * 12
    dmrs = table(pssch_dmrs_tm34_np, n_x_id, nof_prb, sf_idx, device=dev)
    ls = grid[torch.as_tensor(DMRS_SYMS_TM34, device=dev), k0 : k0 + m_sc] * torch.conj(dmrs)
    ce = torch.mean(ls, dim=0)
    if bool(torch.mean(torch.abs(ce)) < 1e-6):
        return torch.zeros(0, dtype=torch.uint8, device=dev), False
    ph = _unwrap(torch.angle(torch.sum(torch.conj(ce) * ls, dim=-1)))  # (4,)
    xc, xd = table(_ramp_tables, DMRS_SYMS_TM34, DATA_SYMS_TM34, device=dev)
    slope = torch.sum(xc * (ph - torch.mean(ph))) / torch.sum(xc * xc)
    rot = torch.exp(-1j * slope * xd)  # (nt,)
    ce = torch.mean(ls * torch.exp(-1j * ph)[:, None], dim=0)
    noise = torch.mean(torch.abs(ls[0] * torch.exp(-1j * ph[0]) - ce) ** 2)
    y = grid[torch.as_tensor(DATA_SYMS_TM34, device=dev), k0 : k0 + m_sc]
    eq = y * rot[:, None] * torch.conj(ce) / (torch.abs(ce) ** 2 + noise)
    coding = _coding(mcs_idx, nof_prb, rv, N_DATA_BUDGET_TM34)
    return _slsch_decode(eq, coding, mcs_idx, n_x_id, sf_idx, N_DATA_BUDGET_TM34)
