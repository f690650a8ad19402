"""PUSCH: grant, channel interleaver, UCI multiplexing, scrambling c_init and
host encode.

Counterpart of `UlGrant`, `UciCfg`, `_interleaver_indices`,
`pusch_symbols_data`, `pusch_cinit` and `pusch_encode_np` of
`srsran_tpu/phy/phch/pusch.py`.  Chain (TS 36.212 §5.2.2 / 36.211 §5.3):
UL-SCH coding → CQI concatenation + RI-reserved / ACK-punctured time-first
channel interleaver → scrambling → modulation → DFT precoding → mapping to
the allocated PRBs (every symbol but the DMRS symbol of each slot) → DMRS.
UCI coding: RM(32,O) cyclically extended for CQI up to 11 bits, CRC8 + the
tail-biting conv code above; RI/ACK as Qm-wise repetition; Q' dimensioning
per §5.2.2.6 with the TS 36.213 §8.6.3 beta tables.

`pusch_decode` is the eNB's receive side on the device of the grid:
`pusch_llr` (MRC, IDFT, soft demod, per-symbol CSI weights, descrambling),
then the de-interleaving gather and `dlsch_decode`; with UCI, `pusch_uci`
takes the RI and ACK decisions and decodes the CQI first, reading back only
what they need.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..chest.refsignal_ul import dmrs_symbol_in_slot, pusch_dmrs
from ..common import LTE_CRC8, Cell
from ..crc import crc_compute_np
from ..dft_precoding import _dft_matrix, dft_predecode
from ..fec.cbsegm import cbsegm
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx_np, conv_rm_indices
from ..mimo import predecode_single_mrc
from ..modem import Mod, demod_soft, modulate_np
from ..scrambling import scramble_bits
from ..sequence import gold_sequence, gold_sequence_signs
from .pdsch import MOD_QM
from .sch import TbCoding, dlsch_decode, dlsch_encode_np
from .uci import rm_decode, rm_encode


@dataclasses.dataclass(frozen=True)
class UlGrant:
    prb_start: int
    nof_prb: int
    mod: Mod = Mod.QPSK
    tbs: int = 0
    rv: int = 0
    rnti: int = 0x1234

    @property
    def qm(self) -> int:
        return MOD_QM[self.mod]


@dataclasses.dataclass(frozen=True)
class UciCfg:
    """UCI carried on PUSCH (srslte_uci_cfg_t/uci_value_t roles)."""

    cqi_bits: tuple = ()  # payload bits (wideband CQI/PMI up to 11, subband above)
    ack: tuple = ()       # HARQ-ACK values (0/1)
    ri: tuple = ()        # rank indicator values (0/1)
    i_offset_cqi: int = 7
    i_offset_ack: int = 6
    i_offset_ri: int = 6


@lru_cache(maxsize=256)
def _interleaver_indices(g: int, qm: int, c_mux: int = 12) -> np.ndarray:
    """Time-first channel interleaver permutation (TS 36.212 §5.2.2.8).

    Returns idx with out[i] = in[idx[i]] for the G coded bits: bits are
    written row-wise in Qm-groups into (R', C_mux) and read column-wise."""
    if g % (qm * c_mux):
        raise ValueError(f"G={g} is no multiple of Qm*C_mux={qm * c_mux}")
    r_prime = g // (qm * c_mux)
    m = np.arange(g).reshape(r_prime, c_mux, qm)
    return m.transpose(1, 0, 2).reshape(-1).astype(np.int32)


@lru_cache(maxsize=256)
def _deinterleaver_indices(g: int, qm: int, c_mux: int = 12) -> np.ndarray:
    """The inverse permutation: in[j] = out[inv[j]] (what the receiver's
    scatter `zeros.at[idx].set(out)` computes, as a gather)."""
    idx = _interleaver_indices(g, qm, c_mux)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(g, dtype=idx.dtype)
    return inv


# TS 36.213 Tables 8.6.3-1/-2/-3
BETA_ACK = [2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625, 15.875, 20.0,
            31.0, 50.0, 80.0, 126.0]
BETA_RI = [1.25, 1.625, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625,
           15.875, 20.0]
BETA_CQI = [None, None, 1.125, 1.25, 1.375, 1.625, 1.750, 2.0, 2.25, 2.5,
            2.875, 3.125, 3.5, 4.0, 5.0, 6.25]

_RI_COLUMNS = (1, 4, 7, 10)   # normal CP
_ACK_COLUMNS = (2, 3, 8, 9)   # normal CP


def _k_segm(tbs: int) -> int:
    seg = cbsegm(tbs)
    return seg.C_plus * seg.K_plus + seg.C_minus * seg.K_minus


def _qprime_cqi(o: int, l_prb: int, nsymb: int, beta: float, k_segm: int,
                qprime_ri: int) -> int:
    l = 0 if o < 11 else 8
    x = int(np.ceil((o + l) * l_prb * 12 * nsymb * beta / k_segm))
    return min(x, l_prb * 12 * nsymb - qprime_ri)


def _qprime_ri_ack(o: int, l_prb: int, nsymb: int, beta: float, k_segm: int) -> int:
    x = int(np.ceil(o * l_prb * 12 * nsymb * beta / k_segm))
    return min(x, 4 * l_prb * 12)


def _uci_positions(qprime: int, qm: int, rows: int, columns) -> np.ndarray:
    """Bit positions of RI (reserved) or ACK (puncturing) groups — from the
    bottom interleaver row upward over the 4-column set."""
    i = np.arange(qprime)
    row = rows - 1 - i // 4
    col = np.asarray(columns)[(3 * i) % 4]
    base = (col * rows + row) * qm
    return (base[:, None] + np.arange(qm)[None, :]).reshape(-1).astype(np.int32)


@lru_cache(maxsize=64)
def _uci_layout(tbs: int, g: int, qm: int, nsymb: int, l_prb: int,
                n_cqi: int, n_ack: int, n_ri: int,
                i_cqi: int, i_ack: int, i_ri: int):
    """(data_write_positions, cqi_qbits, ri_positions, ack_positions,
    g_data) for one PUSCH+UCI configuration."""
    rows = g // (qm * 12)
    k_segm = _k_segm(tbs)
    qp_ri = _qprime_ri_ack(n_ri, l_prb, nsymb, BETA_RI[i_ri], k_segm) if n_ri else 0
    qp_ack = _qprime_ri_ack(n_ack, l_prb, nsymb, BETA_ACK[i_ack], k_segm) if n_ack else 0
    qp_cqi = _qprime_cqi(n_cqi, l_prb, nsymb, BETA_CQI[i_cqi], k_segm, qp_ri) if n_cqi else 0
    ri_pos = _uci_positions(qp_ri, qm, rows, _RI_COLUMNS)
    ack_pos = _uci_positions(qp_ack, qm, rows, _ACK_COLUMNS)
    # row-major read, column-major write, skipping RI-reserved positions
    j, i, k = np.meshgrid(np.arange(rows), np.arange(12), np.arange(qm), indexing="ij")
    order = ((i * rows + j) * qm + k).reshape(-1)
    reserved = np.zeros(g, bool)
    reserved[ri_pos] = True
    write_pos = order[~reserved[order]]
    g_data = g - qm * (qp_ri + qp_cqi)
    return write_pos.astype(np.int32), qp_cqi * qm, ri_pos, ack_pos, g_data


def _encode_rep(values, nbits: int, qm: int) -> np.ndarray:
    """1..2-bit RI/ACK: Qm-wise repetition blocks (QPSK placeholder form)."""
    v = np.asarray(values, np.uint8)
    reps = nbits // qm
    return np.tile(np.repeat(v[:1] if len(v) == 1 else v[:2][:1], qm), reps)[:nbits]


def _cqi_coded(cqi_bits: tuple, n_bits: int) -> np.ndarray:
    """The CQI's n_bits coded bits: RM(32,O) cyclically extended for up to
    11 payload bits; above, CRC8 + the tail-biting conv code + circular
    rate match (TS 36.212 §5.2.2.6.4)."""
    b = np.asarray(cqi_bits, np.uint8)
    if len(b) > 11:
        coded = convcoder_encode_np(np.concatenate([b, crc_compute_np(b, LTE_CRC8)]))
        return coded.reshape(-1)[conv_rm_indices(coded.shape[-1], n_bits)]
    return rm_encode(b, 32)[np.arange(n_bits) % 32]


def pusch_symbols_data(cell: Cell, shortened: bool = False) -> list[int]:
    """Data-bearing SC-FDMA symbols.  `shortened` drops the last symbol, the
    cell-specific SRS subframe format (TS 36.211 §5.5.3.3)."""
    l_dmrs = dmrs_symbol_in_slot(cell)
    last = cell.nsymb_per_sf - (1 if shortened else 0)
    return [l for l in range(last) if l % cell.nsymb_per_slot != l_dmrs]


def pusch_cinit(rnti: int, sf_idx: int, cell_id: int) -> int:
    return (rnti << 14) + (sf_idx << 9) + cell_id


def pusch_encode_np(cell: Cell, sf_idx: int, grant: UlGrant, tb_bits: np.ndarray,
                    uci: UciCfg | None = None, shortened: bool = False) -> np.ndarray:
    """Host TX: one TB (+ optional UCI) → (nsymb_sf, nre) complex64 grid (UE
    side, 1 antenna)."""
    m_sc = 12 * grant.nof_prb
    data_syms = pusch_symbols_data(cell, shortened)
    g = len(data_syms) * m_sc * grant.qm
    if uci is not None and (uci.cqi_bits or uci.ack or uci.ri):
        write_pos, n_cqi_bits, ri_pos, ack_pos, g_data = _uci_layout(
            grant.tbs, g, grant.qm, len(data_syms), grant.nof_prb,
            len(uci.cqi_bits), len(uci.ack), len(uci.ri),
            uci.i_offset_cqi, uci.i_offset_ack, uci.i_offset_ri)
        data = dlsch_encode_np(tb_bits, TbCoding(tbs=grant.tbs, g=g_data, qm=grant.qm, rv=grant.rv))
        if n_cqi_bits:
            data = np.concatenate([_cqi_coded(tuple(uci.cqi_bits), n_cqi_bits), data])
        inter = np.zeros(g, np.uint8)
        inter[write_pos] = data
        if len(ri_pos):
            inter[ri_pos] = _encode_rep(uci.ri, len(ri_pos), grant.qm)
        if len(ack_pos):  # ACK punctures data
            inter[ack_pos] = _encode_rep(uci.ack, len(ack_pos), grant.qm)
    else:
        coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv)
        bits = dlsch_encode_np(tb_bits, coding)  # UL-SCH is the same chain here
        inter = bits[_interleaver_indices(g, grant.qm)]
    seq = gold_sequence(pusch_cinit(grant.rnti, sf_idx, cell.id), g)
    sym = modulate_np(grant.mod, scramble_bits(inter, seq)).reshape(len(data_syms), m_sc)
    precoded = (sym @ _dft_matrix(m_sc, False)).astype(np.complex64)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    k0 = grant.prb_start * 12
    grid[data_syms, k0 : k0 + m_sc] = precoded
    l_dmrs = dmrs_symbol_in_slot(cell)
    for slot in range(2):
        grid[slot * cell.nsymb_per_slot + l_dmrs, k0 : k0 + m_sc] = pusch_dmrs(
            cell, grant.nof_prb, 0, slot)
    return grid


def _fold_index(n: int) -> np.ndarray:
    """Where each of n RM-coded CQI bits folds in the 32-bit codeword."""
    return np.arange(n) % 32


def _decode_cqi(gl: torch.Tensor, o: int) -> tuple:
    """The CQI payload from its coded LLRs: folded mod 32 and RM(32,O)
    decoded up to 11 bits; above, de-rate-matched on the host, one
    tail-biting Viterbi on the device (d = o + 8) and the CRC8 check — ()
    where it fails."""
    if o > 11:
        d = o + 8
        dllr = conv_rate_match_rx_np(gl.cpu().numpy(), d)
        cb = viterbi_decode(torch.from_numpy(dllr[None]).to(gl.device), d)[0].cpu().numpy()
        if np.array_equal(cb[o:], crc_compute_np(cb[:o], LTE_CRC8)):
            return tuple(int(b) for b in cb[:o])
        return ()
    fold = table(_fold_index, gl.shape[-1], device=gl.device, dtype=torch.int64)
    folded = torch.zeros(32, dtype=torch.float32, device=gl.device).index_add_(0, fold, gl)
    bits, _metric = rm_decode(folded, o)
    return tuple(int(b) for b in bits.cpu().tolist())


def pusch_llr(rx_grid: torch.Tensor, ce: torch.Tensor, noise_est, cell: Cell, sf_idx: int,
              grant: UlGrant, shortened: bool = False) -> torch.Tensor:
    """The PUSCH's descrambled codeword LLRs (g,) on the device of the grid:
    MRC of the (nrx, nsymb, nre) grid with the (nrx, nsymb, 12*nof_prb)
    estimate, IDFT, soft demod, per-symbol CSI weights, descrambling."""
    m_sc = 12 * grant.nof_prb
    k0 = grant.prb_start * 12
    data_syms = pusch_symbols_data(cell, shortened)
    nsym = len(data_syms)
    y = rx_grid[..., data_syms, k0 : k0 + m_sc]  # (nrx, nsym, m_sc)
    h = ce[..., data_syms, :]
    xf, csi = predecode_single_mrc(y.reshape(y.shape[0], -1), h.reshape(h.shape[0], -1), noise_est)
    llr = demod_soft(grant.mod, dft_predecode(xf.reshape(nsym, m_sc)).reshape(-1))
    # the CSI of an SC-FDMA symbol is its mean over the allocation
    csi_t = torch.mean(csi.reshape(nsym, m_sc), dim=-1)
    llr = llr * torch.repeat_interleave(csi_t, m_sc * grant.qm)
    return llr * table(gold_sequence_signs, pusch_cinit(grant.rnti, sf_idx, cell.id), llr.shape[-1],
                       device=llr.device)


def pusch_uci(llr: torch.Tensor, cell: Cell, grant: UlGrant, uci: UciCfg,
              shortened: bool = False) -> tuple[torch.Tensor, TbCoding, dict]:
    """Demultiplex UCI from the codeword LLRs of `pusch_llr`: RI and ACK by
    the sign of the sum over their positions (one read), ACK positions
    punctured to 0, the data gather, the CQI decode.  Returns (the data's
    LLRs, their TbCoding, the UCI dict {"cqi_bits", "ack", "ri"})."""
    dev = llr.device
    nsym = len(pusch_symbols_data(cell, shortened))
    write_pos, n_cqi_bits, ri_pos, ack_pos, g_data = table(
        _uci_layout, grant.tbs, llr.shape[-1], grant.qm, nsym, grant.nof_prb, len(uci.cqi_bits),
        len(uci.ack), len(uci.ri), uci.i_offset_cqi, uci.i_offset_ack, uci.i_offset_ri,
        device=dev, dtype=torch.int64)
    n_cqi_bits = int(n_cqi_bits)
    out = {"cqi_bits": (), "ack": (), "ri": ()}
    sums = torch.stack([llr[pos].sum() for pos in (ri_pos, ack_pos)]).cpu().tolist()
    if ri_pos.numel():
        out["ri"] = tuple([int(sums[0] > 0)] * len(uci.ri))
    if ack_pos.numel():
        out["ack"] = tuple([int(sums[1] > 0)] * len(uci.ack))
        llr = llr.index_fill(0, ack_pos, 0.0)  # punctured data → erasures
    gl = llr[write_pos]
    if n_cqi_bits:
        out["cqi_bits"] = _decode_cqi(gl[:n_cqi_bits], len(uci.cqi_bits))
    return gl[n_cqi_bits:], TbCoding(tbs=grant.tbs, g=int(g_data), qm=grant.qm, rv=grant.rv), out


def pusch_decode(rx_grid, ce, noise_est, cell: Cell, sf_idx: int, grant: UlGrant,
                 max_iterations: int = 5, softbuffers=None, uci: UciCfg | None = None,
                 shortened: bool = False, *, device=None):
    """eNB RX of one PUSCH on `device` (None: the card): (nrx, nsymb, nre)
    grid and the (nrx, nsymb, 12*nof_prb) channel estimate over the
    allocation (numpy or tensors) → (tb_bits, crc_ok, softbuffers), or
    (tb_bits, crc_ok, softbuffers, uci_out) when `uci` gives the expected
    UCI sizes and offsets (its values are ignored); uci_out is the dict
    {"cqi_bits", "ack", "ri"} of decoded values."""
    dev = resolve(device)
    llr = pusch_llr(as_samples(rx_grid, dev), as_samples(ce, dev), noise_est, cell, sf_idx, grant,
                    shortened)
    if uci is None or not (uci.cqi_bits or uci.ack or uci.ri):
        g = llr.shape[-1]
        deint = table(_deinterleaver_indices, g, grant.qm, device=dev, dtype=torch.int64)
        coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv)
        return dlsch_decode(llr[deint], coding, max_iterations, softbuffers)
    data, coding, out = pusch_uci(llr, cell, grant, uci, shortened)
    return (*dlsch_decode(data, coding, max_iterations, softbuffers), out)
