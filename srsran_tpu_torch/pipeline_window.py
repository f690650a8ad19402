"""Windowed dynamic-grant decodes and generators: W TTIs per dispatch.

Counterpart of `srsran_tpu/pipeline_window.py`.  The decode half:
`WindowedUeDl` (port-0 SISO/MRC or transmit-diversity PDSCH),
`WindowedUeDlMimo` (two-codeword spatial multiplexing, the codebook PMIs and
large-delay CDD as data) and `WindowedEnbUl` (multi-UE PUSCH with the
Bluestein IDFT de-precoding).  The per-TTI dynamic decode
(`pipeline_dynamic.py`) launches a few hundred small kernels per grant and
leaves the card idle most of the time; here a **window** of W consecutive
TTIs is decoded by one dispatch, whatever the per-TTI grants are:

* every grant-dependent quantity is data — modulation (the constellations
  present in the window are demodulated, selected per TTI), PRB sets (padded
  RE index vectors), the precoder, the PUSCH allocation's start and width,
  TB layout and redundancy version;
* stage C packs the window's codeblocks densely into N slots (a bucket
  ladder of powers of two and their 1.5x midpoints) instead of a
  (W, codeblocks-per-TB) grid, so one dynamic-K MAP launch per half-iteration
  decodes every codeblock of the window;
* the per-codeblock index work (de-rate-match fill, QPP interleaves, TB
  reassembly) reads window-global layout classes: the distinct (K, F, rv)
  layouts, codeblock sizes and TB sizes of the window each have one host-built
  table that stays on the device, and every slot or row gathers through
  `table[class]`;
* per-TTI constants that repeat across a connection (CRS references per
  subframe index, scrambling signs per (rnti, subframe), RE index vectors
  per PRB set) are cached on the device; besides the samples, a window
  uploads one packed integer parameter vector;
* the whole window returns as one packed uint8 buffer (TB bits packed 8 per
  byte, the CRC flag and the iteration count per row): one device→host read
  per W TTIs.

Latency is traded for sustained throughput, with W as the depth.  Stage keys
are counted as the reference counts its compiled programs: stages A and B
are fixed per engine, stage C is one closure per occupancy bucket
(`WindowPack.key`).

The generate half, payload bits in and baseband out: `WindowedEnbDl` (port-0
PDSCH, optionally with PSS/SSS and a host-rendered control overlay),
`WindowedUeUl` (PUSCH with Bluestein DFT precoding, optionally with PUCCH
blocks) and `WindowedEnbDlMimo` (two codewords, PMIs 0-2 and CDD).  They lay
a window's codeblocks out with the same `pack_window` and share one codeword
core (CRC24A, segmentation, the dynamic-K closed-form turbo encoder, the TX
rate match through each layout class's table, one gather per row codeword),
and return complex64 samples on the device.  `window_channel` puts a flat
channel and noise between a generator and a decode engine on the device, so
a loopback window never brings its baseband to the host.
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache

import numpy as np
import torch

from .device import resolve, sized_table, table
from .parallel.mesh import split_rows
from .phy.chest.chest_dl import ChestDlConfig, _chest_tables, _device_tables
from .phy.chest.chest_ul import dmrs_symbols, time_interp_weights
from .phy.chest.refsignal_dl import put_crs_np
from .phy.common import LTE_CRC24A, LTE_CRC24B, Cell
from .phy.crc import crc_matrix_np, crc_table
from .phy.dft_precoding import dft_bluestein, idft_bluestein
from .phy.fec.cbsegm import cbsegm
from .phy.fec.rate_match_dev import j0_variant_np, ncb_max, qpp_np, tx_table_np
from .phy.fec.turbo import turbo_encode_device_dyn
from .phy.fec.turbo_dyn import crc_ok_ab, crc_table_ab, turbo_decode_dyn
from .phy.mimo import (
    _codebook_2x2,
    predecode_diversity2,
    predecode_single_mrc,
    predecode_zf_mmse,
)
from .phy.modem import Mod, demod_soft, modulate
from .phy.ofdm import OfdmConfig, ofdm_rx_sf, ofdm_tx_sf
from .phy.phch.pdsch import pdsch_cinit
from .phy.phch.pusch import pusch_cinit, pusch_symbols_data
from .phy.phch.sch import FILLER_LLR, TbCoding
from .phy.sequence import gold_sequence, gold_sequence_signs
from .phy.sync.pss import put_pss_grid
from .phy.sync.sss import put_sss_grid
from .pipeline_dynamic import G_MAX, RE_BUCKETS, _box5, _padded_re_indices, _ul_dmrs_conj

K_MAX = 6144
MAX_CB = 16        # most codeblocks per TB (LTE max TBS 97896 at 256QAM → 16)
RE_MAX = RE_BUCKETS[-1]
TBS_MAX = 98304    # >= the largest LTE single-codeword TBS (97896 at 256QAM)
TB_BYTES = TBS_MAX // 8
QMS = (2, 4, 6, 8)
MODS = (Mod.QPSK, Mod.QAM16, Mod.QAM64, Mod.QAM256)
M_MAX = 1200       # most PUSCH allocation subcarriers (100 PRB)

# stage C shape buckets.  The ladders use ~1.33-1.5x steps: the fold, the
# de-rate-match and the reassembly work on the padded sizes.
CLS_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
ECAP_BUCKETS = (16384, 24576, 32768, 49152, 65536, G_MAX)
JFOLD_BUCKETS = (0, 3, 11)  # log2 fold steps: no repetition / <= 8 / <= 2048
TBCAP_BUCKETS = (1200, 4800, 9600, TB_BYTES)  # packed result bytes per row


def _bucket_of(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def _pow2_bucket(n):
    """Slot-count bucket: powers of two plus the 1.5x midpoints (12, 24, 48,
    96, 192, 384, …) — the dense-slot work scales with the bucket, so the
    finer ladder saves up to 25% of padded work per window."""
    b = 8
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


# --------------------------------------------------------------------------
# ingest quantization: int8 SQNR can pinch QAM256 near the waterfall, so
# int16 and float32 ingest are selectable
# --------------------------------------------------------------------------

_INGEST = {"int8": (np.int8, 127.0), "int16": (np.int16, 32767.0),
           "float32": (np.float32, None)}


def _quantize_ingest(samples, ingest: str):
    """samples (W, nrx, sf_len) complex → (quantized (W, nrx, sf_len, 2),
    scale (W,) float32), on the host: the native ADC layout, one scale per
    TTI.

    A complex tensor is the device-resident ingest (baseband that was made
    on the card and never crosses to the host): it passes through with unit
    scales."""
    if isinstance(samples, torch.Tensor):
        if samples.dim() != 3 or not samples.is_complex():
            raise ValueError("device ingest expects a (W, nrx, sf_len) complex tensor")
        return samples, np.ones(samples.shape[0], np.float32)
    w = samples.shape[0]
    if samples.dtype == np.complex64 and samples.flags.c_contiguous:
        sri = samples.view(np.float32).reshape(*samples.shape, 2)  # the same pairs, no copy
    else:
        sri = np.stack([samples.real, samples.imag], axis=-1)
    dt, full = _INGEST[ingest]
    if full is None:
        return sri.astype(np.float32), np.ones(w, np.float32)
    rows = sri.reshape(w, -1)
    peak = np.maximum(np.maximum(rows.max(axis=1), -rows.min(axis=1)), 1e-12)
    scale = (peak / full).astype(np.float32)
    q = sri / scale[:, None, None, None]
    np.clip(np.rint(q, out=q), -full, full, out=q)
    return q.astype(dt), scale


def _dequantize(samples_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(W, nrx, sf_len, 2) quantized samples and (W,) scales on the device →
    (W, nrx, sf_len) complex64; a complex tensor passes through."""
    if samples_q.is_complex():
        return samples_q.to(torch.complex64)
    ri = samples_q.to(torch.float32) * scale[:, None, None, None]
    return torch.view_as_complex(ri.contiguous())


# --------------------------------------------------------------------------
# stages A and B (front end; grant quantities as data)
# --------------------------------------------------------------------------


def _banded_tables(cell: Cell, port: int):
    """The CRS estimate's tables for the window front end: pilot positions,
    the frequency filter as the columns and weights of each output row's
    nonzeros (idx, val (4, nre, J), J the most of any row; zero weights pad,
    in ascending column order) and the time interpolation (nsymb, 4)."""
    syms, freqs, _ref, wf, wt = _device_tables(cell, 0, ChestDlConfig(), port)
    nz = np.abs(wf) > 0
    order = np.argsort(~nz, axis=-1, kind="stable")[..., : int(nz.sum(-1).max())]
    val = np.take_along_axis(wf, order, -1) * np.take_along_axis(nz, order, -1)
    return syms, freqs, order.astype(np.int64), val.astype(np.complex64), wt


def _build_win_a(cell: Cell, nof_ports: int, device):
    """Front end for W subframes: OFDM demod and the CRS channel estimate (1
    or 2 ports), batched over the window.

    The only subframe-dependent input is the conjugated CRS sequence, (W,
    nof_ports, 4, npil) complex64, so one function serves all ten subframe
    indices.  The filters run as elementwise products and sums in a fixed
    order (the frequency filter over its few nonzeros per row), so a row's
    result does not depend on how many rows share the call: a window split
    over devices (`WindowedUeDl._front_sharded`) decodes bit for bit as
    the whole.  Returns (grid (W, nrx, nsymb, nre), ce (W, nrx, nof_ports,
    nsymb, nre), noise (W,))."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    tabs = [table(_banded_tables, cell, p, device=device) for p in range(nof_ports)]

    def fn(samples_q, scale, ref_conj):
        grid = ofdm_rx_sf(ofdm, _dequantize(samples_q, scale))
        ces, noise = [], 0.0
        for p, (syms, freqs, idx, val, wt) in enumerate(tabs):
            ls = grid[..., syms, freqs] * ref_conj[:, None, p]  # (W, nrx, 4, npil)
            taps = torch.gather(ls, -1, idx.reshape(4, -1).expand(ls.shape[:-1] + (-1,)))
            taps = taps.reshape(ls.shape[:-1] + idx.shape[1:])  # (W, nrx, 4, nre, J)
            per_sym = taps[..., 0] * val[..., 0]
            for j in range(1, idx.shape[-1]):
                per_sym = per_sym + taps[..., j] * val[..., j]
            ce = wt[:, 0, None] * per_sym[..., 0, None, :]
            for k in range(1, wt.shape[1]):
                ce = ce + wt[:, k, None] * per_sym[..., k, None, :]
            ces.append(ce)
            resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
            noise = noise + torch.mean(resid.abs() ** 2, dim=(1, 2, 3)) / 1.5
        return grid, torch.stack(ces, dim=2).to(torch.complex64), noise / nof_ports

    return fn


def _gather_re_classes(grid, ce, idx_cls, cls_re):
    """The window's RE gather: every TTI takes one of the distinct (subframe,
    PRB set) index vectors of the window, `idx_cls[cls_re]`, and one gather
    each reads the symbols and the channel.  Returns (y (W, nrx, RE_MAX),
    h (W, nrx, P, RE_MAX))."""
    w, nrx, p = ce.shape[:3]
    idx = idx_cls[cls_re]  # (W, RE_MAX)
    r = idx.shape[1]
    y = torch.gather(grid.reshape(w, nrx, -1), 2, idx[:, None, :].expand(w, nrx, r))
    h = torch.gather(ce.reshape(w, nrx, p, -1), 3, idx[:, None, None, :].expand(w, nrx, p, r))
    return y, h


def _demod_select(x, csi, qm, n_bits, signs, qms):
    """Soft demod of (R, M) symbols with each row's own constellation: the
    constellations present in the window (`qms`) are demodulated for every
    row and each row keeps the one its Qm (`qm`, (R,)) names.  csi: (R, M)
    weights; signs: (R, G_MAX) descrambling signs or None; n_bits: (R,) true
    lengths.  Returns (R, G_MAX) LLRs, zero from n_bits on."""
    width = x.shape[1]
    llr = x.new_zeros((x.shape[0], G_MAX), dtype=torch.float32)
    for mod_c, qm_c in zip(MODS, QMS):
        if qm_c not in qms:
            continue
        lc = demod_soft(mod_c, x) * torch.repeat_interleave(csi, qm_c, dim=-1)
        head = llr[:, : width * qm_c]
        llr[:, : width * qm_c] = torch.where((qm == qm_c)[:, None], lc, head)
    if signs is not None:
        llr = llr * signs.to(torch.float32)
    mask = torch.arange(G_MAX, device=x.device)[None, :] < n_bits[:, None]
    return torch.where(mask, llr, 0.0)


def _build_win_b(scheme: str, qms: tuple = tuple(QMS)):
    """Grant front end for W TTIs: RE gather → equalize (port-0 MRC or SFBC
    combining) → demod → CSI weight → descramble.  Emits (W, G_MAX) masked
    LLRs."""

    def fn(grid, ce, noise, idx_cls, cls_re, n_re, qm, signs):
        y, h = _gather_re_classes(grid, ce, idx_cls, cls_re)
        if scheme == "diversity":
            x, csi = predecode_diversity2(y, h)
        else:
            x, csi = predecode_single_mrc(y, h[:, :, 0], noise[:, None])
        return _demod_select(x, csi, qm, n_re * qm, signs, qms)

    return fn


def _precoder_table() -> np.ndarray:
    """(4, 2, 2, 2) complex64 precoders [pmi, RE parity, port, layer]: the
    three two-layer codebook entries (the same at both parities) and, as
    pmi 3, large-delay CDD W·D(i)·U, whose second port flips sign on odd REs."""
    u_cdd = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
    s2 = np.float32(1.0 / np.sqrt(2.0))
    out = np.zeros((4, 2, 2, 2), np.complex64)
    for pmi in range(3):
        out[pmi] = _codebook_2x2(pmi, 2)[None]
    for par, sign in enumerate((1.0, -1.0)):
        out[3, par, 0] = u_cdd[0] * s2
        out[3, par, 1] = u_cdd[1] * s2 * np.float32(sign)
    return out


def _build_win_b_mimo(qms: tuple = tuple(QMS)):
    """Spatial-multiplexing grant front end for W TTIs: RE gather → fold each
    TTI's precoder into H (the precoder of a TTI is `codebook[pmi]`, a 2x2
    matrix per RE parity) → one joint 2x2 MMSE solve → layer demap →
    per-codeword demod and descramble.  Emits (W, 2, G_MAX) masked LLRs."""

    def fn(grid, ce, noise, idx_cls, cls_re, n_re, qm1, qm2, pmi, signs1, signs2):
        y, h = _gather_re_classes(grid, ce, idx_cls, cls_re)
        w, nrx, m = h.shape[0], h.shape[1], h.shape[-1]
        c = table(_precoder_table, device=h.device)[pmi]  # (W, parity, port, layer)
        hp = h.reshape(w, nrx, 2, 1, m // 2, 2)  # (W, nrx, port, 1, M/2, parity)
        cw = c.permute(0, 2, 3, 1)[:, None, :, :, None, :]  # (W, 1, port, layer, 1, parity)
        heff = (hp[:, :, 0] * cw[:, :, 0] + hp[:, :, 1] * cw[:, :, 1]).reshape(w, nrx, 2, m)
        x, csi = predecode_zf_mmse(y, heff, 2, noise[:, None], pmi=None)
        return torch.stack([
            _demod_select(x[:, 0], csi[:, 0], qm1, n_re * qm1, signs1, qms),
            _demod_select(x[:, 1], csi[:, 1], qm2, n_re * qm2, signs2, qms),
        ], dim=1)

    return fn


def _build_win_a_ul(cell: Cell):
    """SC-FDMA demod for W subframes (grant independent): the grid (W, nrx,
    nsymb, nre)."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    return lambda samples_q, scale: ofdm_rx_sf(ofdm, _dequantize(samples_q, scale))


def _build_win_b_ul(cell: Cell, qms: tuple, device):
    """PUSCH grant front end for W TTIs, every grant quantity data: the
    allocation's columns (a clipped gather from k0), the DMRS channel
    estimate with a masked 5-tap smoothing, MRC, the Bluestein IDFT
    de-precoding (the transform length is data), demod over the padded
    (symbol, M_MAX) layout, then one composed gather per (m_sc, Qm) class
    that compacts the padded layout to transmit order, applies the
    descrambling signs and undoes the channel interleaver (TS 36.212
    §5.2.2.8).  Emits (W, G_MAX) LLRs."""
    dmrs_syms = list(dmrs_symbols(cell))
    data_syms = list(pusch_symbols_data(cell))
    nsym = len(data_syms)
    t_data = torch.from_numpy(time_interp_weights(cell)[data_syms].astype(np.complex64)).to(device)
    pos = torch.arange(M_MAX, device=device)

    def fn(grid, k0, m_sc, qm, dmrs_conj, signs, tab_llr, tab_sig, cls_il):
        w, nrx, nsymb, nre = grid.shape
        col = k0[:, None] + pos  # (W, M_MAX); columns past the band read zero
        alloc = torch.gather(grid, 3, col.clamp(max=nre - 1)[:, None, None, :]
                             .expand(w, nrx, nsymb, M_MAX))
        alloc = torch.where((col < nre)[:, None, None, :], alloc, 0.0)
        m_mask = pos[None, :] < m_sc[:, None]  # (W, M_MAX)
        mm = m_mask[:, None, None, :]
        m_f = m_sc.to(torch.float32)
        # --- channel estimate: LS at DMRS, masked 5-tap smoothing, time interp ---
        ls = torch.where(mm, alloc[:, :, dmrs_syms, :] * dmrs_conj[:, None], 0.0)
        wsum = _box5(m_mask.to(torch.float32))
        sm = torch.where(mm, _box5(ls) / wsum.clamp(min=1.0)[:, None, None, :], 0.0)
        resid = torch.where(mm, ls - sm, 0.0)
        noise = torch.sum(resid.abs() ** 2, dim=(1, 2, 3)) / (2.0 * nrx * m_f).clamp(min=1.0)
        ce = torch.einsum("ls,wrsn->wrln", t_data, sm)  # (W, nrx, nsym, M_MAX)
        # --- MRC equalize over rx antennas ---
        yd = alloc[:, :, data_syms, :]
        num = torch.sum(yd * torch.conj(ce), dim=1)
        den = torch.sum(ce.abs() ** 2, dim=1) + noise[:, None, None]
        xf = torch.where(m_mask[:, None], num / den, 0.0)  # (W, nsym, M_MAX)
        csi = torch.where(m_mask[:, None], den, 0.0)
        x = idft_bluestein(xf, m_sc[:, None])
        csi_t = torch.sum(csi, dim=-1, keepdim=True) / m_f.clamp(min=1.0)[:, None, None]
        wcsi = csi_t.expand(w, nsym, M_MAX).reshape(w, -1)
        # every constellation of the window over the padded layout, selected by Qm
        llr_pad = _demod_select(x.reshape(w, -1), wcsi, qm, qm.new_full((w,), G_MAX), None, qms)
        lp = torch.cat([llr_pad, llr_pad.new_zeros((w, 1))], dim=1)
        sg = torch.cat([signs.to(torch.float32), llr_pad.new_zeros((w, 1))], dim=1)
        return torch.gather(lp, 1, tab_llr[cls_il]) * torch.gather(sg, 1, tab_sig[cls_il])

    return fn


def _ul_compose_tabs(m_sc: int, qm: int, nsym: int):
    """Composed class tables of one (m_sc, Qm) class: natural position j
    reads the padded-layout LLR tab_llr[j] (the zero slot G_MAX beyond the
    codeword) and the transmit-order scrambling sign tab_sig[j] — the
    §5.2.2.8 de-interleave and the padded→transmit compaction as one gather
    each.  Two (G_MAX,) int32 arrays."""
    g_len = nsym * m_sc * qm
    j = np.arange(G_MAX, dtype=np.int64)
    q = j % qm
    t2 = j // qm
    c2 = t2 % nsym
    r2 = t2 // nsym
    tab_llr = np.where(j < g_len, c2 * (M_MAX * qm) + r2 * qm + q, G_MAX)
    tab_sig = np.where(j < g_len, c2 * (m_sc * qm) + r2 * qm + q, G_MAX)
    return tab_llr.astype(np.int32), tab_sig.astype(np.int32)


def _win_ul_dmrs(cell: Cell, nof_prb: int) -> np.ndarray:
    """Conjugated PUSCH DMRS of both slots, zero beyond the allocation:
    (2, M_MAX) complex64."""
    return _ul_dmrs_conj(cell, nof_prb, M_MAX)


# --------------------------------------------------------------------------
# stage C: dense-slot TB decode, window-global layout classes
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WindowPack:
    """Host-side dense-slot layout of one window's codeblocks."""

    key: tuple                  # shape key of the stage C function
    params: np.ndarray          # one packed int32 vector (a single upload)
    row_start: list             # per row: first slot index
    row_ncb: list               # per row: codeblock count
    tbs: list                   # per row: TB size
    fill_classes: list          # distinct (k, f, rv) layouts, table order
    qpp_classes: list           # distinct k values, table order
    tb_classes: list            # distinct TB sizes, table order


def pack_window(row_specs) -> WindowPack:
    """Lay out a window's codeblocks densely.

    row_specs: per codeword row (tbs, g, qm, rv) — g the codeword length in
    bits.  Returns the packed parameter vector and the bucket key (n_rows,
    n_slots, ncls_q, ncls_f, e_cap, j_fold, tb_cap, ncls_t, d_total).  The
    per-class de-rate-match, QPP and reassembly index tables are not in the
    parameters: they depend only on (k, f, rv), k or the TB size and stay on
    the device (`class_tables`)."""
    slots = []           # (row, off, e, k, f, crcb, cls_f, cls_q, nv)
    fill_cls: dict = {}  # (k, f, rv) -> id
    qpp_cls: dict = {}   # k -> id
    row_start, row_ncb, row_tbs = [], [], []
    max_e, max_rep = 1, 1
    for r, (tbs, g, qm, rv) in enumerate(row_specs):
        blocks = TbCoding(tbs, g, qm).blocks
        if len(blocks) > MAX_CB:
            raise ValueError(f"tbs {tbs} has {len(blocks)} codeblocks, more than {MAX_CB}")
        row_start.append(len(slots))
        row_ncb.append(len(blocks))
        row_tbs.append(tbs)
        for blk in blocks:
            fc = fill_cls.setdefault((blk.k, blk.f, rv), len(fill_cls))
            qc = qpp_cls.setdefault(blk.k, len(qpp_cls))
            nv = 3 * (blk.k + 4) - 2 * blk.f
            slots.append((r, blk.off, blk.e, blk.k, blk.f, int(blk.crc > 0), fc, qc, nv))
            max_e = max(max_e, blk.e)
            max_rep = max(max_rep, -(-blk.e // nv))

    n_rows = len(row_specs)
    tb_cls: dict = {}
    cls_tb = np.zeros(n_rows, np.int32)
    for r, tbs_r in enumerate(row_tbs):
        cls_tb[r] = tb_cls.setdefault(tbs_r, len(tb_cls))
    n_slots = _pow2_bucket(max(len(slots), 1))
    ncls_q = _bucket_of(len(qpp_cls), CLS_BUCKETS)
    ncls_f = _bucket_of(len(fill_cls), CLS_BUCKETS)
    ncls_t = _bucket_of(len(tb_cls), CLS_BUCKETS)
    e_cap = _bucket_of(max_e, ECAP_BUCKETS)
    j_fold = _bucket_of((max_rep - 1).bit_length(), JFOLD_BUCKETS)
    tb_cap = _bucket_of(-(-max(row_tbs) // 8), TBCAP_BUCKETS)
    # size of the dense packed result: each row contributes its own TB bytes
    # and 2 status bytes.  A pure power-of-two ladder with a 2 KB floor: the
    # bucket is part of the stage C key, so it stays coarse under live
    # traffic, where a window's sum of TB sizes wanders.
    d_total = max(2048, 1 << (sum(t // 8 + 2 for t in row_tbs) - 1).bit_length())

    p = np.zeros(8 * n_slots + 4 * n_rows, np.int32)
    sl = np.array(slots, np.int32).reshape(-1, 9)
    n = len(slots)
    p[0:n_slots][:n] = sl[:, 0] * G_MAX + sl[:, 1]     # flat llr offset
    p[1 * n_slots:2 * n_slots][:n] = sl[:, 2]          # e (0 = unused pad)
    p[2 * n_slots:3 * n_slots] = 40
    p[2 * n_slots:3 * n_slots][:n] = sl[:, 3]          # k
    p[3 * n_slots:4 * n_slots][:n] = sl[:, 4]          # f
    p[4 * n_slots:5 * n_slots][:n] = sl[:, 5]          # crcb
    p[5 * n_slots:6 * n_slots][:n] = sl[:, 6]          # cls_f
    p[6 * n_slots:7 * n_slots][:n] = sl[:, 7]          # cls_q
    p[7 * n_slots:8 * n_slots] = 1
    p[7 * n_slots:8 * n_slots][:n] = sl[:, 8]          # n_valid
    o = 8 * n_slots
    p[o:o + n_rows] = row_tbs
    p[o + n_rows:o + 2 * n_rows] = row_ncb
    p[o + 2 * n_rows:o + 3 * n_rows] = row_start
    p[o + 3 * n_rows:o + 4 * n_rows] = cls_tb

    return WindowPack(
        key=(n_rows, n_slots, ncls_q, ncls_f, e_cap, j_fold, tb_cap, ncls_t, d_total),
        params=p, row_start=row_start, row_ncb=row_ncb, tbs=row_tbs,
        fill_classes=list(fill_cls), qpp_classes=list(qpp_cls), tb_classes=list(tb_cls))


# Device-table cache budgets: the tables are cheap to rebuild on the host, so
# the caches hold one busy cell's working set, not every (k, f, rv) or TBS
# ever seen.  As int64 gather indices: 512 x 148 KB (j0), 512 x 2 x 49 KB
# (QPP), 128 x 787 KB (TB reassembly).


def _j0_table(k: int, f: int, rv: int) -> np.ndarray:
    """De-rate-match index table (3*(K_MAX+4),) of one layout class."""
    return j0_variant_np(k, f, rv, K_MAX)[0]


def _qpp_table(k: int):
    return qpp_np(k, K_MAX)


def _tb_gather_dev(tbs: int) -> np.ndarray:
    """Reassembly gather table of one TB size: for each bit of the
    right-aligned TB||CRC stream (TBS_MAX+24,) the local source index into
    the row's contiguous slot region (MAX_CB*K_MAX bits; the pad reads the
    zero slot MAX_CB*K_MAX).  int32, on the host."""
    idx = np.full(TBS_MAX + 24, MAX_CB * K_MAX, np.int32)
    u0 = TBS_MAX + 24 - (tbs + 24)
    for c, blk in enumerate(cbsegm(tbs).blocks):
        u = np.arange(blk.msg)
        idx[u0 + blk.pos + u] = c * K_MAX + blk.f + u
    return idx


_j0_tables = sized_table(512)
_qpp_tables = sized_table(512)
_tb_tables = sized_table(128)


def class_tables(pack: WindowPack, device):
    """The window's per-class tables, stacked on `device` from the cached
    rows, int64: (j0_tab (CF, 3*(K_MAX+4)), perq (CQ, K_MAX), invq (CQ,
    K_MAX), tb_tab (CT, tb_cap*8 + 24)).  Unused class rows repeat the first.
    The TB stream is right-aligned, so only its trailing tb_cap*8 + 24 bits
    can be other than pad for any row of this window: the reassembly tables
    are cropped to that width."""
    cq, cf, tb_cap, ct = pack.key[2], pack.key[3], pack.key[6], pack.key[7]
    kw = dict(device=device, dtype=torch.int64)
    f_rows = [_j0_tables(_j0_table, *c, **kw) for c in pack.fill_classes]
    q = [_qpp_tables(_qpp_table, k, **kw) for k in pack.qpp_classes]
    p_rows, i_rows = [a for a, _ in q], [b for _, b in q]
    crop = TBS_MAX - tb_cap * 8
    t_rows = [_tb_tables(_tb_gather_dev, t, **kw)[crop:] for t in pack.tb_classes]

    def stack(rows, n):
        return torch.stack(rows + [rows[0]] * (n - len(rows)))

    return stack(f_rows, cf), stack(p_rows, cq), stack(i_rows, cq), stack(t_rows, ct)


def _tb_crc_table(sw: int) -> np.ndarray:
    return crc_matrix_np(LTE_CRC24A, sw).astype(np.float32)


@lru_cache(maxsize=256)
def _build_win_c(n_rows: int, n_slots: int, ncls_q: int, ncls_f: int, e_cap: int,
                 j_fold: int, tb_cap: int, ncls_t: int, d_total: int,
                 max_iterations: int, device):
    """Dense-slot TB decode: fold each slot's codeword segment onto its
    circular positions (log-halving, so any repetition count takes j_fold
    steps), de-rate-match by one gather through the slot's class table (HARQ
    += into the softbuffer), dynamic-K turbo over the N dense slots with the
    window's class QPP tables, codeblock and TB CRCs, per-row reassembly →
    one dense packed result buffer (d_total + tb_cap + 2,) uint8 in which row
    r occupies [off_r, off_r + tbs_r/8 + 2) as [tb bytes | ok | n_it].

    fn(llr (R, G_MAX), params (8N + 4R,) integer, j0_tab, perq, invq, tb_tab,
    softbuffer (N, 3, K_MAX+4)) → (packed, new softbuffer)."""
    crc_ab = table(crc_table_ab, K_MAX, device=device)
    # TB stream width bucketed to the window's largest TB (a CRC with zero
    # initial value ignores leading zeros, so the matrix is exact at any
    # width >= tbs)
    sw = tb_cap * 8
    tb_table = table(_tb_crc_table, sw, device=device)
    pow2 = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=device)
    NCB = ncb_max(K_MAX)
    D = K_MAX + 4
    N, R = n_slots, n_rows
    pos_e = torch.arange(e_cap, device=device)[None, :]
    pos_d = torch.arange(D, device=device)[None, :]
    cb_idx = torch.arange(MAX_CB, device=device)[None, :]
    dense_pos = torch.arange(d_total + tb_cap + 2, device=device)
    dump = MAX_CB * K_MAX

    def fn(llr, params, j0_tab, perq, invq, tb_tab, softbuffer):
        params = params.to(torch.int64)
        s_off, s_e, s_k, s_f, s_crcb, s_clsf, s_clsq, nv = params[: 8 * N].reshape(8, N)
        row_tbs, row_ncb, row_start, cls_tb = params[8 * N :].reshape(4, R)
        valid = s_e > 0

        # --- fold codeword segments onto circular positions: slot n reads
        # e_cap LLRs from its offset (masked to its own e), then block b +=
        # block b + 2^j (blocks of nv) for j = j_fold-1 … 0.  Folded values
        # beyond e stay zero, so only the head ever updates; a shifted read
        # past e_cap reads zero. ---
        llr_flat = llr.reshape(-1)
        src = (s_off[:, None] + pos_e).clamp(max=llr_flat.shape[0] - 1)
        seg = torch.where(pos_e < s_e[:, None], llr_flat[src], 0.0)  # (N, e_cap)
        m = (s_e + nv - 1) // nv.clamp(min=1)
        for j in range(j_fold - 1, -1, -1):
            sh_pos = pos_e + ((1 << j) * nv)[:, None]
            sh = torch.where(sh_pos < e_cap,
                             torch.gather(seg, 1, sh_pos.clamp(max=e_cap - 1)), 0.0)
            seg = torch.where((m > (1 << j))[:, None], seg + sh, seg)
            m = m.clamp(max=1 << j)
        # (N, NCB + 1): the last column is the zero slot the tables dump to
        acc = torch.cat([seg[:, :NCB], seg.new_zeros((N, NCB + 1 - min(e_cap, NCB)))], dim=1)

        # --- de-rate-match through the slot's class table; HARQ combine ---
        fill = torch.gather(acc, 1, j0_tab[s_clsf])
        fill = torch.where(valid[:, None], fill, 0.0)
        new_soft = softbuffer + fill.reshape(N, 3, D)

        # the decoder sees filler bits (known 0) pinned in the systematic
        # stream; the softbuffer handed back is the un-pinned sum
        d = new_soft.clone()
        d[:, 0, :] = torch.where(pos_d < s_f[:, None], float(FILLER_LLR), d[:, 0, :])

        # --- dynamic-K turbo with the window's class QPP tables ---
        bf = s_crcb > 0
        bits, _post, it_vec = turbo_decode_dyn(
            d, s_k, None, None, valid, K_MAX, max_iterations,
            crc_table=crc_ab, crc_is_b=bf, class_perms=(perq, invq, s_clsq))
        cb_ok = crc_ok_ab(bits, s_k, crc_ab, bf)

        # --- per-row reassembly through the row's TB-size table: a local
        # index into the row's slot region, the pad reading zero ---
        local = tb_tab[cls_tb]  # (R, sw + 24)
        flat = (row_start[:, None] * K_MAX + local).clamp(max=N * K_MAX - 1)
        stream = torch.where(local < dump, bits.reshape(-1)[flat], 0)
        tbp, rx_crc = stream[:, :sw], stream[:, sw:]
        # per-row codeblock verdicts and iteration counts
        sidx = (row_start[:, None] + cb_idx).clamp(max=N - 1)  # (R, MAX_CB)
        in_row = cb_idx < row_ncb[:, None]
        row_cb_ok = (cb_ok[sidx] | ~in_row).all(dim=1)
        row_it = torch.where(in_row, it_vec[sidx], 0).amax(dim=1)
        crc_calc = (torch.matmul(tbp.to(torch.float32), tb_table).to(torch.int32) & 1
                    ).to(torch.uint8)
        tb_ok = row_cb_ok & (crc_calc == rx_crc).all(dim=1)
        tb_bytes = (tbp.reshape(R, tb_cap, 8).to(torch.int32) * pow2).sum(dim=-1).to(torch.uint8)
        rows = torch.cat([tb_bytes, tb_ok.to(torch.uint8)[:, None],
                          row_it.clamp(0, 255).to(torch.uint8)[:, None]], dim=1)
        # dense pack: row r's own block is the trailing tbs/8 + 2 bytes of
        # rows[r]; dense position p belongs to the row whose cumulative range
        # holds it and reads that block's byte, zero past the last row
        nb = row_tbs // 8 + 2
        ends = torch.cumsum(nb, dim=0)
        r_of = torch.bucketize(dense_pos, ends, right=True).clamp(max=R - 1)
        src_col = dense_pos - ends[r_of] + (tb_cap + 2)
        dense = torch.where(dense_pos < ends[-1],
                            rows.reshape(-1)[r_of * (tb_cap + 2) + src_col.clamp(0, tb_cap + 1)], 0)
        return dense, new_soft

    return fn


# --------------------------------------------------------------------------
# softbuffer routing (dense slots)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PendingWindow:
    """A dispatched window (device tensors); realize with `results`."""

    # dense 1-D (d_total + tb_cap + 2,) uint8 buffer: row r's block lives at
    # its cumulative offset as [tbs/8 tb bytes | ok | n_it]
    packed: torch.Tensor
    softbuffer: torch.Tensor  # (n_slots, 3, K_MAX + 4) dense slot layout
    tbs: list                 # per-row true TB sizes
    pack: WindowPack | None = None


def extract_softbuffer(p: PendingWindow, row: int) -> torch.Tensor:
    """The softbuffer block of window row `row` on the device (MAX_CB slots,
    the tail beyond the row's codeblocks zero), for the HARQ carry into a
    later window at any position — retransmissions rarely land in the same
    window slot."""
    st, n_cb = p.pack.row_start[row], p.pack.row_ncb[row]
    blk = p.softbuffer.new_zeros((MAX_CB,) + tuple(p.softbuffer.shape[1:]))
    blk[:n_cb] = p.softbuffer[st : st + n_cb]
    return blk


def make_softbuffer(entries):
    """Per-row softbuffer carry list (None = fresh).  The dense slot layout
    is only known at dispatch time, so this returns the entries for
    `dispatch_window` to place at the new window's slot offsets."""
    return list(entries)


def _assemble_soft(softbuffer, pack: WindowPack, n_slots: int, device):
    """Resolve the softbuffer argument into a dense (N, 3, D) tensor."""
    if softbuffer is None:
        return torch.zeros((n_slots, 3, K_MAX + 4), dtype=torch.float32, device=device)
    if isinstance(softbuffer, (list, tuple)):
        soft = torch.zeros((n_slots + MAX_CB, 3, K_MAX + 4), dtype=torch.float32, device=device)
        for r, blk in enumerate(softbuffer):
            if blk is not None:
                st = pack.row_start[r]
                soft[st : st + MAX_CB] = blk.to(device)
        return soft[:n_slots]
    if softbuffer.shape[0] != n_slots:
        raise ValueError("a dense softbuffer carry needs the same window codeblock layout; "
                         "use make_softbuffer/extract_softbuffer to route per row")
    if softbuffer.device != device:
        raise ValueError(f"softbuffer is on {softbuffer.device}, expected {device}")
    return softbuffer


# --------------------------------------------------------------------------
# facades
# --------------------------------------------------------------------------


def _signs_np(cinit: int) -> np.ndarray:
    return gold_sequence_signs(cinit, G_MAX).astype(np.int8)


def _re_idx_full(cell: Cell, sf_idx: int, cfi: int, prb: tuple) -> np.ndarray:
    """The PDSCH RE indices of a PRB set, zero-padded to (RE_MAX,) int64."""
    full = np.zeros(RE_MAX, np.int64)
    pad = _padded_re_indices(cell, sf_idx, cfi, prb)[0]
    full[: len(pad)] = pad
    return full


def _ref_conj_np(cell: Cell, sf_idx: int, nof_ports: int) -> np.ndarray:
    """Conjugated CRS of a subframe index, (nof_ports, 4, npil) complex64."""
    return np.stack([_chest_tables(cell, sf_idx, ChestDlConfig(), p)[2]
                     for p in range(nof_ports)]).astype(np.complex64)


def _stage_times(stages, device, n: int) -> dict:
    """Seconds per stage of a staged plan: each stage runs once warm, then
    n times on the previous stage's output, between two CUDA events on a
    card (the host clock on the CPU)."""
    cuda = device.type == "cuda"
    times = {}
    prev = None
    for name, fn in stages:
        r = fn(prev)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(n):
            r = fn(prev)
        if cuda:
            end.record()
            end.synchronize()
            times[name] = start.elapsed_time(end) * 1e-3 / n
        else:
            times[name] = (time.perf_counter() - t0) / n
        prev = r
    return times


class _WindowedDecoder:
    """What the three windowed decoders share: the device, the staged plan's
    run, the packed result's walk, the stage times and the counters.  A
    subclass builds the plan (`_plan`): an ordered (name, fn) chain in which
    each fn takes the previous stage's output, and the window's pack."""

    _SHARDS = False  # whether dispatch_window takes a sharding

    def __init__(self, cell: Cell, w: int, max_iterations: int, ingest: str, device):
        if ingest not in _INGEST:
            raise ValueError(f"ingest {ingest!r} is not one of {tuple(_INGEST)}")
        self.cell = cell
        self.w = w
        self.ingest = ingest
        self.max_iterations = max_iterations
        self.device = resolve(device)
        self._b_cache: dict = {}
        self.stats = {"windows": 0, "ttis": 0, "crc_ok": 0}

    def _c_for(self, key):
        return _build_win_c(*key, self.max_iterations, self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload(self, samples):
        """(quantized samples, scales) of a window on the device."""
        samples_q, scale = _quantize_ingest(samples, self.ingest)
        if isinstance(samples_q, torch.Tensor):
            if samples_q.device != self.device:
                raise ValueError(f"samples are on {samples_q.device}, expected {self.device}")
            return samples_q, self._dev(scale)
        return self._dev(samples_q), self._dev(scale)

    def _check(self, sf_indices, grants, sharding=None):
        if sharding is not None and not self._SHARDS:
            raise NotImplementedError(
                f"{type(self).__name__} does not shard its window axis over devices")
        if len(sf_indices) != self.w or len(grants) != self.w:
            raise ValueError(f"a window takes {self.w} subframe indices and grants, got "
                             f"{len(sf_indices)} and {len(grants)}")

    def _run(self, stages, pack) -> PendingWindow:
        out = None
        for _name, fn in stages:
            out = fn(out)
        packed, new_soft = out
        return PendingWindow(packed, new_soft, pack.tbs, pack)

    def dispatch_window(self, samples, sf_indices, grants, softbuffer=None,
                        sharding=None) -> PendingWindow:
        """samples: (W, nrx, sf_len) complex64 (numpy, or a complex tensor on
        this object's device); sf_indices, grants: length-W lists.  Results
        stay on the device until `results`.  softbuffer: None, the dense
        softbuffer of an earlier window with the same codeblock layout, or a
        `make_softbuffer` list.  sharding: None (this object's device), or a
        `parallel.mesh.NamedSharding` whose leading axis splits the W rows
        over its positions for stage A (`WindowedUeDl`)."""
        self._check(sf_indices, grants, sharding)
        return self._run(*self._plan(samples, sf_indices, grants, softbuffer, sharding=sharding))

    def dispatch_window_from(self, abc, sf_indices, grants, softbuffer=None) -> PendingWindow:
        """Decode a window of grants from a stored front-end pass over the
        same W TTIs: `abc` is what stage A returns (complex tensors on this
        object's device), stage A is skipped, so each subframe is uploaded
        and FFT'd once for the control and the data pass."""
        self._check(sf_indices, grants)
        return self._run(*self._plan(None, sf_indices, grants, softbuffer, abc=abc))

    def stage_times(self, samples, sf_indices, grants, n: int = 10):
        """Seconds per stage for one window through the same plan
        `dispatch_window` runs: n runs of each stage after one warm run,
        between two CUDA events on a card (the host clock on the CPU).
        Stage C's host loop reads `done.all()` once per iteration, so its
        time holds those waits, as in a dispatch."""
        self._check(sf_indices, grants)
        return _stage_times(self._plan(samples, sf_indices, grants)[0], self.device, n)

    def _rows(self, p: PendingWindow):
        """One read of the dense buffer → [(tb bits, ok, n_it)] per row: row
        r's block at its cumulative offset is [tbs/8 tb bytes | ok | n_it]."""
        res = p.packed.cpu().numpy()
        out = []
        off = 0
        for tbs in p.tbs:
            nb = tbs // 8
            out.append((np.unpackbits(res[off:off + nb]), bool(res[off + nb]),
                        int(res[off + nb + 1])))
            off += nb + 2
        return out

    def results(self, p: PendingWindow):
        """Realize a window: one device→host read; returns [(tb, ok, n_it)]
        * W.  n_it is the largest turbo-iteration count over the TTI's own
        codeblocks."""
        out = self._rows(p)
        self.stats["ttis"] += len(out)
        self.stats["crc_ok"] += sum(ok for _tb, ok, _n in out)
        self.stats["windows"] += 1
        return out

    def decode_window(self, samples, sf_indices, grants, softbuffer=None):
        p = self.dispatch_window(samples, sf_indices, grants, softbuffer)
        return self.results(p), p.softbuffer


class WindowedUeDl(_WindowedDecoder):
    """Decode any W-TTI mix of port-0 (or, with scheme="diversity",
    transmit-diversity) PDSCH grants per dispatch.

    `decode_window` is the synchronous form; `dispatch_window`/`results`
    keep several windows in flight.  `device=None` means the first CUDA
    device (and raises when there is none); the tests pass "cpu"."""

    _SCHEMES = ("port0", "diversity")
    _SHARDS = True

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32, max_iterations: int = 5,
                 scheme: str = "port0", ingest: str = "int8", *, device=None):
        if scheme not in self._SCHEMES:
            raise ValueError(f"scheme {scheme!r} is not one of {self._SCHEMES}")
        super().__init__(cell, w, max_iterations, ingest, device)
        self.cfi = cfi
        self.scheme = scheme
        self.nof_ports = 1 if scheme == "port0" else 2
        self._a = _build_win_a(cell, self.nof_ports, self.device)
        self._a_on = {self.device: self._a}  # stage A per position device

    def _b_for(self, qms: tuple):
        # keyed on the window's Qm set: a uniform window demodulates once
        if qms not in self._b_cache:
            self._b_cache[qms] = _build_win_b(self.scheme, qms)
        return self._b_cache[qms]

    # -- cached device constants --
    def _ref(self, sf_idx: int):
        return table(_ref_conj_np, self.cell, sf_idx, self.nof_ports, device=self.device)

    def _idx(self, sf_idx: int, prb: tuple):
        """((RE_MAX,) padded RE index vector on the device, n_re)."""
        key = (self.cell, sf_idx, self.cfi, prb)
        return table(_re_idx_full, *key, device=self.device), _padded_re_indices(*key)[1]

    def _signs(self, rnti: int, sf_idx: int, q: int = 0):
        return table(_signs_np, pdsch_cinit(rnti, sf_idx, self.cell.id, q=q), device=self.device)

    def _re_classes(self, sf_indices, grants):
        """Distinct (subframe, PRB set) classes of the window → (stacked
        index table (NCLS, RE_MAX) on the device, per-TTI class vector, n_re
        per TTI)."""
        keys: dict = {}
        cls_re = np.zeros(len(grants), np.int32)
        n_re = []
        for i, (s, g) in enumerate(zip(sf_indices, grants)):
            k = (s, tuple(g.prb))
            cls_re[i] = keys.setdefault(k, len(keys))
            n_re.append(self._idx(*k)[1])
        ncls = _bucket_of(len(keys), CLS_BUCKETS)
        rows = [self._idx(*k)[0] for k in keys]
        return torch.stack(rows + [rows[0]] * (ncls - len(rows))), cls_re, n_re

    def _front(self, samples, sf_indices, abc, sharding=None):
        """Stage A of the plan: the stored pass, or the upload and the
        front end (on this object's device, or split over `sharding`)."""
        if abc is not None:
            return lambda _prev: abc
        refs = torch.stack([self._ref(s) for s in sf_indices])
        if sharding is not None:
            return self._front_sharded(samples, refs, sharding.positions())
        sq, sc = self._upload(samples)
        return lambda _prev: self._a(sq, sc, refs)

    def _front_sharded(self, samples, refs, devices):
        """Stage A over the positions `devices`: each takes a contiguous block
        of the W rows with their ingest scales, uploaded (or copied, for
        device ingest) straight to its device, and runs the front end there;
        the grids, channel estimates and noise come back to this object's
        device in row order for stages B and C.  Every row's arithmetic is
        the unsharded one's, so the window decodes bit for bit alike."""
        samples_q, scale = _quantize_ingest(samples, self.ingest)
        if isinstance(samples_q, torch.Tensor):
            if samples_q.device != self.device:
                raise ValueError(f"samples are on {samples_q.device}, expected {self.device}")
        else:
            samples_q = torch.from_numpy(np.ascontiguousarray(samples_q))
        blocks = list(zip(split_rows(samples_q, devices),
                          split_rows(torch.from_numpy(scale), devices),
                          split_rows(refs, devices)))
        for d in devices:
            if d not in self._a_on:
                self._a_on[d] = _build_win_a(self.cell, self.nof_ports, d)

        def stage_a(_prev):
            outs = [self._a_on[d](*blk) for d, blk in zip(devices, blocks)]
            return tuple(torch.cat([o[i].to(self.device) for o in outs]) for i in range(3))

        return stage_a

    def _plan(self, samples, sf_indices, grants, softbuffer=None, abc=None, sharding=None):
        """Staged (name, fn) chain and the window's pack.  abc: optional
        (grid, ce, noise) of a front-end pass over the same W TTIs; stage A
        is then skipped.  sharding: see `dispatch_window`."""
        w = self.w
        idx_cls, cls_re, n_res = self._re_classes(sf_indices, grants)
        signs = torch.stack([self._signs(g.rnti, s) for s, g in zip(sf_indices, grants)])
        pack = pack_window([(g.tbs, n_res[i] * g.qm, g.qm, g.rv) for i, g in enumerate(grants)])
        bpar = np.array([[n_res[i], g.qm, cls_re[i]] for i, g in enumerate(grants)], np.int32)
        pdev = self._dev(np.concatenate([bpar.reshape(-1), pack.params])).to(torch.int64)
        bp = pdev[: 3 * w].reshape(w, 3)
        soft = _assemble_soft(softbuffer, pack, pack.key[1], self.device)
        tabs = class_tables(pack, self.device)
        bfn = self._b_for(tuple(sorted({g.qm for g in grants})))
        cfn = self._c_for(pack.key)
        stages = [
            ("A", self._front(samples, sf_indices, abc, sharding)),
            ("B", lambda a: bfn(a[0], a[1], a[2], idx_cls, bp[:, 2], bp[:, 0], bp[:, 1], signs)),
            ("C", lambda llr: cfn(llr, pdev[3 * w:], *tabs, soft)),
        ]
        return stages, pack


class WindowedUeDlMimo(WindowedUeDl):
    """Two-codeword spatial-multiplexing windows (the codebook PMIs 0-2 as
    data, large-delay CDD as pmi 3): W TTIs of `DlGrant2` per dispatch — each
    TTI fills two rows of the shared dense stage C."""

    _SCHEMES = ("spatialmux",)

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32, max_iterations: int = 5,
                 ingest: str = "int8", *, device=None):
        super().__init__(cell, cfi, w, max_iterations, "spatialmux", ingest, device=device)

    def _b_for(self, qms: tuple):
        if qms not in self._b_cache:
            self._b_cache[qms] = _build_win_b_mimo(qms)
        return self._b_cache[qms]

    def _plan(self, samples, sf_indices, grants, softbuffer=None, abc=None, sharding=None):
        """As `WindowedUeDl._plan`; a sharding is accepted and ignored, as the
        reference's `WindowedUeDlMimo._plan` does: the window runs on this
        object's device."""
        w = self.w
        idx_cls, cls_re, n_res = self._re_classes(sf_indices, grants)
        signs1, signs2 = (torch.stack([self._signs(g.rnti, s, q)
                                       for s, g in zip(sf_indices, grants)]) for q in (0, 1))
        row_specs = []
        bpar = np.zeros((w, 5), np.int32)  # n_re, qm1, qm2, pmi, cls_re
        for i, g in enumerate(grants):
            n_re = n_res[i]
            bpar[i] = (n_re, g.qm1, g.qm2, 3 if g.tx_scheme == "cdd" else g.pmi, cls_re[i])
            row_specs.append((g.tbs1, n_re * g.qm1, g.qm1, g.rv1))
            row_specs.append((g.tbs2, n_re * g.qm2, g.qm2, g.rv2))
        pack = pack_window(row_specs)
        pdev = self._dev(np.concatenate([bpar.reshape(-1), pack.params])).to(torch.int64)
        bp = pdev[: 5 * w].reshape(w, 5)
        soft = _assemble_soft(softbuffer, pack, pack.key[1], self.device)
        tabs = class_tables(pack, self.device)
        bfn = self._b_for(tuple(sorted({g.qm1 for g in grants} | {g.qm2 for g in grants})))
        cfn = self._c_for(pack.key)
        stages = [
            ("A", self._front(samples, sf_indices, abc)),
            ("B", lambda a: bfn(a[0], a[1], a[2], idx_cls, bp[:, 4], bp[:, 0], bp[:, 1],
                                bp[:, 2], bp[:, 3], signs1, signs2).reshape(2 * w, G_MAX)),
            ("C", lambda llr: cfn(llr, pdev[5 * w:], *tabs, soft)),
        ]
        return stages, pack

    def results(self, p: PendingWindow):
        """[((tb1, ok1), (tb2, ok2), n_it)] * W.  The counters take one TTI
        per codeword pair; crc_ok counts pairs with both codewords good."""
        rows = self._rows(p)
        out = []
        for (t1, ok1, n1), (t2, ok2, n2) in zip(rows[0::2], rows[1::2]):
            self.stats["ttis"] += 1
            self.stats["crc_ok"] += int(ok1 and ok2)
            out.append(((t1, ok1), (t2, ok2), max(n1, n2)))
        self.stats["windows"] += 1
        return out


class WindowedEnbUl(_WindowedDecoder):
    """Decode any W-TTI mix of PUSCH data grants per dispatch — the eNB's
    multi-UE uplink at windowed throughput; shares the downlink window's
    dense-slot stage C.  The window axis doubles as the multi-UE axis: W
    grants of one TTI are W copies of its samples.

    `device=None` means the first CUDA device (and raises when there is
    none); the tests pass "cpu"."""

    def __init__(self, cell: Cell, w: int = 32, max_iterations: int = 5,
                 ingest: str = "int8", *, device=None):
        super().__init__(cell, w, max_iterations, ingest, device)
        self._a = _build_win_a_ul(cell)
        self._nsym = len(pusch_symbols_data(cell))

    def _b_for_ul(self, qms: tuple):
        if qms not in self._b_cache:
            self._b_cache[qms] = _build_win_b_ul(self.cell, qms, self.device)
        return self._b_cache[qms]

    def _signs(self, rnti: int, sf_idx: int):
        return table(_signs_np, pusch_cinit(rnti, sf_idx, self.cell.id), device=self.device)

    def _plan(self, samples, sf_indices, grants, softbuffer=None, abc=None, sharding=None):
        """Staged (name, fn) chain and the window's pack.  abc: optional
        stored SC-FDMA grid (W, nrx, nsymb, nre) of an uplink front-end pass;
        stage A is then skipped.  sharding: never set (`_check` refuses it)."""
        w, dev = self.w, self.device
        dmrs = torch.stack([table(_win_ul_dmrs, self.cell, g.nof_prb, device=dev) for g in grants])
        signs = torch.stack([self._signs(g.rnti, s) for s, g in zip(sf_indices, grants)])
        # composed de-interleave classes by (m_sc, qm)
        keys: dict = {}
        cls_il = np.zeros(w, np.int32)
        for i, g in enumerate(grants):
            cls_il[i] = keys.setdefault((12 * g.nof_prb, g.qm), len(keys))
        ncls = _bucket_of(len(keys), CLS_BUCKETS)
        tabs_il = [table(_ul_compose_tabs, m, q, self._nsym, device=dev, dtype=torch.int64)
                   for (m, q) in keys]
        tabs_il += [tabs_il[0]] * (ncls - len(tabs_il))
        tab_llr = torch.stack([t[0] for t in tabs_il])
        tab_sig = torch.stack([t[1] for t in tabs_il])

        pack = pack_window([(g.tbs, self._nsym * 12 * g.nof_prb * g.qm, g.qm, g.rv)
                            for g in grants])
        bpar = np.array([[g.prb_start * 12, 12 * g.nof_prb, g.qm, cls_il[i]]
                         for i, g in enumerate(grants)], np.int32)
        pdev = self._dev(np.concatenate([bpar.reshape(-1), pack.params])).to(torch.int64)
        bp = pdev[: 4 * w].reshape(w, 4)
        soft = _assemble_soft(softbuffer, pack, pack.key[1], dev)
        tabs = class_tables(pack, dev)
        cfn = self._c_for(pack.key)
        bfn = self._b_for_ul(tuple(sorted({g.qm for g in grants})))
        if abc is None:
            sq, sc = self._upload(samples)
        stages = [
            ("A", (lambda _prev: abc) if abc is not None else lambda _prev: self._a(sq, sc)),
            ("B", lambda grid: bfn(grid, bp[:, 0], bp[:, 1], bp[:, 2], dmrs, signs,
                                   tab_llr, tab_sig, bp[:, 3])),
            ("C", lambda llr: cfn(llr, pdev[4 * w:], *tabs, soft)),
        ]
        return stages, pack


# --------------------------------------------------------------------------
# generate windows: payload bits in, baseband out — the eNB DL and UE UL
# transmit halves over the same dense slots and class tables as stage C
# --------------------------------------------------------------------------


def _payload_dense(payloads, tbs_list, tb_cap: int, device) -> torch.Tensor:
    """Per-row TB bits → (R, tb_cap) uint8 on `device`, each row's bytes
    (MSB first, as `np.packbits`) right-aligned: one flat upload of exactly
    the rows' own bytes, expanded by one gather on the device."""
    nb = np.array([t // 8 for t in tbs_list], np.int64)
    off = np.concatenate([[0], np.cumsum(nb)[:-1]])
    flat = torch.from_numpy(np.concatenate(
        [np.packbits(np.asarray(tb, np.uint8)) for tb in payloads])).to(device)
    nb_d, off_d = torch.from_numpy(np.stack([nb, off])).to(device)
    col = torch.arange(tb_cap, device=device)[None, :]
    src = (off_d + nb_d - tb_cap)[:, None] + col  # row r's byte j, left-padded
    return torch.where(col >= (tb_cap - nb_d)[:, None], flat[src.clamp(min=0)], 0)


def _slot_sources(pack: WindowPack, tb_cap: int) -> np.ndarray:
    """(N,) int64 start of each slot's K_MAX-bit read from the rows' bit
    streams laid end to end, each row [K_MAX zeros | TB || CRC24A
    right-aligned in tb_cap*8 + 24 bits]: the read ends at the slot's last
    data bit, and the zero head keeps every start >= 0."""
    bw = tb_cap * 8 + 24
    src = np.zeros(pack.key[1], np.int64)
    for r, tbs in enumerate(pack.tbs):
        start = r * (K_MAX + bw) + bw - (tbs + 24)
        for c, blk in enumerate(cbsegm(tbs).blocks):
            src[pack.row_start[r] + c] = start + blk.pos + blk.msg
    return src


def _tx_table(k: int, f: int, rv: int) -> np.ndarray:
    """TX rate-match table of one layout class padded to 3*(K_MAX+4):
    transmitted bit j of a codeblock reads its d-stream position tx[j mod
    n_valid]."""
    tx, nv = tx_table_np(k, f, rv, K_MAX)
    out = np.zeros(3 * (K_MAX + 4), np.int64)
    out[:nv] = tx
    return out


_tx_tables = sized_table(512)


def tx_class_tables(pack: WindowPack, device):
    """The window's TX class tables on `device` from the cached rows, int64:
    (tx_tab (CF, 3*(K_MAX+4)), perq (CQ, K_MAX)).  The repetition wrap is
    j mod n_valid on the device, so the rows are not tiled to a width."""
    cq, cf = pack.key[2], pack.key[3]
    kw = dict(device=device, dtype=torch.int64)
    f_rows = [_tx_tables(_tx_table, *c, **kw) for c in pack.fill_classes]
    p_rows = [_qpp_tables(_qpp_table, k, **kw)[0] for k in pack.qpp_classes]
    return (torch.stack(f_rows + [f_rows[0]] * (cf - len(f_rows))),
            torch.stack(p_rows + [p_rows[0]] * (cq - len(p_rows))))


@lru_cache(maxsize=32)
def _make_codeword_core(tb_cap: int, device):
    """The transmit chain the three generators share: payload bytes → TB
    CRC24A → segmentation (filler, CRC24B) → dynamic-K closed-form turbo
    encode → TX rate match → row codewords.

    core(payload (R, tb_cap) uint8, params (9N + 4R,) int64 = the pack's
    vector then `_slot_sources`, n_slots, tx_tab, perq) → (R, G_MAX) uint8.
    The CRC products sum at most 98304 ones in float32 (exact below 2^24;
    TF32 must stay off).  A row's codeword is one gather: position g reads
    the slot whose [off, off + e) holds it — every slot of the window
    carries bits, so the slots' starts ascend — at rank (g - off) mod
    n_valid of the slot's class table, and zero past the row's last
    codeblock."""
    tbl_a = crc_table(LTE_CRC24A, tb_cap * 8, device)
    tbl_b = crc_table(LTE_CRC24B, K_MAX, device)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=device)
    pos_k = torch.arange(K_MAX, device=device)[None, :]
    d_len = 3 * (K_MAX + 4)

    def crc(bits, tbl):
        return (torch.matmul(bits.to(torch.float32), tbl).to(torch.int32) & 1).to(torch.uint8)

    def core(payload, params, n_slots: int, tx_tab, perq):
        r, n = payload.shape[0], n_slots
        s_off, s_e, s_k, s_f, s_crcb, s_clsf, s_clsq, nv = params[: 8 * n].reshape(8, n)
        s_src = params[8 * n + 4 * r :]
        bits_tb = ((payload[:, :, None] >> shifts) & 1).reshape(r, -1)  # MSB first
        rb_flat = torch.cat([bits_tb.new_zeros((r, K_MAX)), bits_tb, crc(bits_tb, tbl_a)],
                            dim=1).reshape(-1)
        # each slot's data right-aligned in K_MAX bits, then its CRC24B;
        # the filler zeros sit in the masked head
        take = s_k - s_f - 24 * s_crcb
        ra = torch.where(pos_k >= K_MAX - take[:, None], rb_flat[s_src[:, None] + pos_k], 0)
        crc_b = torch.where(s_crcb[:, None] > 0, crc(ra, tbl_b), 0)
        rak = torch.cat([ra, crc_b, ra.new_zeros((n, K_MAX))], dim=1)
        cb = torch.gather(rak, 1, (K_MAX + 24 * s_crcb - s_k)[:, None] + pos_k)
        d = turbo_encode_device_dyn(cb, s_k, (perq, s_clsq)).reshape(-1)
        # row codewords
        g = torch.arange(r * G_MAX, device=payload.device)
        starts = torch.where(s_e > 0, s_off, r * G_MAX)
        slot = torch.bucketize(g, starts, right=True) - 1  # starts[0] = 0
        local = g - s_off[slot]
        src = tx_tab[s_clsf[slot], local % nv[slot]]
        return torch.where(local < s_e[slot], d[slot * d_len + src], 0).reshape(r, G_MAX)

    return core


def _modulate_select(bits, qm, qms: tuple, width: int) -> torch.Tensor:
    """(R, width) symbols of (R, >= width * Qm) bits, each row in the
    constellation its Qm (`qm`, (R,)) names; only the window's
    constellations (`qms`) are computed."""
    sym = bits.new_zeros((bits.shape[0], width), dtype=torch.complex64)
    for mod_c, qm_c in zip(MODS, QMS):
        if qm_c in qms:
            sym = torch.where((qm == qm_c)[:, None], modulate(mod_c, bits[:, : width * qm_c]), sym)
    return sym


def _inv_re_np(cell: Cell, sf_idx: int, cfi: int, prb: tuple) -> np.ndarray:
    """(nsymb * nre,) int64: the PDSCH symbol index of each grid RE of a
    PRB set, RE_MAX (the zero symbol) elsewhere."""
    pad, n_re, _b = _padded_re_indices(cell, sf_idx, cfi, prb)
    inv = np.full(cell.nsymb_per_sf * cell.nof_re_per_symbol, RE_MAX, np.int64)
    inv[pad[:n_re]] = np.arange(n_re)
    return inv


def _seq_bits_np(cinit: int) -> np.ndarray:
    return gold_sequence(cinit, G_MAX)


def _tmpl_np(cell: Cell, sf_idx: int, nof_ports: int, template: str) -> np.ndarray:
    """(nof_ports, nsymb * nre) complex64 grid before the PDSCH: the CRS of
    each port and, with template "full" on subframes 0 and 5 of port 0,
    the PSS and SSS."""
    t = np.zeros((nof_ports, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    put_crs_np(t, cell, sf_idx)
    if template == "full" and sf_idx in (0, 5):
        ns = cell.nsymb_per_slot
        put_pss_grid(t[0], cell.n_id_2, cell.nof_prb, ns - 1)
        put_sss_grid(t[0], cell.n_id_1, cell.n_id_2, sf_idx, cell.nof_prb, ns - 2)
    return t.reshape(nof_ports, -1)


@lru_cache(maxsize=32)
def _build_win_tx(cell: Cell, qms: tuple, device):
    """Port-0 PDSCH generate window after the codeword core: scramble → the
    window's constellations selected by Qm → each row's symbols through
    its inverse RE table over the template → the optional control overlay
    → IFFT.  fn(cw (R, G_MAX), …) → (R, sf_len) complex64."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    nsymb, nre = cell.nsymb_per_sf, cell.nof_re_per_symbol
    pos_re = torch.arange(RE_MAX, device=device)[None, :]

    def fn(cw, inv_re, qm, n_re, seqs, tmpl, overlay=None):
        r = cw.shape[0]
        sym = torch.where(pos_re < n_re[:, None], _modulate_select(cw ^ seqs, qm, qms, RE_MAX), 0)
        sym = torch.cat([sym, sym.new_zeros((r, 1))], dim=1)
        g = torch.where(inv_re < RE_MAX, torch.gather(sym, 1, inv_re), tmpl)
        if overlay is not None:
            # host-rendered control REs (PCFICH, PHICH, PDCCH, PBCH) over the
            # template; a pad index outside the grid lands in a spare column
            # that is cut off
            ov_idx, ov_vals = overlay
            s = g.shape[1]
            g = torch.cat([g, g.new_zeros((r, 1))], dim=1)
            g[torch.arange(r, device=device)[:, None],
              torch.where((ov_idx >= 0) & (ov_idx < s), ov_idx, s)] = ov_vals
            g = g[:, :s]
        return ofdm_tx_sf(ofdm, g.reshape(r, nsymb, nre))

    return fn


class _WindowedGenerator:
    """What the three generate windows share: the device, the codeword stage
    of a window's plan (pack, payload on the device, one integer upload,
    TX class tables, the shared core), the staged run, `stage_times` and
    the counters.  A subclass builds the plan (`_plan`): a ("codewords",
    fn), ("samples", fn) chain and the window's pack.  `device=None` means
    the first CUDA device (and raises when there is none); the tests pass
    "cpu"."""

    def __init__(self, cell: Cell, w: int, device):
        self.cell = cell
        self.w = w
        self.device = resolve(device)
        self.stats = {"windows": 0, "ttis": 0}

    def _check(self, payloads, sf_indices, grants):
        if not len(payloads) == len(sf_indices) == len(grants) == self.w:
            raise ValueError(f"a window takes {self.w} payloads, subframe indices and grants, got "
                             f"{len(payloads)}, {len(sf_indices)} and {len(grants)}")

    def _table(self, fn, *args, **kw):
        return table(fn, *args, device=self.device, **kw)

    def _codewords(self, row_specs, payloads, row_params):
        """The codeword stage: (pack, per-row grant parameters (R', P) int64
        on the device, fn(None) → (R, G_MAX) uint8 codewords).  row_specs:
        per codeword row (tbs, g, qm, rv); row_params: (R', P) integer grant
        parameters of the engine, uploaded with the pack's vector."""
        for i, (tb, spec) in enumerate(zip(payloads, row_specs)):
            if len(tb) != spec[0]:
                raise ValueError(f"row {i}: {len(tb)} payload bits for a TB of {spec[0]}")
        pack = pack_window(row_specs)
        n_slots, tb_cap = pack.key[1], pack.key[6]
        rows = np.asarray(row_params, np.int64)
        flat = torch.from_numpy(np.concatenate(
            [pack.params.astype(np.int64), _slot_sources(pack, tb_cap), rows.reshape(-1)])
        ).to(self.device)
        n_par = flat.shape[0] - rows.size
        payload = _payload_dense(payloads, pack.tbs, tb_cap, self.device)
        tabs = tx_class_tables(pack, self.device)
        core = _make_codeword_core(tb_cap, self.device)
        return (pack, flat[n_par:].reshape(rows.shape),
                lambda _prev: core(payload, flat[:n_par], n_slots, *tabs))

    def dispatch_window(self, payloads, sf_indices, grants, **kw) -> torch.Tensor:
        """Generate one window; see the subclass's `_plan` for the
        arguments.  Returns the samples as a complex64 tensor on the
        device."""
        self._check(payloads, sf_indices, grants)
        out = None
        for _name, fn in self._plan(payloads, sf_indices, grants, **kw)[0]:
            out = fn(out)
        self.stats["windows"] += 1
        self.stats["ttis"] += self.w
        return out

    def stage_times(self, payloads, sf_indices, grants, n: int = 10, **kw):
        """Seconds per stage ("codewords", "samples") of one window, as
        `_WindowedDecoder.stage_times` takes them."""
        self._check(payloads, sf_indices, grants)
        return _stage_times(self._plan(payloads, sf_indices, grants, **kw)[0], self.device, n)

    @staticmethod
    def samples(out: torch.Tensor) -> np.ndarray:
        """A dispatched window on the host: (W, [ports,] sf_len) complex64."""
        return out.cpu().numpy()


class WindowedEnbDl(_WindowedGenerator):
    """Generate any W-TTI mix of port-0 PDSCH data subframes per dispatch —
    the eNB's transmit half (payload bits in, baseband out), the mirror of
    `WindowedUeDl`.  template "full" puts the PSS and SSS into subframes 0
    and 5 (with `overlay=`, the whole downlink subframe of the control
    plane)."""

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32, template: str = "crs", *,
                 device=None):
        if template not in ("crs", "full"):
            raise ValueError(f"template {template!r} is not 'crs' or 'full'")
        super().__init__(cell, w, device)
        self.cfi = cfi
        self.template = template

    def _n_res(self, sf_indices, grants):
        return [_padded_re_indices(self.cell, s, self.cfi, tuple(g.prb))[1]
                for s, g in zip(sf_indices, grants)]

    def _inv_re(self, sf_indices, grants):
        return torch.stack([self._table(_inv_re_np, self.cell, s, self.cfi, tuple(g.prb))
                            for s, g in zip(sf_indices, grants)])

    def _plan(self, payloads, sf_indices, grants, overlay=None):
        """payloads: per TTI the TB bits ((tbs,) uint8); grants: `DlGrant`
        list; → (W, sf_len) complex64.

        overlay: optional (idx (W, n_ov) integer, vals (W, n_ov) complex),
        host-rendered control REs (PCFICH, PHICH, PDCCH, PBCH) written over
        the grid before the IFFT; indices outside the grid are dropped."""
        cell = self.cell
        n_res = self._n_res(sf_indices, grants)
        pack, rows, cw_fn = self._codewords(
            [(g.tbs, n * g.qm, g.qm, g.rv) for g, n in zip(grants, n_res)], payloads,
            [(g.qm, n) for g, n in zip(grants, n_res)])
        inv_re = self._inv_re(sf_indices, grants)
        seqs = torch.stack([self._table(_seq_bits_np, pdsch_cinit(g.rnti, s, cell.id))
                            for s, g in zip(sf_indices, grants)])
        tmpl = torch.stack([self._table(_tmpl_np, cell, s, 1, self.template)[0]
                            for s in sf_indices])
        ov = None
        if overlay is not None:
            ov = (torch.from_numpy(np.asarray(overlay[0], np.int64)).to(self.device),
                  torch.from_numpy(np.asarray(overlay[1], np.complex64)).to(self.device))
        fn = _build_win_tx(cell, tuple(sorted({g.qm for g in grants})), self.device)
        return [("codewords", cw_fn),
                ("samples", lambda cw: fn(cw, inv_re, rows[:, 0], rows[:, 1], seqs, tmpl, ov))], pack


def window_channel(tx: torch.Tensor, h, noise_amp: float, seed: int = 0, device=None) -> torch.Tensor:
    """Flat channel and AWGN between a generate and a decode window, on the
    device: tx (W, sf_len) or (W, ntx, sf_len) complex64, h (nrx, ntx)
    complex.  Returns (W, nrx, sf_len) complex64, which the decode engines
    take as device-resident ingest.  The noise comes from a
    `torch.Generator` on the device seeded with `seed`; `device=None`
    means the first CUDA device (and raises when there is none)."""
    dev = resolve(device)
    if tx.device != dev:
        raise ValueError(f"tx is on {tx.device}, expected {dev}")
    if tx.dim() == 2:
        tx = tx[:, None]
    h = torch.as_tensor(np.asarray(h, np.complex64), device=dev)
    if h.dim() != 2 or h.shape[1] != tx.shape[1]:
        raise ValueError(f"h {tuple(h.shape)} does not take {tx.shape[1]} transmit ports")
    rx = sum(h[None, :, p, None] * tx[:, None, p] for p in range(tx.shape[1]))
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(tuple(rx.shape) + (2,), generator=gen, device=dev)
    return rx + noise_amp * torch.view_as_complex(noise)


# --- UE UL (PUSCH) generate window ------------------------------------------


def _ul_interleave_tab(m_sc: int, qm: int, nsym: int) -> np.ndarray:
    """(G_MAX,) int64 transmit-order source index, out[i] = cw[tab[i]]: the
    TS 36.212 §5.2.2.8 time-first channel interleaver of one (m_sc, Qm)
    class, G_MAX (the zero bit) past the codeword."""
    g_len = nsym * m_sc * qm
    i = np.arange(G_MAX, dtype=np.int64)
    cc = i // max(m_sc * qm, 1)
    u = i - cc * (m_sc * qm)
    r = u // max(qm, 1)
    q = u - r * qm
    return np.where(i < g_len, (r * nsym + cc) * qm + q, G_MAX)


def _ul_pad_tab(m_sc: int, qm: int, nsym: int) -> np.ndarray:
    """(nsym * M_MAX * 8,) int64 source of each bit of the padded (symbol,
    M_MAX) layout: bit q of subcarrier r < m_sc of symbol c reads
    transmit-order bit c*(m_sc*qm) + r*qm + q; the rest, and everything past
    the class's own nsym*M_MAX*qm bits, reads G_MAX (zero)."""
    pp = np.arange(nsym * M_MAX * 8, dtype=np.int64)
    cc = pp // (M_MAX * qm)
    u = pp - cc * (M_MAX * qm)
    ok = (u < m_sc * qm) & (pp < nsym * M_MAX * qm)
    return np.where(ok, cc * (m_sc * qm) + u, G_MAX)


@lru_cache(maxsize=32)
def _build_win_ul_tx(cell: Cell, qms: tuple, device):
    """PUSCH generate window after the codeword core: the row's channel
    interleave → scramble → the padded (symbol, M_MAX) layout → the
    window's constellations selected by Qm → Bluestein DFT precoding at
    each row's width → data and DMRS placed at k0 → optional PUCCH blocks
    → SC-FDMA IFFT with the +0.5 subcarrier shift.  fn(cw (R, G_MAX), …)
    → (R, sf_len) complex64."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5)
    data_syms = list(pusch_symbols_data(cell))
    nsym, nss = len(data_syms), cell.nsymb_per_slot
    dmrs_syms = list(dmrs_symbols(cell))
    nsymb, nre = cell.nsymb_per_sf, cell.nof_re_per_symbol
    pos = torch.arange(M_MAX, device=device)
    col = torch.arange(nre, device=device)

    def fn(cw, il_tab, pad_tab, qm, m_sc, k0, seqs, dmrs, pucch=None):
        r = cw.shape[0]
        zero = cw.new_zeros((r, 1))
        cw_t = torch.gather(torch.cat([cw, zero], dim=1), 1, il_tab) ^ seqs
        bits = torch.gather(torch.cat([cw_t, zero], dim=1), 1, pad_tab)
        in_m = pos < m_sc[:, None]  # (R, M_MAX)
        sym = _modulate_select(bits, qm, qms, nsym * M_MAX).reshape(r, nsym, M_MAX)
        blk = sym.new_zeros((r, nsymb, M_MAX))
        blk[:, data_syms] = dft_bluestein(torch.where(in_m[:, None], sym, 0), m_sc[:, None])
        blk[:, dmrs_syms] = torch.where(in_m[:, None], dmrs, 0)
        # the allocation block at column k0 of the band
        c = col[None, :] - k0[:, None]  # (R, nre)
        grid = torch.where(((c >= 0) & (c < M_MAX))[:, None],
                           torch.gather(blk, 2, c.clamp(0, M_MAX - 1)[:, None].expand(r, nsymb, nre)),
                           0)
        if pucch is not None:
            # PUCCH in the same subframe: a PRB-local block per slot added at
            # the row's PRB of that slot; `live` masks the PUSCH of pad rows
            pprb, pgrid, live = pucch
            grid = grid * live[:, None, None]
            ri = torch.arange(r, device=device)[:, None, None]
            for s in range(2):
                li = torch.arange(s * nss, (s + 1) * nss, device=device)[None, :, None]
                ci = ((pprb[:, s] * 12).clamp(0, nre - 12)[:, None]
                      + torch.arange(12, device=device))[:, None, :]
                grid[ri, li, ci] = grid[ri, li, ci] + pgrid[:, s * nss:(s + 1) * nss]
        return ofdm_tx_sf(ofdm, grid)

    return fn


class WindowedUeUl(_WindowedGenerator):
    """Generate any W-TTI mix of PUSCH data grants per dispatch — the UE's
    transmit half, the mirror of `WindowedEnbUl`, which decodes these
    subframes."""

    def __init__(self, cell: Cell, w: int = 32, *, device=None):
        super().__init__(cell, w, device)
        self._nsym = len(pusch_symbols_data(cell))

    def _plan(self, payloads, sf_indices, grants, pucch=None):
        """payloads: per TTI the TB bits; grants: `UlGrant` list; → (W,
        sf_len) complex64.

        pucch: optional (prb (W, 2) integer PRB per slot, grids (W, nsymb,
        12) complex PRB-local blocks, live (W,) bool PUSCH mask): PUCCH and
        PUSCH in the same subframes; a row with live False transmits only
        its PUCCH block."""
        cell, nsym = self.cell, self._nsym
        pack, rows, cw_fn = self._codewords(
            [(g.tbs, nsym * 12 * g.nof_prb * g.qm, g.qm, g.rv) for g in grants], payloads,
            [(g.qm, 12 * g.nof_prb, 12 * g.prb_start) for g in grants])
        il_tab = torch.stack([self._table(_ul_interleave_tab, 12 * g.nof_prb, g.qm, nsym)
                              for g in grants])
        pad_tab = torch.stack([self._table(_ul_pad_tab, 12 * g.nof_prb, g.qm, nsym)
                               for g in grants])
        seqs = torch.stack([self._table(_seq_bits_np, pusch_cinit(g.rnti, s, cell.id))
                            for s, g in zip(sf_indices, grants)])
        dmrs = torch.stack([self._table(_win_ul_dmrs, cell, g.nof_prb) for g in grants]).conj()
        p_args = None
        if pucch is not None:
            pprb, pgrids, live = pucch
            p_args = (torch.from_numpy(np.asarray(pprb, np.int64)).to(self.device),
                      torch.from_numpy(np.asarray(pgrids, np.complex64)).to(self.device),
                      torch.from_numpy(np.asarray(live, np.float32)).to(self.device))
        fn = _build_win_ul_tx(cell, tuple(sorted({g.qm for g in grants})), self.device)
        return [("codewords", cw_fn),
                ("samples", lambda cw: fn(cw, il_tab, pad_tab, rows[:, 0], rows[:, 1], rows[:, 2],
                                          seqs, dmrs, p_args))], pack


# --- two-codeword (TM3/TM4) DL generate window -------------------------------


@lru_cache(maxsize=32)
def _build_win_tx_mimo(cell: Cell, qms: tuple, device):
    """Two-codeword spatial-multiplexing generate window after the codeword
    core, over 2W codeword rows (two per TTI): per-codeword scramble and
    constellation → layer map (one TTI's two rows are its two layers) →
    each TTI's precoder `_precoder_table()[pmi]` (PMIs 0-2, CDD as pmi 3,
    a 2x2 matrix per RE parity) → the inverse RE table over the 2-port CRS
    template → 2-port IFFT.  fn(cw (2W, G_MAX), …) → (W, 2, sf_len)
    complex64."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    nsymb, nre = cell.nsymb_per_sf, cell.nof_re_per_symbol
    pos_re = torch.arange(RE_MAX, device=device)[None, :]

    def fn(cw, inv_re, qm, n_re, pmi, seqs, tmpl):
        w = cw.shape[0] // 2
        n_re_rows = torch.repeat_interleave(n_re, 2)
        sym = torch.where(pos_re < n_re_rows[:, None], _modulate_select(cw ^ seqs, qm, qms, RE_MAX), 0)
        lay = sym.reshape(w, 2, RE_MAX // 2, 2)  # (W, layer, M/2, parity)
        c = table(_precoder_table, device=device)[pmi].permute(0, 2, 3, 1)[:, :, :, None, :]
        ports = (c[:, :, 0] * lay[:, None, 0] + c[:, :, 1] * lay[:, None, 1]).reshape(w, 2, RE_MAX)
        ports = torch.cat([ports, ports.new_zeros((w, 2, 1))], dim=2)
        idx = inv_re[:, None, :].expand(w, 2, inv_re.shape[1])
        g = torch.where(idx < RE_MAX, torch.gather(ports, 2, idx), tmpl)
        return ofdm_tx_sf(ofdm, g.reshape(w, 2, nsymb, nre))

    return fn


class WindowedEnbDlMimo(WindowedEnbDl):
    """Generate any W-TTI mix of two-codeword TM3/TM4 PDSCH subframes per
    dispatch (`DlGrant2`: the codebook PMIs 0-2 as data, large-delay CDD as
    pmi 3) — the mirror of `WindowedUeDlMimo`.  The template is the CRS of
    both ports."""

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32, *, device=None):
        super().__init__(cell, cfi, w, device=device)

    def _plan(self, payload_pairs, sf_indices, grants):
        """payload_pairs: per TTI (tb1 bits, tb2 bits); grants: `DlGrant2`
        list; → (W, 2, sf_len) complex64.  Codeword rows go two per TTI."""
        cell = self.cell
        n_res = self._n_res(sf_indices, grants)
        specs = [spec for g, n in zip(grants, n_res)
                 for spec in ((g.tbs1, n * g.qm1, g.qm1, g.rv1), (g.tbs2, n * g.qm2, g.qm2, g.rv2))]
        pack, rows, cw_fn = self._codewords(
            specs, [tb for pair in payload_pairs for tb in pair],
            [(g.qm1, g.qm2, n, 3 if g.tx_scheme == "cdd" else g.pmi) for g, n in zip(grants, n_res)])
        inv_re = self._inv_re(sf_indices, grants)
        seqs = torch.stack([self._table(_seq_bits_np, pdsch_cinit(g.rnti, s, cell.id, q=q))
                            for s, g in zip(sf_indices, grants) for q in (0, 1)])
        tmpl = torch.stack([self._table(_tmpl_np, cell, s, 2, "crs") for s in sf_indices])
        fn = _build_win_tx_mimo(cell, tuple(sorted({g.qm1 for g in grants} | {g.qm2 for g in grants})),
                                self.device)
        return [("codewords", cw_fn),
                ("samples", lambda cw: fn(cw, inv_re, rows[:, :2].reshape(-1), rows[:, 2],
                                          rows[:, 3], seqs, tmpl))], pack
