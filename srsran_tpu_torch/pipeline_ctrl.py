"""Windowed control-plane engines: the per-TTI control path batched over a
window of W subframes.

Counterpart of `srsran_tpu/pipeline_ctrl.py`, on the port's windowed
engines:

- `WindowedUeFrontEnd`: one pass of `WindowedUeDl`'s stage A (OFDM demod and
  CRS channel estimate of W downlink subframes), then the control-region
  REs (PCFICH + PHICH + PDCCH) equalized in one batched torch function (MRC
  with the per-TTI noise for 1 port, SFBC combining for 2), read to the host
  in one transfer with the per-TTI RSRP and noise.  The (grid, channel,
  noise) stay on the device: once the host has parsed the DCIs, the PDSCH
  window decodes from the stored pass (`WindowedUeDl.dispatch_window_from`),
  so each subframe is uploaded and FFT'd once.
- `window_blind_search`: the TS 36.213 §9.1.1 blind search over a whole
  window — candidate LLR extraction and the grouped de-rate-match on the
  host, one batched Viterbi per DCI length over every (TTI, RNTI,
  candidate) hypothesis on the device (the batch padded to the window
  engines' bucket ladder), then one read per length, a GF(2) CRC-RNTI check
  and the dedup on the host.
- `WindowedEnbUlFrontEnd`: one pass of `WindowedEnbUl`'s SC-FDMA demod over W
  uplink subframes; the band-edge PUCCH region of antenna 0 and the per-PRB
  receive power go to the host in one read, and the stored grid feeds the
  windowed PUSCH decode (`WindowedEnbUl.dispatch_window_from`).
- numpy forms of the small control decodes (PHICH despread, PUCCH format 1
  over a batch of subframes, format 2 / RM(20,O)) and the eNB control
  overlay (`enb_ctrl_overlay`: PCFICH, PHICH, PDCCH and, on subframe 0,
  PBCH values with their RE indices) that `WindowedEnbDl(overlay=)` writes
  over its template.

Entry points take `device=None`, the first CUDA device (and raise where
there is none); the tests pass "cpu".  The Viterbi output stays on the
device until `blind_search_collect` reads it.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .device import resolve, table
from .phy.chest.refsignal_ul import base_sequence
from .phy.common import LTE_CRC16, Cell
from .phy.crc import crc_compute_np
from .phy.fec.conv import convcoder_encode_np, viterbi_decode
from .phy.fec.rate_match import conv_rate_match_rx_batch_np, conv_rm_indices
from .phy.mimo import predecode_diversity2, predecode_single_mrc
from .phy.phch.pbch import pbch_encode_np, pbch_re_indices
from .phy.phch.pcfich import CFI_LEN, cfi_codeword, pcfich_cinit, pcfich_re_indices
from .phy.phch.pdcch import (
    CCE_BITS,
    _blind_candidates,
    _blind_signs,
    nof_cce,
    pdcch_cinit,
    pdcch_re_indices,
)
from .phy.phch.phich import (
    nof_phich_groups,
    phich_encode,
    phich_nsf,
    phich_re_indices,
    phich_sequence,
)
from .phy.phch.pucch import (
    W2,
    W3,
    W4,
    PucchConfig,
    _f1_alpha_cover,
    _f1_covers,
    _f1_syms,
    _f2_syms,
    ncs_cell,
)
from .phy.phch.uci import _codebook
from .phy.sequence import gold_sequence, gold_sequence_signs
from .pipeline_window import WindowedEnbUl, WindowedUeDl, _pow2_bucket

SQRT2 = np.float32(np.sqrt(2.0))


# --------------------------------------------------------------------------
# control-region RE layout (fixed per (cell, cfi): the values change per TTI,
# the positions of the CRS/PCFICH/PHICH/PDCCH REs do not)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CtrlLayout:
    idx: np.ndarray      # (n_ctrl,) int32 flat RE indices, concatenated
    pcfich: slice        # 16 REs
    phich: tuple         # per-group slice into idx
    pdcch: slice         # n_cce*36 REs in CCE transmit order
    n_cce: int


@lru_cache(maxsize=32)
def ctrl_layout(cell: Cell, cfi: int) -> CtrlLayout:
    parts = [np.asarray(pcfich_re_indices(cell), np.int32)]
    sl_pcfich = slice(0, parts[0].size)
    off = parts[0].size
    ph_slices = []
    for g in range(nof_phich_groups(cell)):
        p = np.asarray(phich_re_indices(cell, g), np.int32)
        parts.append(p)
        ph_slices.append(slice(off, off + p.size))
        off += p.size
    n = nof_cce(cell, 0, cfi)
    pd = np.asarray(pdcch_re_indices(cell, 0, cfi)[: n * 36], np.int32)
    parts.append(pd)
    return CtrlLayout(np.concatenate(parts), sl_pcfich, tuple(ph_slices),
                      slice(off, off + pd.size), n)


def _ctrl_idx(cell: Cell, cfi: int) -> np.ndarray:
    return ctrl_layout(cell, cfi).idx.astype(np.int64)


# --------------------------------------------------------------------------
# UE DL front-end window
# --------------------------------------------------------------------------


def _ctrl_equalize(grid, ce, noise, idx, nof_ports: int) -> torch.Tensor:
    """(grid (W, nrx, nsymb, nre), ce (W, nrx, P, nsymb, nre), noise (W,),
    ctrl idx (n_ctrl,)) → (W, 2·n_ctrl + 2) float32 packed [ctrl_eq re/im |
    rsrp | noise]: one read realizes a whole window's control plane."""
    w, nrx = grid.shape[:2]
    y = grid.reshape(w, nrx, -1).index_select(-1, idx)
    if nof_ports == 1:
        h = ce[:, :, 0].reshape(w, nrx, -1).index_select(-1, idx)
        x, _ = predecode_single_mrc(y, h, noise[:, None])
    else:
        h = ce[:, :, :2].reshape(w, nrx, 2, -1).index_select(-1, idx)
        x, _ = predecode_diversity2(y, h)
    rsrp = torch.mean(ce[:, :, :nof_ports].abs() ** 2, dim=(1, 2, 3, 4))
    return torch.cat([torch.view_as_real(x).reshape(w, -1),
                      torch.stack([rsrp, noise], dim=1).to(torch.float32)], dim=1)


@dataclasses.dataclass
class PendingFrontend:
    """One dispatched DL front-end window: the stored stage A pass and the
    packed control REs, on the device."""

    abc: tuple             # (grid, ce, noise) of the window's stage A
    packed: torch.Tensor   # (W, 2·n_ctrl + 2) float32
    sf_indices: list


class WindowedUeFrontEnd:
    """UE control and data front end at window rate.

    Wraps a `WindowedUeDl`: `dispatch` runs its stage A and the control
    equalize; `realize` is one device→host read; `dispatch_data` decodes the
    window's grants from the stored pass (no second upload or FFT)."""

    def __init__(self, cell: Cell, cfi: int = 2, w: int = 32, scheme: str = "port0",
                 ingest: str = "int8", max_iterations: int = 5, *, device=None):
        self.inner = WindowedUeDl(cell, cfi=cfi, w=w, scheme=scheme, ingest=ingest,
                                  max_iterations=max_iterations, device=device)
        self.device = self.inner.device
        self.cell = cell
        self.cfi = cfi
        self.w = w
        self.layout = ctrl_layout(cell, cfi)

    def dispatch(self, samples, sf_indices) -> PendingFrontend:
        """samples (W, nrx, sf_len) complex64: numpy (quantized to the
        engine's ingest on the host), or a complex tensor on the device
        (device-resident ingest) → pending front end."""
        inner = self.inner
        if len(sf_indices) != self.w:
            raise ValueError(f"a window takes {self.w} subframe indices, got {len(sf_indices)}")
        sq, sc = inner._upload(samples)
        refs = torch.stack([inner._ref(s) for s in sf_indices])
        abc = inner._a(sq, sc, refs)
        idx = table(_ctrl_idx, self.cell, self.cfi, device=self.device)
        return PendingFrontend(abc, _ctrl_equalize(*abc, idx, inner.nof_ports), list(sf_indices))

    def realize(self, pf: PendingFrontend):
        """One read → (ctrl_eq (W, n_ctrl) complex64, rsrp (W,), noise
        (W,)) on the host."""
        arr = pf.packed.cpu().numpy()
        n = self.layout.idx.size
        ctrl = np.ascontiguousarray(arr[:, : 2 * n]).view(np.complex64)
        return ctrl, arr[:, 2 * n], arr[:, 2 * n + 1]

    def dispatch_data(self, pf: PendingFrontend, grants, softbuffer=None):
        return self.inner.dispatch_window_from(pf.abc, pf.sf_indices, grants, softbuffer)

    def results(self, p):
        return self.inner.results(p)


# --------------------------------------------------------------------------
# window blind search (host numpy + ONE batched Viterbi per DCI length)
# --------------------------------------------------------------------------


def _blind_hypotheses(ctrl_eq: np.ndarray, layout: CtrlLayout, cell: Cell, sf_indices,
                      searches_per_tti) -> dict:
    """The host part of the windowed blind search: every (TTI, RNTI,
    candidate) hypothesis extracted and de-rate-matched, grouped by (Viterbi
    length d, aggregation level) so that one vectorized de-rate-match serves
    a group.  Returns {d: [(meta, (3, d) float32 LLRs)]}; meta is (t, rnti,
    fmt, dci_len, level, cce_start)."""
    raw: dict[tuple, list] = {}
    for t in range(len(sf_indices)):
        reqs = searches_per_tti[t]
        if not reqs:
            continue
        sym = ctrl_eq[t, layout.pdcch]
        llr = np.empty(2 * sym.size, np.float32)  # QPSK demod: +LLR ⇒ bit 1
        llr[0::2] = -SQRT2 * sym.real
        llr[1::2] = -SQRT2 * sym.imag
        sf = sf_indices[t]
        for rnti, fmt, dci_len, ue_sp in reqs:
            ls = llr * _blind_signs(rnti, sf, cell.id, CCE_BITS * layout.n_cce)[: llr.size]
            d = dci_len + 16
            for lvl, starts in _blind_candidates(rnti, sf, layout.n_cce, ue_sp):
                for st in starts:
                    raw.setdefault((d, lvl), []).append(
                        ((t, rnti, fmt, dci_len, lvl, st), ls[st * CCE_BITS : (st + lvl) * CCE_BITS]))
    hyps: dict[int, list] = {}
    for (d, _lvl), group in raw.items():
        dll = conv_rate_match_rx_batch_np(np.stack([g[1] for g in group]), d)
        hyps.setdefault(d, []).extend((meta, row) for (meta, _e), row in zip(group, dll))
    return hyps


def _viterbi_batch(d: int, entries, device) -> torch.Tensor:
    """One Viterbi over a DCI length's hypotheses, the batch padded to the
    bucket ladder of the window engines; the (bucket, d) bits stay on
    `device`."""
    stackb = np.zeros((_pow2_bucket(len(entries)), 3, d), np.float32)
    stackb[: len(entries)] = np.stack([e[1] for e in entries])
    return viterbi_decode(torch.from_numpy(stackb).to(device), d)


def blind_search_dispatch(ctrl_eq: np.ndarray, layout: CtrlLayout, cell: Cell, sf_indices,
                          searches_per_tti, *, device=None):
    """Phase 1 of the windowed blind search: extract and de-rate-match every
    hypothesis on the host, then dispatch one batched Viterbi per DCI length
    on `device` (None: the card).  `searches_per_tti`: per TTI a list of
    (rnti, fmt, dci_len, ue_specific).  Returns a pending object for
    `blind_search_collect`."""
    dev = resolve(device)
    hyps = _blind_hypotheses(ctrl_eq, layout, cell, sf_indices, searches_per_tti)
    return len(sf_indices), [(d, entries, _viterbi_batch(d, entries, dev))
                             for d, entries in hyps.items()]


@lru_cache(maxsize=16)
def _crc16_gen(nbits: int) -> np.ndarray:
    """(nbits, 16) GF(2) generator: CRC16 of a message = bits @ G mod 2 (the
    LTE CRC is zero-initialised, hence linear)."""
    g = np.zeros((nbits, 16), np.uint8)
    for i in range(nbits):
        e = np.zeros(nbits, np.uint8)
        e[i] = 1
        g[i] = crc_compute_np(e, LTE_CRC16)
    return g


def blind_search_collect(pending):
    """Phase 2: one read per DCI length, the CRC-RNTI check (a batched GF(2)
    product), dedup.  Returns per TTI a list of (rnti, fmt, dci_bits,
    agg_level, cce_start), the other formats before the 1A fallback."""
    w, pend = pending
    found: list[list] = [[] for _ in range(w)]
    seen: list[set] = [set() for _ in range(w)]
    shifts = np.arange(15, -1, -1)
    for d, entries, bits_dev in pend:
        ne = len(entries)
        bits = bits_dev[:ne].cpu().numpy()
        dci_len = entries[0][0][3]
        calc = (bits[:, :dci_len] @ _crc16_gen(dci_len)) % 2  # (ne, 16)
        masks = (np.array([e[0][1] for e in entries])[:, None] >> shifts) & 1
        ok = np.all((bits[:, dci_len:d] ^ masks) == calc, axis=1)
        for k in np.flatnonzero(ok):
            (t, rnti, fmt, _dl, lvl, st), _ = entries[k]
            b = bits[k]
            # one hit per distinct payload: a DCI sent at level L also
            # passes at nested or overlapping candidates
            key = (rnti, b[:dci_len].tobytes())
            if key in seen[t]:
                continue
            seen[t].add(key)
            found[t].append((rnti, fmt, b[:dci_len], lvl, st))
    for t in range(w):
        found[t].sort(key=lambda f: f[1] == "1A")
    return found


def window_blind_search(ctrl_eq: np.ndarray, layout: CtrlLayout, cell: Cell, sf_indices,
                        searches_per_tti, *, device=None):
    """Blind-decode a whole window's PDCCH (the synchronous form of
    `blind_search_dispatch` + `blind_search_collect`)."""
    return blind_search_collect(blind_search_dispatch(
        ctrl_eq, layout, cell, sf_indices, searches_per_tti, device=device))


# --------------------------------------------------------------------------
# small control decodes on the host
# --------------------------------------------------------------------------


def phich_decode_np(sym_eq, cell: Cell, sf_idx: int, n_seq: int):
    """numpy form of `phch.phich.phich_decode` (12 symbols) → (ack bool,
    metric float)."""
    nsf = phich_nsf(cell)
    signs = gold_sequence_signs(pcfich_cinit(sf_idx, cell.id), 3 * nsf)
    z = (np.asarray(sym_eq) * signs).reshape(3, nsf)
    corr = np.sum(z * np.conj(phich_sequence(n_seq, nsf)), axis=-1)
    metric = float(np.real(np.sum(corr)))
    return metric < 0, metric


@lru_cache(maxsize=512)
def _f1_refs(cell: Cell, n_pucch: int, delta_shift: int, sf_idx: int):
    """(dmrs_ref, data_ref) (nsymb_sf, 12) complex reference grids for PUCCH
    format 1 on one (resource, subframe), zero outside each part's symbols,
    and the DMRS and data symbol counts per slot."""
    cfg = PucchConfig(n_pucch=n_pucch, delta_shift=delta_shift)
    r = base_sequence(cell.id % 30, 12)
    n = np.arange(12)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f1_syms(cell)
    wd = W3 if nsym == 7 else W2
    c = _f1_covers(cell)
    dmrs = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    data = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    for slot in range(2):
        shifts, cover = _f1_alpha_cover(cell, cfg, 2 * sf_idx + slot)
        for i, l in enumerate(dmrs_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            dmrs[slot * nsym + l] = np.exp(1j * alpha * n) * r * wd[cover % c, i]
        for i, l in enumerate(data_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            data[slot * nsym + l] = np.exp(1j * alpha * n) * r * np.float32(W4[cover % c, i])
    return dmrs, data, len(dmrs_syms), len(data_syms)


def pucch_format1_decode_batch(grids: np.ndarray, cell: Cell, n_pucch: int, sfs, nof_bits: int,
                               delta_shift: int = 2):
    """`pucch_format1_decode` over B subframes of ONE resource at once:
    grids (B, nsymb_sf, 12) → (bits (B, nof_bits) uint8, metric (B,)), the
    same math and thresholds as the per-subframe form."""
    b = grids.shape[0]
    nsym = cell.nsymb_per_slot
    refs = [_f1_refs(cell, n_pucch, delta_shift, s) for s in sfs]
    n_dmrs, n_data = refs[0][2], refs[0][3]
    g = grids.reshape(b, 2, nsym, 12)
    dm = np.stack([r[0] for r in refs]).reshape(b, 2, nsym, 12)
    da = np.stack([r[1] for r in refs]).reshape(b, 2, nsym, 12)
    h = (g * np.conj(dm)).sum(axis=(2, 3)) / (n_dmrs * 12)   # (B, 2)
    z = (g * np.conj(da)).sum(axis=3) / 12                   # (B, 2, nsym)
    w = np.conj(h)[:, :, None] / (np.abs(h)[:, :, None] ** 2 + 1e-9)
    mask = np.abs(da).sum(axis=3) > 0                        # the data symbols
    d = (z * w * mask).sum(axis=(1, 2)) / (2 * n_data)
    est = (np.abs(h) ** 2).sum(axis=1)
    metric = est / (np.mean(np.abs(g) ** 2, axis=(1, 2, 3)) + 1e-12)
    if nof_bits == 0:
        return np.zeros((b, 0), np.uint8), metric
    if nof_bits == 1:
        return ((d.real + d.imag) < 0).astype(np.uint8)[:, None], metric
    return np.stack([(d.real < 0), (d.imag < 0)], axis=1).astype(np.uint8), metric


@lru_cache(maxsize=8)
def _rm_codebook_np(o: int, e: int, use20: bool):
    return np.asarray(_codebook(o, e, use20), np.float32)


def pucch_format2_decode_np(prb_grid, cell: Cell, cfg, sf_idx: int, nof_bits: int):
    """numpy form of `phch.pucch.pucch_format2_decode`: coherent despread
    and the RM(20,O) ML correlation."""
    r = np.asarray(base_sequence(cell.id % 30, 12))
    n = np.arange(12)
    ncs = ncs_cell(cell)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f2_syms(cell)
    grid = np.asarray(prb_grid)
    zs = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        h_acc = 0.0
        for l in dmrs_syms:
            alpha = 2 * np.pi * ((cfg.n_pucch + ncs[ns, l]) % 12) / 12
            ref = np.exp(1j * alpha * n).astype(np.complex64) * r
            h_acc = h_acc + np.sum(grid[slot * nsym + l] * np.conj(ref))
        h = h_acc / (len(dmrs_syms) * 12)
        for l in data_syms:
            alpha = 2 * np.pi * ((cfg.n_pucch + ncs[ns, l]) % 12) / 12
            ref = np.exp(1j * alpha * n).astype(np.complex64) * r
            z = np.sum(grid[slot * nsym + l] * np.conj(ref)) / 12
            zs.append(z * np.conj(h) / (np.abs(h) ** 2 + 1e-9))
    d = np.stack(zs)                       # (10,) QPSK symbols
    llr = np.empty(20, np.float32)
    llr[0::2] = -SQRT2 * d.real
    llr[1::2] = -SQRT2 * d.imag
    seq = gold_sequence((((sf_idx * 2 + 1) * (2 * cell.id + 1)) << 9) + cell.id, 20)
    llr = llr * (1.0 - 2.0 * seq).astype(np.float32)
    corr = _rm_codebook_np(nof_bits, 20, True) @ (-llr)  # (2^o,)
    best = int(np.argmax(corr))
    bits = ((best >> np.arange(nof_bits)) & 1).astype(np.uint8)
    metric = float(np.max(corr) / (np.sum(np.abs(llr)) + 1e-9))
    return bits, metric


# --------------------------------------------------------------------------
# eNB control overlay (host numpy, cached): the values the device generate
# window writes over its template
# --------------------------------------------------------------------------


def _qpsk_np(bits: np.ndarray) -> np.ndarray:
    """numpy QPSK map (the Gray map of `modulate(Mod.QPSK, ...)`)."""
    s = (1.0 - 2.0 * bits.astype(np.float32)) * np.float32(1 / np.sqrt(2))
    return (s[0::2] + 1j * s[1::2]).astype(np.complex64)


@lru_cache(maxsize=32)
def _overlay_layout(cell: Cell, cfi: int):
    """(layout, index vector with the PBCH positions padded to the spare
    column s = nsymb·nre, index vector of subframe 0 with the PBCH REs)."""
    lay = ctrl_layout(cell, cfi)
    pbch_idx = np.asarray(pbch_re_indices(cell), np.int32)
    s = cell.nsymb_per_sf * cell.nof_re_per_symbol
    idx_pad = np.concatenate([lay.idx, np.full(pbch_idx.size, s, np.int32)])
    idx_sf0 = np.concatenate([lay.idx, pbch_idx])
    return lay, idx_pad, idx_sf0


@lru_cache(maxsize=64)
def _pcfich_syms_np(cell: Cell, sf_idx: int, cfi: int) -> np.ndarray:
    seq = gold_sequence(pcfich_cinit(sf_idx, cell.id), CFI_LEN)
    return _qpsk_np(np.asarray(cfi_codeword(cfi) ^ seq, np.uint8))


@lru_cache(maxsize=256)
def _phich_syms_np(cell: Cell, sf_idx: int, n_seq: int, ack: int) -> np.ndarray:
    nsf = phich_nsf(cell)
    signs = gold_sequence_signs(pcfich_cinit(sf_idx, cell.id), 3 * nsf)
    return (phich_encode(ack, n_seq, nsf) * signs).astype(np.complex64)


@lru_cache(maxsize=64)
def _pdcch_seq(cell_id: int, sf_idx: int, nbits: int) -> np.ndarray:
    return np.asarray(gold_sequence(pdcch_cinit(0, sf_idx, cell_id), nbits), np.uint8)


@lru_cache(maxsize=4096)
def _dci_coded_np(dci_bits: tuple, rnti: int, agg: int) -> np.ndarray:
    """DCI payload → (72·agg,) coded bits (`pdcch.dci_encode_np`, cached per
    payload)."""
    b = np.asarray(dci_bits, np.uint8)
    crc = crc_compute_np(b, LTE_CRC16)
    mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)
    coded = convcoder_encode_np(np.concatenate([b, crc ^ mask]))
    return coded.reshape(-1)[conv_rm_indices(coded.shape[-1], CCE_BITS * agg)]


def enb_ctrl_overlay(cell: Cell, cfi: int, sf_idx: int, sched, mib=None, sfn: int = 0):
    """Render one TTI's control region → (idx (n_ov,) int32, vals (n_ov,)
    complex64).

    `sched`: a `DlSched` (its cfi is the one signalled on the PCFICH; phich
    = [(group, n_seq, ack)], dcis = [(bits, rnti, agg, cce)]).  The PBCH
    rides the overlay on subframe 0 when `mib` is given; on other subframes
    its positions point at the generator's spare column.  Unused PDCCH REs
    stay 0.  Single-port cells."""
    lay, idx_pad, idx_sf0 = _overlay_layout(cell, cfi)
    vals = np.zeros(idx_pad.size, np.complex64)
    vals[lay.pcfich] = _pcfich_syms_np(cell, sf_idx, sched.cfi)
    for group, n_seq, ack in sched.phich:
        vals[lay.phich[group]] += _phich_syms_np(cell, sf_idx, n_seq, ack)
    seq = _pdcch_seq(cell.id, sf_idx, CCE_BITS * lay.n_cce)
    pd = vals[lay.pdcch]
    for dci_bits, rnti, agg, cce in sched.dcis:
        coded = _dci_coded_np(tuple(int(x) for x in dci_bits), rnti, agg)
        scr = coded ^ seq[cce * CCE_BITS : (cce + agg) * CCE_BITS]
        pd[cce * 36 : (cce + agg) * 36] = _qpsk_np(scr)
    if sf_idx == 0 and mib is not None:
        mib = dataclasses.replace(mib, sfn=sfn)
        vals[lay.idx.size :] = pbch_encode_np(mib, cell, 1)[sfn % 4]
        return idx_sf0, vals
    return idx_pad, vals


# --------------------------------------------------------------------------
# eNB UL front-end window (SC-FDMA demod of W subframes + band-edge PUCCH)
# --------------------------------------------------------------------------


def _ul_edges(grid: torch.Tensor, cell: Cell, edge_prbs: int) -> torch.Tensor:
    """grid (W, nrx, nsymb, nre) → (W, nsymb·2e·2 + nof_prb) float32 packed
    [antenna 0's band edges re/im | per-PRB mean receive power over all
    antennas] (the power gates an allocation that carries nothing: its zero
    LLRs would decode to the valid all-zero codeword)."""
    w = grid.shape[0]
    e = 12 * edge_prbs
    nre = cell.nof_re_per_symbol
    edge = torch.cat([grid[:, 0, :, :e], grid[:, 0, :, nre - e :]], dim=-1)
    prb_pow = torch.mean(grid.abs() ** 2, dim=(1, 2)).reshape(w, cell.nof_prb, 12).mean(dim=-1)
    return torch.cat([torch.view_as_real(edge).reshape(w, -1), prb_pow], dim=1)


@dataclasses.dataclass
class PendingUlFrontend:
    grid: torch.Tensor     # (W, nrx, nsymb, nre) stored SC-FDMA grids
    edge: torch.Tensor     # (W, nsymb·2e·2 + nof_prb) float32 packed
    sf_indices: list


class WindowedEnbUlFrontEnd:
    """eNB UL front end at window rate: SC-FDMA demod of W subframes once;
    the PUCCH region to the host, the PUSCH decode from the stored grids."""

    def __init__(self, cell: Cell, w: int = 32, edge_prbs: int = 4, max_iterations: int = 5,
                 ingest: str = "float32", *, device=None):
        self.inner = WindowedEnbUl(cell, w=w, max_iterations=max_iterations, ingest=ingest,
                                   device=device)
        self.device = self.inner.device
        self.cell = cell
        self.w = w
        self.edge_prbs = edge_prbs

    def dispatch(self, samples, sf_indices) -> PendingUlFrontend:
        """samples (W, nrx, sf_len) complex64 (numpy, or a complex tensor on
        the device) → pending front end."""
        if len(sf_indices) != self.w:
            raise ValueError(f"a window takes {self.w} subframe indices, got {len(sf_indices)}")
        grid = self.inner._a(*self.inner._upload(samples))
        return PendingUlFrontend(grid, _ul_edges(grid, self.cell, self.edge_prbs), list(sf_indices))

    def realize_pucch(self, pf: PendingUlFrontend):
        """One read → ((W, nsymb, 2·12·edge_prbs) complex64 band-edge REs,
        (W, nof_prb) per-PRB receive power)."""
        arr = pf.edge.cpu().numpy()
        nsym = self.cell.nsymb_per_sf
        e = 24 * self.edge_prbs
        edge = np.ascontiguousarray(arr[:, : nsym * e * 2]).view(np.complex64)
        return edge.reshape(arr.shape[0], nsym, e), arr[:, nsym * e * 2 :]

    def pucch_prb_grid(self, edge_np: np.ndarray, t: int, prb_slot: tuple[int, int]) -> np.ndarray:
        """The (nsymb, 12) PRB-local grid of one PUCCH resource from the band
        edges; prb_slot = (PRB in slot 0, PRB in slot 1), the §5.4.3 hop."""
        e, npr = self.edge_prbs, self.cell.nof_prb
        nsym = self.cell.nsymb_per_slot
        out = np.zeros((self.cell.nsymb_per_sf, 12), np.complex64)
        for slot, prb in enumerate(prb_slot):
            col = prb * 12 if prb < e else 12 * e + (prb - (npr - e)) * 12
            sl = slice(slot * nsym, (slot + 1) * nsym)
            out[sl] = edge_np[t, sl, col : col + 12]
        return out

    def dispatch_data(self, pf: PendingUlFrontend, grants, softbuffer=None):
        return self.inner.dispatch_window_from(pf.grid, pf.sf_indices, grants, softbuffer)

    def results(self, p):
        return self.inner.results(p)
