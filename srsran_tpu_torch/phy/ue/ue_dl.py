"""UE downlink subframe processing — facade over the receive chain.

Counterpart of `srsran_tpu/phy/ue/ue_dl.py` (`lib/src/phy/ue/ue_dl.c`:
srslte_ue_dl_decode_fft_estimate :383, the blind DCI search :450-694, the
PDSCH decode :741): OFDM and channel estimation once per subframe, then
PCFICH → PHICH → PDCCH blind search → grant → PDSCH decode.  Signal work
runs on the device of the call; the host reads back the CFI, the blind
search's hypotheses and bits, and the per-subframe measurements.  With a
`TddConfig` (frame structure 2) UL subframes are skipped, a special
subframe decodes only its DwPTS, and the DCIs have their TDD sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve, table
from ..chest.chest_dl import chest_dl
from ..common import Cell
from ..mimo import predecode_diversity2, select_pmi
from ..modem import Mod
from ..ofdm import OfdmConfig, ofdm_rx_sf
from ..phch.dci import Dci1, Dci1A, Dci2
from ..phch.pcfich import pcfich_decode, pcfich_re_indices
from ..phch.pdcch import nof_cce, pdcch_blind_search, pdcch_re_indices
from ..phch.pdsch import DlGrant, DlGrant2, pdsch_decode, pdsch_decode2, pdsch_re_indices
from ..phch.phich import phich_decode, phich_re_indices
from ..phch.ra import dl_mcs_to_mod, dl_tbs, riv_decode, tbs_lookup
from ..phch.uci import cqi_hl_subband_size
from .. import tdd as tdd_mod
from .ue_sync import as_samples


@dataclasses.dataclass
class UeDlResult:
    cfi: int = 0
    dcis: list = dataclasses.field(default_factory=list)
    tbs: list = dataclasses.field(default_factory=list)  # (tb_bits, crc_ok)
    rsrp: float = 0.0
    snr_db: float = 0.0
    noise: float = 0.0
    pdsch_symbols: np.ndarray | None = None  # equalized REs (for scopes)
    dci_used: object = None  # the DL DCI whose PDSCH was decoded (Dci1A/Dci1/Dci2)
    dci_format: str = ""  # "1A" | "1" | "2" | "2a"
    cce_used: int = -1  # its CCE start (→ PUCCH 1a resource, pucch_proc.c:257)
    phich_ack: bool | None = None  # decoded HI when a resource was watched
    deferred: bool = False  # PDSCH queued on a windowed plane (no tbs yet)
    rank: int = 0  # recommended RI (0 = not measured; cc_worker.cc:566)
    pmi: int = 0  # recommended codebook index for the measured rank
    sb_snr: np.ndarray | None = None  # per-subband SNR (linear) over the
    #   TS 36.213 Table 7.2.1-3 subband grid (cqi.c:41-118)


def _is_crnti(rnti: int) -> bool:
    return not (rnti >= 0xFFF4 or rnti <= 0x0042)


def _idx(fn, *args, device) -> torch.Tensor:
    return table(fn, *args, device=device, dtype=torch.int64)


def ue_dl_decode_subframe(cell: Cell, samples, sf_idx: int, rnti: int, nrx: int = 1,
                          known_cfi: int | None = None, max_iterations: int = 5, tdd=None,
                          harq_softbuffers: dict | None = None,
                          phich: tuple[int, int] | None = None, tm: int = 2, dynamic=None,
                          deferred=None, *, device=None) -> UeDlResult:
    """Process one subframe: samples (nrx, sf_len) complex64 (numpy or a
    tensor) → decoded TBs, on `device` (None: the card).

    Mirrors the cc_worker DL pipeline (srsue/src/phy/cc_worker.cc:214-307).
    ``tm`` selects the blind-search format set (1A always; 1 for TM1/2, 2A
    for TM3, 2 for TM4 — ue_dl.c:56-87) and the spatial-multiplexing decode.
    ``harq_softbuffers``: the caller's dict harq_pid → (ndi, softbuffers),
    carried between retransmissions.  ``dynamic``: a
    `pipeline_dynamic.DynamicUeDl` for single-codeword grants of its CFI.
    ``deferred``: an `apps.windowed_plane.WindowedUeDlPlane` — the grant's
    PDSCH (port-0/diversity, or two codewords on a MIMO plane) is queued
    there instead of decoded, and the result carries ``deferred=True``
    with no tbs.  ``tdd`` (a `TddConfig`): UL subframes are skipped, a
    special subframe decodes only its DwPTS with the 0.75-PRB TBS rule
    (ra_dl.c:399,430-432), the DCIs are parsed at their TDD sizes, and the
    PDSCH is decoded here (``dynamic``/``deferred`` stay FDD-only, as the
    reference's)."""
    dev = resolve(device)
    res = UeDlResult()
    last_symbol = None
    if tdd is not None:
        sftype = tdd_mod.sf_type(tdd, sf_idx)
        if sftype == tdd_mod.SfType.U:
            return res
        if sftype == tdd_mod.SfType.S:
            last_symbol = tdd_mod.nof_dw(tdd)
        dynamic = deferred = None
    x = as_samples(samples, dev)
    nports_cell = min(max(cell.nof_ports, 1), 2)
    grid, ce, noise = front_end(cell, x, sf_idx, res, last_symbol)
    equalize = equalizer(grid, ce, noise, nports_cell)
    res.cfi = cfi = known_cfi if known_cfi is not None else decode_cfi(cell, sf_idx, equalize, dev)
    if phich is not None:
        group, n_seq = phich
        hi, _ = phich_decode(equalize(_idx(phich_re_indices, cell, group, device=dev)), cell,
                             sf_idx, n_seq)
        res.phich_ack = bool(hi)

    # PDCCH blind search over the TM-dependent format set; every candidate
    # of one payload length goes through one Viterbi call
    sym_eq = pdcch_symbols(cell, sf_idx, cfi, equalize, dev)
    found = sort_found([(fmt, bits, agg, cce)
                        for fmt, dci_len in dci_searches(cell, rnti, tm, tdd is not None)
                        for bits, agg, cce in pdcch_blind_search(sym_eq, cell, sf_idx, cfi, rnti,
                                                                 dci_len)])
    res.dcis = [(bits, agg, cce) for _, bits, agg, cce in found]
    for fmt, bits, _agg, cce in found:
        if _decode_grant(res, fmt, bits, cce, grid, ce, noise, cell, sf_idx, cfi, rnti,
                         nports_cell, max_iterations, harq_softbuffers, equalize, dynamic, x,
                         deferred, tdd is not None, last_symbol):
            break  # one DL grant per subframe (dedup across aggregation levels)
    return res


def front_end(cell: Cell, x: torch.Tensor, sf_idx: int, res: UeDlResult,
              last_symbol: int | None = None):
    """OFDM and channel estimation of one subframe (nrx, sf_len) on its
    device (the CRS before `last_symbol` only, in a DwPTS), and the
    measurements into `res` in one read: noise, RSRP, SNR, the per-subband
    SNR (the frequency-selective CQI input) and, at 2 ports and 2 rx,
    RI/PMI.  Returns (grid, ce, noise as a float)."""
    dev = x.device
    grid = ofdm_rx_sf(OfdmConfig.from_cell(cell, normalize=True), x)  # (nrx, nsymb, nre)
    ch = chest_dl(grid, cell, sf_idx, nof_ports=min(cell.nof_ports, 2), last_symbol=last_symbol)
    ce = ch["ce"]  # (nrx, nports, nsymb, nre)
    k_sb = cqi_hl_subband_size(cell.nof_prb)
    meas = [ch["noise"].mean(), ch["rsrp"].mean(), ch["snr"].mean()]
    if k_sb:
        p_re = torch.mean(ce[:, : min(cell.nof_ports, 2)].abs() ** 2, dim=(0, 1, 2))  # (nre,)
        w, n_sb = k_sb * 12, -(-cell.nof_prb // k_sb)
        padded = torch.zeros(n_sb * w, dtype=p_re.dtype, device=dev)
        padded[: p_re.numel()] = p_re
        meas.append(padded.reshape(n_sb, w).sum(dim=-1))
    host = torch.cat([m.reshape(-1) for m in meas]).cpu().numpy()
    noise = float(host[0])
    res.noise = noise
    res.rsrp = float(host[1])
    res.snr_db = float(10 * np.log10(host[2] + 1e-12))
    if k_sb:
        counts = np.minimum(w, p_re.numel() - np.arange(n_sb) * w)
        res.sb_snr = (host[3:] / counts / max(noise, 1e-12)).astype(np.float32)
    if min(max(cell.nof_ports, 1), 2) == 2 and grid.shape[0] >= 2:
        # RI/PMI from the CRS estimates (cc_worker's ri_info/pmi_info): rank
        # 2 while the Gram condition number stays moderate
        h_meas = ce[:, :2].reshape(ce.shape[0], 2, -1)[:, :, ::8]
        _best2, _cap2, cond_db = select_pmi(h_meas, 2, noise_est=max(noise, 1e-9))
        res.rank = 2 if float(cond_db) < 17.0 else 1
        best1, _cap1, _ = select_pmi(h_meas, res.rank, noise_est=max(noise, 1e-9))
        res.pmi = int(best1)
    return grid, ce, noise


def equalizer(grid: torch.Tensor, ce: torch.Tensor, noise: float, nports_cell: int):
    """equalize(idx) → the equalized REs at flat indices idx, combined over
    every rx antenna (mimo/precoding.c with nof_rxant): MRC at one port, SFBC
    at two (the control channels, TS 36.211 §6.7-6.9).  The MRC division is
    guarded where |h|^2 + noise is zero (no channel and no noise): 0 there."""

    def equalize(idx: torch.Tensor) -> torch.Tensor:
        y = grid.reshape(grid.shape[0], -1)[:, idx]
        if nports_cell == 1:
            h = ce[:, 0].reshape(ce.shape[0], -1)[:, idx]
            den = torch.sum(h.abs() ** 2, dim=0) + noise
            return torch.sum(y * torch.conj(h), dim=0) / den.clamp_min(torch.finfo(den.dtype).tiny)
        h2 = ce[:, :2].reshape(ce.shape[0], 2, -1)[:, :, idx]
        return predecode_diversity2(y, h2)[0].reshape(-1)

    return equalize


def decode_cfi(cell: Cell, sf_idx: int, equalize, device) -> int:
    """The CFI from the PCFICH."""
    return int(pcfich_decode(equalize(_idx(pcfich_re_indices, cell, device=device)), cell,
                             sf_idx)[0])


def pdcch_symbols(cell: Cell, sf_idx: int, cfi: int, equalize, device) -> torch.Tensor:
    """The equalized PDCCH REs of the subframe's CCEs, in transmit order."""
    n = nof_cce(cell, sf_idx, cfi)
    return equalize(_idx(pdcch_re_indices, cell, sf_idx, cfi, device=device)[: n * 36])


def dci_searches(cell: Cell, rnti: int, tm: int, tdd: bool = False) -> list[tuple[str, int]]:
    """(format, payload length) to blind-search: 1A always; for a C-RNTI 1
    in TM1/2 (when its length differs), 2A in TM3, 2 in TM4 (ue_dl.c:56-87);
    ``tdd``: the TDD sizes (HARQ and DAI fields, dci.c:142-143)."""
    searches = [("1A", Dci1A.nof_bits(cell.nof_prb, tdd=tdd))]
    if _is_crnti(rnti) and tm in (1, 2):
        l1 = Dci1.nof_bits(cell.nof_prb, tdd=tdd)
        if l1 != searches[0][1]:
            searches.append(("1", l1))
    elif _is_crnti(rnti) and tm in (3, 4):
        fmt = "2a" if tm == 3 else "2"
        searches.append((fmt, Dci2.nof_bits(cell.nof_prb, fmt, min(max(cell.nof_ports, 1), 2),
                                            tdd=tdd)))
    return searches


def sort_found(found: list) -> list:
    """The TM-specific format before the 1A fallback (ue_dl.c searches the
    UE-specific format first); stable within a format."""
    return sorted(found, key=lambda f: f[0] == "1A")


def _mark_used(res: UeDlResult, dci, fmt: str, cce: int):
    res.dci_used = dci
    res.dci_format = fmt
    res.cce_used = cce


def _decode_grant(res, fmt, bits, cce, grid, ce, noise, cell, sf_idx, cfi, rnti, nports_cell,
                  max_iterations, harq_softbuffers, equalize, dynamic, samples,
                  deferred=None, is_tdd: bool = False, last_symbol: int | None = None) -> bool:
    """Parse one found DCI and decode its PDSCH (or queue it on the
    `deferred` plane); True once a decode was attempted (the caller stops
    there).  A DCI whose fields are reserved (a CRC-RNTI false positive)
    is passed over.  ``is_tdd``/``last_symbol``: the DCI's TDD size, the
    DwPTS TBS rule and RE map (the two-codeword decode keeps the FDD map,
    as the reference's does)."""
    dwpts = last_symbol is not None
    if fmt in ("2", "2a"):
        try:
            dci = Dci2.unpack(bits, cell.nof_prb, fmt=fmt, nof_ports=nports_cell, tdd=is_tdd)
        except ValueError:
            return False
        prb = Dci1(rbg_bitmap=dci.rbg_bitmap).prb_list(cell.nof_prb)
        if not prb:
            return False
        # TS 36.212 Table 5.3.3.1.5-4 (2 ports, 2 codewords): precoding_info
        # 0 → codebook index 1, 1 → index 2 (format 2); 2A is large-delay CDD
        pmi, scheme = (1 + (dci.precoding_info & 1), "spatialmux") if fmt == "2" else (0, "cdd")
        try:
            grant = DlGrant2(prb=prb, mod1=dl_mcs_to_mod(dci.mcs1), tbs1=dl_tbs(dci.mcs1, len(prb)),
                             mod2=dl_mcs_to_mod(dci.mcs2), tbs2=dl_tbs(dci.mcs2, len(prb)),
                             rv1=dci.rv1, rv2=dci.rv2, pmi=pmi, rnti=rnti, tx_scheme=scheme)
        except (ValueError, IndexError):
            return False  # reserved MCS
        if deferred is not None and deferred.mimo and grant.tbs1 > 0 and grant.tbs2 > 0:
            deferred.submit(samples, sf_idx, grant, dci.harq_pid, (dci.ndi1, dci.ndi2), tti=-1,
                            dci=dci, fmt=fmt, cce=cce)
            _mark_used(res, dci, fmt, cce)
            res.deferred = True
            return True
        sbs = (None, None)
        if harq_softbuffers is not None:
            stored = harq_softbuffers.get(dci.harq_pid)
            if stored is not None and stored[0] == (dci.ndi1, dci.ndi2):
                sbs = stored[1]
        out = pdsch_decode2(grid, ce, noise, cell, sf_idx, cfi, grant, max_iterations,
                            softbuffers=sbs)
        if harq_softbuffers is not None:
            if all(ok for _, ok, _ in out):
                harq_softbuffers.pop(dci.harq_pid, None)
            else:
                harq_softbuffers[dci.harq_pid] = ((dci.ndi1, dci.ndi2),
                                                  tuple(sb for _, _, sb in out))
        res.tbs.extend((tb, ok) for tb, ok, _ in out)
        _mark_used(res, dci, fmt, cce)
        return True

    scheme = "diversity" if nports_cell >= 2 else "port0"
    if fmt == "1":
        try:
            dci = Dci1.unpack(bits, cell.nof_prb, tdd=is_tdd)
        except ValueError:
            return False
        prb = dci.prb_list(cell.nof_prb)
        if not prb:
            return False
        try:
            grant = DlGrant(prb=prb, mod=dl_mcs_to_mod(dci.mcs),
                            tbs=dl_tbs(dci.mcs, len(prb), dwpts=dwpts), rv=dci.rv, rnti=rnti,
                            tx_scheme=scheme)
        except (ValueError, IndexError):
            return False  # reserved MCS
    else:  # "1A"
        try:
            dci = Dci1A.unpack(bits, cell.nof_prb, tdd=is_tdd)
            rb0, l_crb = riv_decode(cell.nof_prb, dci.riv)
        except ValueError:
            return False
        prb = tuple(range(rb0, rb0 + l_crb))
        if not _is_crnti(rnti):
            # SI/P/RA-RNTI (TS 36.213 §7.1.7.2): QPSK, I_TBS = mcs, N_PRB
            # from the TPC field's LSB
            grant = DlGrant(prb=prb, mod=Mod.QPSK, tbs=tbs_lookup(dci.mcs, 3 if dci.tpc & 1 else 2),
                            rv=dci.rv, rnti=rnti, tx_scheme=scheme)
        else:
            try:
                grant = DlGrant(prb=prb, mod=dl_mcs_to_mod(dci.mcs),
                                tbs=dl_tbs(dci.mcs, l_crb, dwpts=dwpts), rv=dci.rv, rnti=rnti,
                                tx_scheme=scheme)
            except (ValueError, IndexError):
                return False  # reserved MCS

    if deferred is not None and not deferred.mimo and grant.tbs > 0:
        deferred.submit(samples, sf_idx, grant, dci.harq_pid, dci.ndi, tti=-1, dci=dci, fmt=fmt,
                        cce=cce)
        _mark_used(res, dci, fmt, cce)
        res.deferred = True
        return True
    # HARQ: the stored softbuffers combine only under the same NDI; a
    # toggled NDI is a new TB
    sb = None
    if harq_softbuffers is not None:
        stored = harq_softbuffers.get(dci.harq_pid)
        if stored is not None and stored[0] == dci.ndi:
            sb = stored[1]
    if dynamic is not None and grant.tbs > 0 and dynamic.cfi == cfi:
        tb, ok, sb_out, _ = dynamic.decode(samples, sf_idx, grant, softbuffer=sb)
    else:
        tb, ok, sb_out = pdsch_decode(grid, ce, noise, cell, sf_idx, cfi, grant, max_iterations,
                                      softbuffers=sb, tdd=is_tdd, last_symbol=last_symbol)
    if harq_softbuffers is not None:
        if ok:
            harq_softbuffers.pop(dci.harq_pid, None)
        else:
            harq_softbuffers[dci.harq_pid] = (dci.ndi, sb_out)
    res.tbs.append((tb, ok))
    _mark_used(res, dci, fmt, cce)
    res.pdsch_symbols = equalize(
        _idx(pdsch_re_indices, cell, sf_idx, cfi, grant.prb, is_tdd, last_symbol,
             device=grid.device)).cpu().numpy()
    return True
