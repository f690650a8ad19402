"""UE synchronization: cell search, MIB search and the FIND/TRACK
subframe-alignment state machine.

Counterpart of `srsran_tpu/phy/ue/ue_sync.py` (`lib/src/phy/ue/ue_sync.c`,
state machine at :734-914, and `ue_cell_search.c`).  The control flow
(state, timing cursor, CFO loop, SFO estimate, out-of-sync counting, AGC)
stays on the host; the signal work — PSS correlation over all roots, CFO
rotation, OFDM, SSS detection, channel estimate, PBCH — runs on the device.
Only the scalars the control flow branches on or keeps (peak index, metric,
CFO) are read back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import as_samples, resolve, table
from ..agc import Agc
from ..chest.chest_dl import chest_dl
from ..common import Cell
from ..mimo import predecode_diversity2
from ..ofdm import OfdmConfig, ofdm_rx_sf
from ..phch.pbch import Mib, pbch_decode, pbch_re_indices
from ..sync.pss import pss_cfo_estimate, pss_find, pss_freq_np
from ..sync.sss import sss_detect


@dataclasses.dataclass
class CellSearchResult:
    cell_id: int
    n_id_2: int
    cfo: float  # in subcarrier units
    peak_offset: int  # sample index of the PSS symbol start
    sf_idx: int  # 0 or 5 (the SSS subframe)
    psr: float  # peak-to-average detection metric
    frame_type: str = "fdd"  # "fdd" | "tdd" (frame structure 1 or 2)


def apply_cfo(samples: torch.Tensor, cfo: float, symbol_sz: int, n0: int = 0) -> torch.Tensor:
    """Rotate (..., n) complex64 samples by -cfo subcarrier spacings, sample i
    taken as time n0 + i.  The phase and the product are float64 (at 100 PRB
    a buffer holds 215040 samples, where a float32 phase is off by 1e-5 rad);
    the result is complex64."""
    n = torch.arange(n0, n0 + samples.shape[-1], device=samples.device, dtype=torch.float64)
    phase = ((-2.0 * np.pi * cfo) * n) / symbol_sz
    rot = torch.polar(torch.ones_like(phase), phase)
    return (samples.to(torch.complex128) * rot).to(torch.complex64)


def _pss_ref_conj(n_id_2: int) -> np.ndarray:
    return np.conj(pss_freq_np(n_id_2))


def _read(*scalars) -> list[float]:
    """Device scalars → host floats in one read."""
    return torch.stack([s.reshape(()).to(torch.float64) for s in scalars]).cpu().tolist()


def cell_search(samples, nof_prb: int = 6, threshold: float = 6.0,
                frame_type: str | None = None, device=None) -> CellSearchResult | None:
    """Search ≥ 6 ms of samples for a cell (`srslte_ue_cellsearch_scan`,
    all three N_id_2 in one batched correlation), on `device` (None: the
    card).

    ``frame_type``: "fdd", "tdd", or None to try both (sync.c:746-763): FDD
    puts the SSS one symbol before the PSS; TDD puts the PSS on symbol 2 of
    sf 1/6 and the SSS on the last symbol of the subframe before.  The
    larger (SSS metric, frame type, N_id_1, sf_is_5) tuple wins."""
    x = as_samples(samples, resolve(device))
    cell0 = Cell(nof_prb=nof_prb, nof_ports=1, id=0)
    sz = cell0.symbol_sz
    nid2, off, peak, avg = pss_find(x, sz)
    n_id_2, offset, psr = _read(nid2, off, peak / (avg + 1e-12))  # psr in float32
    n_id_2, offset = int(n_id_2), int(offset)
    if psr < threshold:
        return None
    if x.shape[-1] - offset < sz:
        return None
    cfo = float(pss_cfo_estimate(x[offset : offset + sz], n_id_2, sz))
    corr = apply_cfo(x, cfo, sz)
    ofdm = OfdmConfig.from_cell(cell0, normalize=True)
    k0 = cell0.nof_re_per_symbol // 2 - 31
    pss_ref_conj = table(_pss_ref_conj, n_id_2, device=x.device)
    n = x.shape[-1]
    trials = ("fdd", "tdd") if frame_type is None else (frame_type,)
    results = []
    for ft in trials:
        if ft == "fdd":
            # PSS = last symbol of slot 0; SSS one symbol earlier, same sf
            sf_start = offset - ofdm.symbol_starts()[cell0.nsymb_per_slot - 1]
            if sf_start < 0 or sf_start + cell0.sf_len > n:
                continue
            grid = ofdm_rx_sf(ofdm, corr[sf_start : sf_start + cell0.sf_len])
            sss_re = grid[cell0.nsymb_per_slot - 2, k0 : k0 + 62]
            pss_re = grid[cell0.nsymb_per_slot - 1, k0 : k0 + 62]
        else:
            # PSS = symbol 2 of sf 1/6; SSS = last symbol of the sf before
            sf1_start = offset - ofdm.symbol_starts()[2]
            sss_sf_start = sf1_start - cell0.sf_len
            if sss_sf_start < 0 or sf1_start + cell0.sf_len > n:
                continue
            grid1 = ofdm_rx_sf(ofdm, corr[sf1_start : sf1_start + cell0.sf_len])
            grid0 = ofdm_rx_sf(ofdm, corr[sss_sf_start:sf1_start])
            sss_re = grid0[-1, k0 : k0 + 62]
            pss_re = grid1[2, k0 : k0 + 62]
        nid1, sf_is_5, metric = sss_detect(sss_re, n_id_2, ce=pss_re * pss_ref_conj)
        m, i1, s5 = _read(metric, nid1, sf_is_5)
        results.append((m, ft, int(i1), bool(s5)))
    if not results:
        return None
    _metric, ft, nid1, sf_is_5 = max(results)
    return CellSearchResult(cell_id=3 * nid1 + n_id_2, n_id_2=n_id_2, cfo=cfo, peak_offset=offset,
                            sf_idx=5 if sf_is_5 else 0, psr=psr, frame_type=ft)


def mib_search(samples, cell: Cell, sf0_start: int, cfo: float = 0.0, device=None):
    """Decode the MIB from the subframe-0 samples at `sf0_start` (ue_mib.c),
    on `device` (None: the card).  Tries one port, then the 2-port SFBC
    hypothesis (the CRC mask confirms the port count).  Returns (Mib,
    nof_ports, sfn_offset) or None."""
    x = as_samples(samples, resolve(device))
    sf = apply_cfo(x, cfo, cell.symbol_sz)[sf0_start : sf0_start + cell.sf_len]
    if sf.shape[-1] < cell.sf_len:
        return None
    grid = ofdm_rx_sf(OfdmConfig.from_cell(cell, normalize=True), sf)
    ch = chest_dl(grid[None], cell, 0, nof_ports=1)
    ce = ch["ce"][0, 0].reshape(-1)
    noise = ch["noise"].reshape(-1)[0]
    idx = table(pbch_re_indices, cell, device=x.device, dtype=torch.int64)
    y = grid.reshape(-1)[idx]
    h = ce[idx]
    bits, nports, frame_off, ok = pbch_decode(y * torch.conj(h) / (torch.abs(h) ** 2 + noise), cell)
    if not ok:
        ch2 = chest_dl(grid[None], dataclasses.replace(cell, nof_ports=2), 0, nof_ports=2)
        h2 = ch2["ce"][0].reshape(2, -1)[:, idx]  # (2, 240)
        sym, _ = predecode_diversity2(y[None, :], h2[None])  # (1, 240)
        bits, nports, frame_off, ok = pbch_decode(sym[0], cell)
        if not ok:
            return None
    return Mib.unpack(bits), nports, frame_off


class UeSync:
    """FIND → TRACK subframe-stream state machine (`ue_sync.c:734`).

    push() raw samples; pop_subframe() returns (sf (sf_len,) complex64
    tensor, sf_idx).  The sample buffer `buf` is a complex64 tensor on the
    object's device (None: the card): pushed host samples go up once, popped
    subframes stay there for the decoder.  The AGC measures pushed host
    samples on the host.

    Tracking as `ue_sync.c:623-700` / `sync/sfo.c`: the PSS timing error is
    EMA-filtered (`sfo_ema`) and its integer part consumed from the stream
    every ``sample_offset_correct_period`` frames (``sfo_hz`` is the drift
    rate); the PSS CFO enters through a loop gain (`cfo_loop_bw`) with a
    dead zone (`cfo_tol`) once the PSS was stable for ``PSS_STABLE_CNT``
    occasions; ``OOS_LIMIT`` consecutive failed PSS occasions drop the
    track (``in_sync``)."""

    FIND, TRACK = "FIND", "TRACK"
    PSS_STABLE_CNT = 2  # consecutive PSS finds before the CFO loop engages
    OOS_LIMIT = 4  # consecutive track failures before re-FIND

    def __init__(self, nof_prb: int = 6, cfo_ema: float = 0.3,
                 frame_type: str | None = None, sfo_ema: float = 0.2,
                 sample_offset_correct_period: int = 1,
                 cfo_loop_bw: float = 0.3, cfo_tol: float = 0.002,
                 agc: Agc | None = None, *, device=None):
        self.device = resolve(device)
        self.cell_prb = nof_prb
        self.state = self.FIND
        self.buf = torch.zeros(0, dtype=torch.complex64, device=self.device)
        self.cell: Cell | None = None
        self.cfo = 0.0
        self.cfo_ema = cfo_ema
        self.cfo_loop_bw = cfo_loop_bw
        self.cfo_tol = cfo_tol  # dead zone, subcarrier units (~30 Hz)
        self.sf_idx = 0
        self.consumed = 0  # absolute sample cursor
        self.frame_type = frame_type  # None = auto-detect in FIND
        self.agc = agc
        self._agc_gain = 1.0
        self.sfo_ema = sfo_ema
        self.sample_offset_correct_period = sample_offset_correct_period
        self.mean_sample_offset = 0.0  # EMA of the PSS timing error
        self.sfo_samples_per_frame = 0.0  # drift estimate
        self._frames_since_correct = 0
        self._last_err = None
        self._oos_cnt = 0
        self._pss_stable = 0
        self.in_sync = False
        self._cell0 = Cell(nof_prb=nof_prb, nof_ports=1, id=0)
        self._ofdm = OfdmConfig.from_cell(self._cell0, normalize=True)

    @property
    def sfo_hz(self) -> float:
        """Estimated sample-clock drift in samples/s (100 frames/s)."""
        return self.sfo_samples_per_frame * 100.0

    def push(self, samples):
        """Append samples (numpy or a tensor) to the buffer; with an AGC,
        scale them by the gain it set last and let it measure the result."""
        if isinstance(samples, torch.Tensor):
            samples = samples.to(device=self.device, dtype=torch.complex64)
        else:
            samples = np.asarray(samples).astype(np.complex64)
        if self.agc is not None:
            # closed loop: the AGC observes the post-gain signal it controls
            samples = samples * (np.complex64(self._agc_gain) if isinstance(samples, np.ndarray)
                                 else self._agc_gain)
            self._agc_gain = self.agc.process(samples)
        self.buf = torch.cat([self.buf, as_samples(samples, self.device)])

    @property
    def _is_tdd(self) -> bool:
        return self.frame_type == "tdd"

    def _pss_sf_indices(self) -> tuple[int, int]:
        """Subframes that contain the PSS (FDD: 0/5, TDD: 1/6)."""
        return (1, 6) if self._is_tdd else (0, 5)

    def _pss_pos_in_sf(self) -> int:
        if self._is_tdd:
            return self._ofdm.symbol_starts()[2]
        return self._ofdm.symbol_starts()[self._cell0.nsymb_per_slot - 1]

    def pop_subframe(self):
        """(sf_samples, sf_idx), or None without enough samples or sync."""
        sf_len = self._cell0.sf_len
        sz = self._cell0.symbol_sz
        if self.state == self.FIND:
            if self.buf.shape[0] < 7 * sf_len:
                return None
            res = cell_search(self.buf, self.cell_prb, frame_type=self.frame_type,
                              device=self.device)
            if res is None:
                self.buf = self.buf[5 * sf_len :]
                return None
            self.cell = Cell(nof_prb=self.cell_prb, nof_ports=1, id=res.cell_id)
            self.cfo = res.cfo
            self.frame_type = res.frame_type
            # align to the start of the subframe containing the PSS
            self.buf = self.buf[res.peak_offset - self._pss_pos_in_sf() :]
            # FDD: PSS is in the SSS subframe; TDD: one subframe after it
            self.sf_idx = (res.sf_idx + 1) % 10 if self._is_tdd else res.sf_idx
            self.state = self.TRACK
            self.in_sync = True
            self._oos_cnt = 0
            self._pss_stable = 0
            self.mean_sample_offset = 0.0
            self._last_err = None
        if self.buf.shape[0] < sf_len:
            return None
        sf = apply_cfo(self.buf[:sf_len], self.cfo, sz)
        self.buf = self.buf[sf_len:]
        out_idx = self.sf_idx
        if out_idx in self._pss_sf_indices():
            self._track(sf)
        self.sf_idx = (self.sf_idx + 1) % 10
        return sf, out_idx

    def _track(self, sf: torch.Tensor):
        """The PSS occasion of one popped subframe: timing error, SFO, CFO
        loop, out-of-sync counting and the periodic sample-offset step."""
        sz = self._cell0.symbol_sz
        nid2, off, peak, avg = pss_find(sf, sz)
        nid2, off, psr = _read(nid2, off, peak / (avg + 1e-12))
        nid2, off = int(nid2), int(off)
        err = off - self._pss_pos_in_sf()
        if psr > 5.0 and abs(err) <= 16:
            self._oos_cnt = 0
            self._pss_stable += 1
            self.in_sync = True
            # SFO (ue_sync.c:623-700 / sfo.c): EMA of the timing error; the
            # drift rate is its change between PSS occasions, 2 per frame
            self.mean_sample_offset += self.sfo_ema * (err - self.mean_sample_offset)
            if self._last_err is not None:
                self.sfo_samples_per_frame += 0.1 * (
                    2.0 * (err - self._last_err) - self.sfo_samples_per_frame)
            self._last_err = err
            # CFO loop: gain and dead zone once the PSS is stable
            if sf.shape[0] - off >= sz and self._pss_stable >= self.PSS_STABLE_CNT:
                cfo_new = float(pss_cfo_estimate(sf[off : off + sz], nid2, sz))
                if abs(cfo_new) > self.cfo_tol:
                    self.cfo += self.cfo_loop_bw * cfo_new
        else:
            self._pss_stable = 0
            self._last_err = None
            # only a run of failures drops the track (a single fade must not)
            self._oos_cnt += 1
            self.in_sync = self._oos_cnt < self.OOS_LIMIT
            if not self.in_sync:
                self.state = self.FIND
        # periodic sample-offset correction: consume the accumulated integer
        # offset from the stream (next_rf_sample_offset role)
        self._frames_since_correct += 1
        if self._frames_since_correct >= 2 * self.sample_offset_correct_period:
            self._frames_since_correct = 0
            shift = int(round(self.mean_sample_offset))
            if shift > 0:
                self.buf = self.buf[shift:]
                self.mean_sample_offset -= shift
            elif shift < 0:
                self.buf = torch.cat([sf[shift:], self.buf])
                self.mean_sample_offset -= shift
