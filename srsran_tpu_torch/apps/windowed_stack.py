"""Full LTE stack on the windowed control plane, on the port: no per-TTI DSP
on the host at all.

Counterpart of `srsran_tpu/apps/windowed_stack.py`.  `apps/full_stack.py`
with `apps/windowed_plane.py` puts the PDSCH/PUSCH data path on windowed
engines but keeps the per-TTI control path (PDCCH render and blind decode,
OFDM, channel estimate, PUCCH).  This module batches the control path too
(the `pipeline_ctrl` engines): every `run_tti` does only queue bookkeeping
and byte-level MAC/RLC work; all DSP happens in a handful of device
dispatches per W-TTI window.

Timing contract (the windowed extension of windowed_plane.py's):

* window W (>= 12), feedback delay D = 5W TTIs;
* DCI-0 grants, RAR Msg3, PHICH retransmissions and HARQ ACKs all run at +D
  instead of the TS 36.213 +4 (`ul_grant_delay`/`harq_delay`);
* DL HARQ is synchronous with n_harq = 6W + 32 processes: pid = tti %
  n_harq on both ends (the DCI's 3-bit field carries pid % 8), and
  retransmissions ride the pid's own TTI slots — the LTE UL HARQ discipline
  applied to the DL, because a 3-bit pid cannot span D in-flight TBs;
* simultaneous PUCCH and PUSCH (TS 36.213 r10): UCI always rides PUCCH, so
  every PUSCH is a pure data transport that the windowed engines decode.

Pipeline schedule (windows aligned to absolute TTIs, window j = TTIs [jW,
jW+W)):

  eNB  rows of DL window k+2 staged one per tick through window k and
       rendered in one dispatch at its boundary; UL window m dispatched to
       the front end when its last row arrives (tti mW+W); PUCCH realised
       to the host, the PUSCH data window chained from the stored grid.
  UE   boundary of window k: dispatch the control front end for window k;
       the blind-search Viterbi batched and pipelined; the data window
       chained from the stored grids; UL rows staged one per tick, two
       windows ahead.

A dispatched window is realised (read to the host) `RD` TTIs after its
dispatch, by TTI count alone, so a run is deterministic.  Both ends take `device=None` (the card;
`device.resolve`); `phy_device` is the engines' device and defaults to
`device`.  `run_tti` takes and returns complex64 tensors on that device (the
host-row link); `WindowedDeviceLoopback` moves whole windows between the
ends through `window_channel` instead, and the rows never exist.

Single-cell FDD, 1-port, single-codeword, TM1 (the serving hot path;
TDD, CA, TM3+ and mobility stay on the per-TTI stack).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..device import resolve
from ..phy.common import SIRNTI, Cell
from ..phy.modem import Mod
from ..phy.phch.dci import Dci0, Dci1A
from ..phy.phch.pdsch import DlGrant
from ..phy.phch.prach import prach_cp_len, prach_detect, prach_nfft
from ..phy.phch.pucch import (
    PucchConfig,
    _f1_covers,
    pucch_f1_prb,
    pucch_format1_decode,
    pucch_format1_encode_np,
    pucch_format2_encode_np,
)
from ..phy.phch.pusch import UlGrant
from ..phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_decode, tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
from ..pipeline_ctrl import (
    WindowedEnbUlFrontEnd,
    WindowedUeFrontEnd,
    blind_search_collect,
    blind_search_dispatch,
    enb_ctrl_overlay,
    phich_decode_np,
    pucch_format1_decode_batch,
    pucch_format2_decode_np,
)
from ..pipeline_window import WindowedEnbDl, WindowedUeUl, extract_softbuffer, window_channel
from ..stack import rrc
from ..stack.mac import HARQ_RV_SEQ, Scheduler
from .full_stack import (
    UL_HARQ_MAX_TX,
    EnbStack,
    UeStack,
    _cqi_resource,
    _is_sr_sf,
    _phich_resource,
    _sr_resource,
    cqi_on_pusch,
    cqi_report_is_ri,
)

RD = 4       # dispatch → realisation distance (TTIs)
RD_COPY = 2  # the reference's dispatch → copy-start distance (TTIs); below RD, so
#              it adds no condition when a window realises by TTI count


def _due(e, tti: int) -> bool:
    """A pending window realises `RD` TTIs after its dispatch."""
    return tti - e["t"] >= RD


def _pad_dl_grant(cell: Cell) -> DlGrant:
    """Filler row for grant-less TTIs in a fixed-shape window (1 PRB of QPSK
    junk on air; the UE has no DCI for it and ignores the REs)."""
    return DlGrant(prb=(0,), mod=Mod.QPSK, tbs=16, rnti=0)


def _pad_ul_grant() -> UlGrant:
    return UlGrant(prb_start=1, nof_prb=1, mod=Mod.QPSK, tbs=16, rnti=0)


def _check_window(cell: Cell, ctrl_window: int):
    if ctrl_window < 12:
        raise ValueError(f"the pipeline math needs W >= 12, got {ctrl_window}")
    if cell.nof_ports != 1:
        raise ValueError("the windowed control plane takes 1-port cells")


# ==========================================================================
# eNB
# ==========================================================================


class WindowedCtrlEnb(EnbStack):
    """eNB with the whole PHY (control and data, both directions) on windowed
    device engines."""

    def __init__(self, cell: Cell, mme, spgw, ctrl_window: int = 16, phy_device=None, **kw):
        _check_window(cell, ctrl_window)
        if kw.get("tdd_cfg") is not None:
            raise ValueError("the windowed control plane is FDD")
        super().__init__(cell, mme, spgw, phy_device=phy_device, **kw)
        w = ctrl_window
        self.cw = w
        self.harq_delay = 5 * w
        self.ul_grant_delay = 5 * w
        self.simul_pucch_pusch = True
        self.apcqi_interval = 10 ** 9  # aperiodic CQI needs UCI on PUSCH
        # the inactivity release must outlive the stretched feedback round
        # trip (grant → PUSCH → windowed decode ≈ 2·D; the base's is 40)
        self.ul_inactivity_timeout = 6 * self.harq_delay
        self.n_harq_w = 6 * w + 32
        self.sched = Scheduler(cell.nof_prb, mcs_max=self.sched.mcs_max, n_harq=self.n_harq_w,
                               sync_dl_harq=True, max_grants_per_tti=1)
        self.phy_device = self.device if phy_device is None else resolve(phy_device)
        self._dl_gen = WindowedEnbDl(cell, cfi=self.cfi, w=w, template="full",
                                     device=self.phy_device)
        # 2 edge PRBs a side cover every configured PUCCH resource (n_pucch
        # <= ~28 → PRB index m <= 1)
        self._ul_fe = WindowedEnbUlFrontEnd(cell, w=w, edge_prbs=2, device=self.phy_device)
        self._zero_row = torch.zeros(cell.sf_len, dtype=torch.complex64, device=self.phy_device)
        # DL render pipeline: window j → its (W, sf_len) samples on the device
        self._dl_disp: dict[int, torch.Tensor] = {}
        self._dl_rows: dict[int, torch.Tensor] = {}
        # UL pipeline
        self._ul_rows: dict[int, torch.Tensor] = {}
        self._ul_fe_q: deque = deque()    # front ends in flight
        self._ul_data_q: deque = deque()  # PUSCH data windows in flight
        # device link (WindowedDeviceLoopback): the loopback moves whole
        # windows between the stacks
        self.device_link = False
        self._ul_dev_win: dict[int, torch.Tensor] = {}
        self._dl_stage = None
        self._dispatch_dl_window(0)
        self._dispatch_dl_window(1)

    # ---- DL: schedule a window ahead, render it in one dispatch.  The
    # per-TTI scheduling and overlay render is staged across the preceding
    # window's ticks (row i by tick i), so that no single run_tti carries W
    # TTIs of host work; the dispatch happens at the boundary. ----

    def _sched_dl_row(self, t: int):
        sf = t % 10
        sched = self._sched_dl(t, sf)
        if len(sched.grants) > 1:
            raise RuntimeError("windowed TX: one grant a TTI")
        if sched.grants:
            g, tb = sched.grants[0]
            payload = np.asarray(tb, np.uint8)
        else:
            g = _pad_dl_grant(self.cell)
            payload = np.zeros(16, np.uint8)
        idx, vals = enb_ctrl_overlay(self.cell, self.cfi, sf, sched, mib=self.mib,
                                     sfn=(t // 10) % 1024)
        return sf, g, payload, idx, vals

    def _render(self, j: int, rows):
        self._dl_disp[j] = self._dl_gen.dispatch_window(
            [r[2] for r in rows], [r[0] for r in rows], [r[1] for r in rows],
            overlay=(np.stack([r[3] for r in rows]), np.stack([r[4] for r in rows])))

    def _dispatch_dl_window(self, j: int):
        w = self.cw
        self._render(j, [self._sched_dl_row(t) for t in range(j * w, j * w + w)])

    def _dl_stage_tick(self, tti: int):
        w = self.cw
        j = tti // w + 2
        tt = tti % w
        st = self._dl_stage
        if st is None or st["j"] != j:
            st = self._dl_stage = {"j": j, "i": 0, "rows": []}
        while st["i"] < w and st["i"] <= tt:
            st["rows"].append(self._sched_dl_row(j * w + st["i"]))
            st["i"] += 1
        if tt == w - 1:
            self._render(j, st["rows"])
            self._dl_stage = None

    def _dl_pop(self, tti: int) -> torch.Tensor:
        j = tti // self.cw
        if tti not in self._dl_rows:
            out = self._dl_disp.pop(j)
            for i in range(self.cw):
                self._dl_rows[j * self.cw + i] = out[i]
        return self._dl_rows.pop(tti)

    # ---- UL: front-end window → PUCCH host decode + PUSCH data window ----

    def push_ul_window_dev(self, m: int, rx_dev: torch.Tensor, prach_rows=None):
        """Device link: receive UL window m as a (W, nrx, sf_len) complex64
        tensor on the device; the PRACH subframes of the window arrive beside
        it as {tti: row} device rows (attach only)."""
        self._ul_dev_win[m] = rx_dev
        for u, row in (prach_rows or {}).items():
            self._prach_ingest(u + 1, row)

    def _ul_flush(self, tti: int):
        """Dispatch the UL front end once window m's last row arrived."""
        w = self.cw
        u_last = tti - 1
        if u_last < 0 or u_last % w != w - 1:
            return
        m = u_last // w
        first = m * w
        if self.device_link:
            samples = self._ul_dev_win.pop(m, None)
            if samples is None:
                return
        else:
            samples = torch.stack([self._ul_rows.pop(u, self._zero_row)
                                   for u in range(first, first + w)])[:, None]
        pf = self._ul_fe.dispatch(samples, [u % 10 for u in range(first, first + w)])
        self._ul_fe_q.append(dict(t=tti, first=first, pf=pf))

    def _f1_grid(self, edge, i: int, u: int, n_pucch: int) -> np.ndarray:
        prbs = tuple(pucch_f1_prb(n_pucch, 2 * (u % 10) + sl, self.cell.nof_prb, 2,
                                  covers=_f1_covers(self.cell)) for sl in range(2))
        return self._ul_fe.pucch_prb_grid(edge, i, prbs)

    def _window_acks(self, first: int, edge, prb_pow, window_acks):
        """HARQ-ACK decodes batched per resource (the saturated single-UE
        stream uses one n_pucch): the window's format-1 correlations of a
        resource run as one vectorised pass."""
        jobs: dict[int, list] = {}  # n_pucch -> [(i, rnti, entries)]
        for i, acks in enumerate(window_acks):
            by_rnti: dict[int, list] = {}
            for e in acks:
                by_rnti.setdefault(e["rnti"], []).append(e)
            for rnti, entries in by_rnti.items():
                if float(np.max(prb_pow[i])) >= 1e-7:
                    jobs.setdefault(entries[-1]["n_pucch"], []).append((i, rnti, entries))
                else:  # DTX: nothing on air
                    for e in entries:
                        self.sched.ack_info(rnti, e["pid"], False)
                        self.stats["dl_nack"] = self.stats.get("dl_nack", 0) + 1
        for n_pucch, rows in jobs.items():
            g_rows = np.stack([self._f1_grid(edge, i, first + i, n_pucch) for i, _r, _e in rows])
            bb, mm = pucch_format1_decode_batch(g_rows, self.cell, n_pucch,
                                                [(first + i) % 10 for i, _r, _e in rows], 1)
            for (_i, rnti, entries), bit, metric in zip(rows, bb, mm):
                ack = float(metric) > 0.25 and int(bit[0]) == 1
                for e in entries:
                    self.sched.ack_info(rnti, e["pid"], ack)
                    key = "dl_ack" if ack else "dl_nack"
                    self.stats[key] = self.stats.get(key, 0) + 1

    def _ul_realize_fe(self, ent, tti: int):
        """The front end of one UL window on the host: ACKs, periodic CQI,
        SR, the PUSCH power gates; dispatches the window's data decode."""
        w = self.cw
        first, pf = ent["first"], ent["pf"]
        edge, prb_pow = self._ul_fe.realize_pucch(pf)
        window_acks = [self.pending_dl_ack.pop(first + i, []) for i in range(w)]
        self._window_acks(first, edge, prb_pow, window_acks)
        # grants indexed by window slot: dispatch_data row i decodes from
        # slot i's stored grid
        grants = [_pad_ul_grant() for _ in range(w)]
        soft = [None] * w
        metas = []
        for i in range(w):
            u = first + i
            sf = u % 10
            has_energy = float(np.max(prb_pow[i])) >= 1e-7
            # periodic CQI/RI on PUCCH 2 (ACK-free occasions only)
            if cqi_on_pusch(u) and has_energy:
                ack_rntis = {e["rnti"] for e in window_acks[i]}
                for rnti_c, ue_c in self.ues.items():
                    if ue_c.rrc_state < self.RRC_ACTIVE or rnti_c in ack_rntis:
                        continue
                    cfg2 = PucchConfig(n_pucch=_cqi_resource(rnti_c))
                    nb = 1 if (cqi_report_is_ri(u) and self.tm >= 3) else 4
                    bits, metric = pucch_format2_decode_np(
                        self._f1_grid(edge, i, u, cfg2.n_pucch), self.cell, cfg2, sf, nb)
                    if metric <= 0.25:
                        continue
                    self.sched.cqi_info(rnti_c, int("".join(str(x) for x in bits[:4]), 2))
                    ue_c.last_cqi_tti = u
                    self.stats["cqi_pucch_rx"] = self.stats.get("cqi_pucch_rx", 0) + 1
            if _is_sr_sf(self.sr_enabled, None, u) and has_energy:
                for rnti_s, ue_s in self.ues.items():
                    if ue_s.rrc_state < self.RRC_SETUP_SENT:
                        continue
                    cfgs = PucchConfig(n_pucch=_sr_resource(rnti_s))
                    _b, metric = pucch_format1_decode(self._f1_grid(edge, i, u, cfgs.n_pucch),
                                                      self.cell, cfgs, sf, 0)
                    if float(metric) > 0.25:
                        self.sched.ul_bsr(rnti_s, 128)
                        self.stats["sr_detected"] = self.stats.get("sr_detected", 0) + 1
            # the PUSCH row, gated on the allocation's own receive power
            # (an empty allocation's zero LLRs decode to the valid all-zero
            # codeword)
            pu = self.pending_ul.pop(u, None)
            if pu is None:
                continue
            rnti, grant = pu
            alloc_pow = float(np.mean(prb_pow[i, grant.prb_start: grant.prb_start + grant.nof_prb]))
            alloc_ok = alloc_pow >= 1e-7
            ue_ctx = self.ues.get(rnti)
            if ue_ctx is not None and alloc_ok:
                ue_ctx.last_ul_rx_db = 10.0 * np.log10(max(alloc_pow, 1e-12))
            # the UL HARQ state is taken by TTI; `_release_ue` prunes a
            # released UE's entries with its grants
            hs = self._ul_harq.pop(u, None)
            if not alloc_ok:  # DTX: nothing on the allocation → NACK
                self._complete_ul_data(dict(tti=u, rnti=rnti, grant=grant, ok=False, tb=None,
                                            tx_count=(hs[1] + 1) if hs else 1, soft=None))
                continue
            sbw, txc = None, 1
            if hs is not None:
                sb0, txc0 = hs
                txc = txc0 + 1
                if isinstance(sb0, tuple) and len(sb0) == 2 and sb0[0] == "win":
                    sbw = sb0[1]
            grants[i] = grant
            soft[i] = sbw
            metas.append(dict(row=i, tti=u, rnti=rnti, grant=grant, tx_count=txc))
        # a window with no PUSCH is not decoded: the set of kernel shapes
        # stays that of the windows that carry data
        if metas:
            if all(s is None for s in soft):
                soft = None
            p = self._ul_fe.dispatch_data(pf, grants, softbuffer=soft)
            self._ul_data_q.append(dict(t=tti, p=p, metas=metas))

    def _ul_poll(self, tti: int):
        while self._ul_fe_q and _due(self._ul_fe_q[0], tti):
            self._ul_realize_fe(self._ul_fe_q.popleft(), tti)
        while self._ul_data_q and _due(self._ul_data_q[0], tti):
            ent = self._ul_data_q.popleft()
            p = ent["p"]
            res = self._ul_fe.results(p)
            for meta in ent["metas"]:
                tb, ok, _n = res[meta["row"]]
                self._complete_ul_data(dict(
                    tti=meta["tti"], rnti=meta["rnti"], grant=meta["grant"], ok=bool(ok), tb=tb,
                    tx_count=meta["tx_count"],
                    soft=None if ok else extract_softbuffer(p, meta["row"])))

    def _prach_ingest(self, tti: int, samples: torch.Tensor | None):
        """PRACH detection on a received row (attach only): the power gate,
        the metric, delays and detections on the device, read in one
        transfer."""
        u = tti - 1
        if samples is None or u % 10 != self.prach_sf:
            return
        cp, nfft = prach_cp_len(self.cell), prach_nfft(self.cell)
        win = samples[cp: cp + nfft]
        if win.shape[0] != nfft:
            return
        _metric, delay, det = prach_detect(self.cell, self.prach_cfg, win, device=self.phy_device)
        host = torch.cat([torch.mean(win.abs() ** 2).reshape(1).to(torch.float32),
                          det.to(torch.float32), delay.to(torch.float32)]).cpu().numpy()
        if host[0] <= 1e-6:
            return
        det, delay = host[1: 1 + det.shape[0]], host[1 + det.shape[0]:]
        known = {ue.rapid for ue in self.ues.values() if ue.rrc_state < self.RRC_CONNECTED}
        for rapid in np.nonzero(det)[0]:
            rapid = int(rapid)
            if rapid in known or any(r[0] == rapid for r in self.pending_rars):
                continue
            ta = max(0, int(round(float(delay[rapid]))))
            ue = self._new_ue(rapid)
            self.pending_rars.append((rapid, ta, ue.crnti))
            self.stats["prach_detected"] += 1

    def run_tti(self, ul_samples: torch.Tensor | None) -> torch.Tensor | None:
        """One TTI: take the UE's UL subframe of the previous TTI ((sf_len,)
        complex64 on the engines' device, or None) and return this TTI's DL
        subframe there (None on the device link, where the loopback moves
        whole windows)."""
        tti = self.tti
        for u in self.ues.values():
            for ent in (u.srb1_rlc, u.drb_rlc):
                if hasattr(ent, "tick"):
                    ent.tick()
        if not self.device_link:
            if ul_samples is not None:
                self._ul_rows[tti - 1] = ul_samples
            self._prach_ingest(tti, ul_samples)
        self._ul_flush(tti)
        self._ul_poll(tti)
        if hasattr(self.mme, "pump_s11"):
            self.mme.pump_s11()
        for ue in list(self.ues.values()):
            if ue.release_at >= 0:
                if tti >= ue.release_at:
                    self._release_ue(ue)
                continue
            if ue.rrc_state != self.RRC_IDLE and tti - ue.last_ul_ok_tti > self.ul_inactivity_timeout:
                self._send_srb1(ue, rrc.pack_conn_release())
                ue.release_at = tti + 15
        self._pump_spgw()
        dl = None if self.device_link else self._dl_pop(tti)
        self._dl_stage_tick(tti)
        self.tti += 1
        return dl


# ==========================================================================
# UE
# ==========================================================================


class WindowedCtrlUe(UeStack):
    """UE with buffered DL windows, the batched blind search, and UL windows
    generated two windows ahead under the stretched-feedback contract."""

    def __init__(self, cell: Cell, usim, ctrl_window: int = 16, phy_device=None, **kw):
        _check_window(cell, ctrl_window)
        if kw.get("tdd_cfg") is not None:
            raise ValueError("the windowed control plane is FDD")
        kw.setdefault("cfi", 2)
        super().__init__(cell, usim, phy_device=phy_device, **kw)
        w = ctrl_window
        self.cw = w
        self.harq_delay = 5 * w
        self.ul_grant_delay = 5 * w
        self.n_harq_w = 6 * w + 32
        self.phy_device = self.device if phy_device is None else resolve(phy_device)
        self._fe = WindowedUeFrontEnd(cell, cfi=self.cfi, w=w, scheme="port0",
                                      max_iterations=self.expert.pdsch_max_its,
                                      device=self.phy_device)
        self._ul_gen = WindowedUeUl(cell, w=w, device=self.phy_device)
        self._rx_rows: dict[int, torch.Tensor] = {}
        self._fe_q: deque = deque()    # control front ends in flight
        self._data_q: deque = deque()  # PDSCH data windows in flight
        self._vit_q: deque = deque()   # control realised, the Viterbi in flight
        self._win_soft: dict = {}      # pid -> (ndi, device block)
        self._ul_disp: dict[int, tuple] = {}  # window m -> (out | None, emit, extras, first)
        self._ul_ready: dict[int, torch.Tensor | None] = {}
        self.device_link = False
        self._dl_dev_win: dict[int, torch.Tensor] = {}
        self._ul_stage = None
        self._ul_gen_window(0)
        self._ul_gen_window(1)
        self.stats["ctrl_windows"] = 0

    # ---- device link ----

    def push_dl_window_dev(self, j: int, rx_dev: torch.Tensor):
        """Device link: window j's received baseband, (W, nrx, sf_len)
        complex64 on the device."""
        self._dl_dev_win[j] = rx_dev

    def pop_ul_window_dev(self, m: int):
        """Device link: hand window m's transmit samples to the loopback —
        ((W, sf_len) complex64 on the device or None, the PRACH rows {tti:
        row})."""
        out, _emit, extras, _first = self._ul_disp.pop(m)
        return out, extras

    # ---- DL control + data ----

    def _flush_fe(self, tti: int):
        if tti % self.cw != self.cw - 1:
            return
        first = tti - self.cw + 1
        if self.device_link:
            samples = self._dl_dev_win.pop(first // self.cw, None)
            if samples is None:
                return
        else:
            samples = torch.stack([self._rx_rows.pop(first + i) for i in range(self.cw)])[:, None]
        pf = self._fe.dispatch(samples, [t % 10 for t in range(first, first + self.cw)])
        self._fe_q.append(dict(t=tti, first=first, pf=pf))
        self.stats["ctrl_windows"] += 1

    def _search_requests(self) -> list:
        """The RNTIs the blind search looks for (`_process_dl`'s set)."""
        len_1a = Dci1A.nof_bits(self.cell.nof_prb)
        reqs = []
        if self.acquire_si and (self.sib1 is None or self.sib2 is None):
            reqs.append((SIRNTI, "1A", len_1a, False))
        if self.rrc_state == self.RRC_WAIT_RAR:
            reqs.append((1 + self.prach_sf, "1A", len_1a, False))
        if self.crnti is not None:
            reqs.append((self.crnti, "1A", len_1a, True))
        return reqs

    def _ctrl_stage(self, ent, tti: int):
        """Realise the front end, handle the measurements and dispatch the
        batched Viterbi; the DCI parse runs `RD` TTIs later, so that the
        Viterbi's round trip rides quiet TTIs."""
        w = self.cw
        first, pf = ent["first"], ent["pf"]
        ctrl, rsrp, noise = self._fe.realize(pf)
        snr = np.mean(rsrp) / max(float(np.mean(noise)), 1e-12)
        snr_db = 10.0 * np.log10(max(snr, 1e-12))
        a = self.expert.snr_ema_coeff
        prev = getattr(self, "_dl_snr_db", None)
        self._dl_snr_db = snr_db if prev is None else (1 - a) * prev + a * snr_db
        self._dl_rsrp_dbfs = 10.0 * np.log10(float(np.mean(rsrp)) + 1e-12)
        sfs = [(first + i) % 10 for i in range(w)]
        vit = blind_search_dispatch(ctrl, self._fe.layout, self.cell, sfs,
                                    [self._search_requests()] * w, device=self.phy_device)
        self._vit_q.append(dict(t=tti, first=first, pf=pf, ctrl=ctrl, sfs=sfs, vit=vit))

    def _phich_watch(self, t: int, ctrl_row, sf: int):
        """The PHICH of a PUSCH in flight (UL HARQ, stretched chain)."""
        inflight = self._ul_inflight.pop(t, None)
        if inflight is None or self.crnti is None:
            return
        g_fl, tb_fl, txc = inflight
        group, n_seq = _phich_resource(self.cell, g_fl)
        ack, _m = phich_decode_np(ctrl_row[self._fe.layout.phich[group]], self.cell, sf, n_seq)
        if not ack and txc < UL_HARQ_MAX_TX:
            g2 = dataclasses.replace(g_fl, rv=HARQ_RV_SEQ[txc % 4])
            self.pending_retx[t + self.ul_grant_delay] = (g2, tb_fl, txc + 1)
            self.stats["ul_retx"] = self.stats.get("ul_retx", 0) + 1

    def _dl_grant_of(self, rnti: int, dci: Dci1A) -> DlGrant:
        rb0, l_crb = riv_decode(self.cell.nof_prb, dci.riv)
        prb = tuple(range(rb0, rb0 + l_crb))
        if rnti >= 0xFFF4 or rnti <= 0x0042:
            n_prb_1a = 3 if (dci.tpc & 1) else 2
            return DlGrant(prb=prb, mod=Mod.QPSK, tbs=tbs_lookup(dci.mcs, n_prb_1a), rv=dci.rv,
                           rnti=rnti)
        return DlGrant(prb=prb, mod=dl_mcs_to_mod(dci.mcs), tbs=dl_tbs(dci.mcs, l_crb), rv=dci.rv,
                       rnti=rnti)

    def _viterbi_stage(self, ent, tti: int):
        """Collect the blind search, act on the found DCIs and dispatch the
        window's data decode from the stored front end."""
        w = self.cw
        first, pf, ctrl, sfs = ent["first"], ent["pf"], ent["ctrl"], ent["sfs"]
        found = blind_search_collect(ent["vit"])
        # grants indexed by window slot (dispatch_data row i reads slot i's
        # stored grid)
        grants = [_pad_dl_grant(self.cell) for _ in range(w)]
        soft = [None] * w
        metas = []
        for i in range(w):
            t = first + i
            self._phich_watch(t, ctrl[i], sfs[i])
            got_dl = False
            for rnti, _fmt, bits, _agg, cce in found[i]:
                if bits[0] == 0 and rnti == self.crnti:
                    # DCI 0: the UL grant at the stretched delay
                    dci0 = Dci0.unpack(bits, self.cell.nof_prb)
                    self.ul_gain_db = float(np.clip(self.ul_gain_db + (-1, 0, 1, 3)[dci0.tpc],
                                                    -20.0, 20.0))
                    try:
                        rb0, l_crb = riv_decode(self.cell.nof_prb, dci0.riv)
                        g_ul = UlGrant(prb_start=rb0, nof_prb=l_crb, mod=ul_mcs_to_mod(dci0.mcs),
                                       tbs=tbs_lookup(ul_mcs_to_itbs(dci0.mcs), l_crb), rnti=rnti)
                    except (ValueError, IndexError):
                        continue  # a CRC-RNTI false positive
                    self.pending_tx[t + self.ul_grant_delay] = g_ul
                    continue
                if got_dl:
                    continue  # one DL grant a subframe
                try:
                    dci = Dci1A.unpack(bits, self.cell.nof_prb)
                    grant = self._dl_grant_of(rnti, dci)
                except (ValueError, IndexError):
                    continue  # a CRC-RNTI false positive
                if grant.tbs <= 0:
                    continue
                got_dl = True
                pid = t % self.n_harq_w
                sb = None
                if rnti == self.crnti:
                    st = self._win_soft.get(pid)
                    if st is not None and st[0] == dci.ndi:
                        sb = st[1]
                grants[i] = grant
                soft[i] = sb
                metas.append(dict(row=i, tti=t, rnti=rnti, dci=dci, cce=cce, pid=pid))
        # a window with no PDSCH is not decoded (bounded kernel shapes)
        if metas:
            if all(s is None for s in soft):
                soft = None
            p = self._fe.dispatch_data(pf, grants, softbuffer=soft)
            self._data_q.append(dict(t=tti, p=p, metas=metas))

    def _poll_fe(self, tti: int):
        while self._fe_q and _due(self._fe_q[0], tti):
            self._ctrl_stage(self._fe_q.popleft(), tti)
        while self._vit_q and _due(self._vit_q[0], tti):
            self._viterbi_stage(self._vit_q.popleft(), tti)
        while self._data_q and _due(self._data_q[0], tti):
            ent = self._data_q.popleft()
            p = ent["p"]
            res = self._fe.results(p)
            for meta in ent["metas"]:
                tb, ok, _n = res[meta["row"]]
                self._complete_row(meta, tb, bool(ok), p)

    def _complete_row(self, meta, tb, ok, p):
        rnti, t = meta["rnti"], meta["tti"]
        if rnti != self.crnti:
            if not ok:
                return
            pdu = np.packbits(tb).tobytes()
            self.stats["dl_tbs_ok"] += 1
            if rnti == 0xFFFF:
                self._handle_si(pdu)
            elif rnti == 0xFFFE:
                self._handle_paging(pdu)
            else:
                self._handle_rar(t, pdu)
            return
        # C-RNTI: HARQ feedback and duplicate suppression at the TTI's pid
        # (_complete_dl_data with the synchronous pid)
        dci, pid = meta["dci"], meta["pid"]
        if ok:
            self._win_soft.pop(pid, None)
        else:
            self._win_soft[pid] = (dci.ndi, extract_softbuffer(p, meta["row"]))
        last = self._dl_ndi.get(pid)
        is_dup = last is not None and last[0] == dci.ndi and last[1]
        self._dl_ndi[pid] = (dci.ndi, ok or is_dup)
        self.pending_ack.setdefault(t + self.harq_delay, []).append(
            (meta["cce"], 1 if (ok or is_dup) else 0, t))
        if ok and not is_dup:
            self.stats["dl_tbs_ok"] += 1
            self._handle_dl_pdu(np.packbits(tb).tobytes())

    # ---- UL generation, two windows ahead ----

    def _ul_new_stage(self, m: int):
        w = self.cw
        return {"m": m, "i": 0, "grants": [], "payloads": [], "sfs": [], "extras": {},
                "live": np.zeros(w, bool),
                "pgrids": np.zeros((w, self.cell.nsymb_per_sf, 12), np.complex64),
                "pprb": np.zeros((w, 2), np.int32), "has_pucch": np.zeros(w, bool)}

    def _put_pucch(self, st: dict, i: int, sf: int, cfg: PucchConfig, block: np.ndarray):
        st["pgrids"][i] += block
        for slot in range(2):
            st["pprb"][i, slot] = pucch_f1_prb(cfg.n_pucch, 2 * sf + slot, self.cell.nof_prb,
                                               cfg.delta_shift, covers=_f1_covers(self.cell))
        st["has_pucch"][i] = True

    def _ul_gen_row(self, st: dict):
        """Stage one UL row (the feedback this row needs is realised at
        least a window before its stage tick)."""
        w = self.cw
        i = st["i"]
        st["i"] += 1
        u = st["m"] * w + i
        sf = u % 10
        grants, payloads = st["grants"], st["payloads"]
        st["sfs"].append(sf)
        # the PRACH decision (attach), by the _build_ul gate, committed at
        # generation time (the windowed contract's look-ahead)
        if (self.rrc_state == self.RRC_IDLE and sf == self.prach_sf and u >= self.attach_delay
                and self._si_ready() and not self.idle_camped):
            self.mac.start_ra(self.preamble)
            self.rrc_state = self.RRC_WAIT_RAR
            self._ra_deadline = u + self.ul_grant_delay + 4 * w
            st["extras"][u] = self._prach_subframe(self.preamble)
            grants.append(_pad_ul_grant())
            payloads.append(np.zeros(16, np.uint8))
            return
        if self.rrc_state == self.RRC_WAIT_RAR and u >= getattr(self, "_ra_deadline", 1 << 62):
            self.rrc_state = self.RRC_IDLE
        acks = self.pending_ack.pop(u, None)
        grant = self.pending_tx.pop(u, None)
        retx = self.pending_retx.pop(u, None)
        if acks:
            bit = 1 if all(b for _, b, _t in acks) else 0
            cfg = PucchConfig(n_pucch=acks[-1][0])
            self._put_pucch(st, i, sf, cfg, pucch_format1_encode_np(self.cell, cfg, sf, [bit]))
        elif (cqi_on_pusch(u) and self.rrc_state == self.RRC_ACTIVE and grant is None
                and retx is None):
            bits = np.array([int(b) for b in np.binary_repr(self._report_cqi(), 4)], np.uint8)
            cfg = PucchConfig(n_pucch=_cqi_resource(self.crnti))
            self._put_pucch(st, i, sf, cfg, pucch_format2_encode_np(self.cell, cfg, sf, bits))
            self.stats["cqi_pucch_sent"] = self.stats.get("cqi_pucch_sent", 0) + 1
        elif (_is_sr_sf(self.sr_enabled, None, u) and self.rrc_state >= self.RRC_CONNECTED
                and self._buffer_state() > 0 and not self.pending_tx):
            cfg = PucchConfig(n_pucch=_sr_resource(self.crnti))
            self._put_pucch(st, i, sf, cfg, pucch_format1_encode_np(self.cell, cfg, sf, []))
            self.stats["sr_sent"] = self.stats.get("sr_sent", 0) + 1
        # the PUSCH (pure data; UCI rides the parallel PUCCH)
        if retx is not None and grant is None:
            g2, tb_bits, txc = retx
            grants.append(g2)
            payloads.append(np.asarray(tb_bits, np.uint8))
            st["live"][i] = True
            self._ul_inflight[u + self.harq_delay] = (g2, tb_bits, txc)
        elif grant is not None:
            mac_pdu = self._build_ul_mac_pdu(grant.tbs // 8)
            tb_bits = np.unpackbits(np.frombuffer(mac_pdu, np.uint8))
            grants.append(grant)
            payloads.append(tb_bits)
            st["live"][i] = True
            self._ul_inflight[u + self.harq_delay] = (grant, tb_bits, 1)
        else:
            grants.append(_pad_ul_grant())
            payloads.append(np.zeros(16, np.uint8))

    def _ul_dispatch_stage(self, st: dict):
        emit = st["live"] | st["has_pucch"]
        out = None
        if emit.any():
            out = self._ul_gen.dispatch_window(st["payloads"], st["sfs"], st["grants"],
                                               pucch=(st["pprb"], st["pgrids"], st["live"]))
        self._ul_disp[st["m"]] = (out, emit, st["extras"], st["m"] * self.cw)

    def _ul_gen_window(self, m: int):
        """Generate UL window m in one go (the bootstrap windows)."""
        st = self._ul_new_stage(m)
        while st["i"] < self.cw:
            self._ul_gen_row(st)
        self._ul_dispatch_stage(st)

    def _ul_stage_tick(self, tti: int):
        """Stage the UL rows of window tti//W + 2 across this window's ticks:
        row i by tick max(12, i), the earliest tick at which all the
        feedback row i consumes is realised; dispatch at the boundary."""
        w = self.cw
        m = tti // w + 2
        tt = tti % w
        st = self._ul_stage
        if st is None or st["m"] != m:
            st = self._ul_stage = self._ul_new_stage(m)
        while st["i"] < w and max(12, st["i"]) <= tt:
            self._ul_gen_row(st)
        if tt == w - 1:
            while st["i"] < w:
                self._ul_gen_row(st)
            self._ul_dispatch_stage(st)
            self._ul_stage = None

    def _ul_pop(self, tti: int) -> torch.Tensor | None:
        m = tti // self.cw
        if m in self._ul_disp:
            out, emit, extras, first = self._ul_disp.pop(m)
            gain = float(np.float32(10.0 ** (self.ul_gain_db / 20.0)))
            for i in range(self.cw):
                u = first + i
                row = out[i] * gain if (out is not None and emit[i]) else None
                ex = extras.get(u)
                if ex is not None:
                    row = ex if row is None else row + ex
                if row is not None and self.ta_samples:
                    row = torch.roll(row, -self.ta_samples)
                self._ul_ready[u] = row
        return self._ul_ready.pop(tti, None)

    def run_tti(self, dl_samples: torch.Tensor | None) -> torch.Tensor | None:
        """One TTI: take this TTI's DL subframe ((sf_len,) complex64 on the
        engines' device; None on the device link) and return the UL subframe
        to send there, or None."""
        tti = self.tti
        for ent in (self.srb1_rlc, self.drb_rlc):
            if hasattr(ent, "tick"):
                ent.tick()
        if not self.device_link:
            self._rx_rows[tti] = dl_samples
        self._flush_fe(tti)
        self._poll_fe(tti)
        if self.gw is not None and self.rrc_state == self.RRC_ACTIVE:
            self.gw.pump_ul(self.send_ip_packet)
        ul = None if self.device_link else self._ul_pop(tti)
        self._ul_stage_tick(tti)
        self.tti += 1
        return ul


# ==========================================================================
# device-resident loopback: the serving topology.  The baseband never
# leaves the device; the host carries only payload bits and the control
# reads (cf. the reference's single-host srsenb↔srsue ZMQ link).
# ==========================================================================


class WindowedDeviceLoopback:
    """Drive a `WindowedCtrlEnb` and a `WindowedCtrlUe` over a flat channel
    with AWGN on the device (`window_channel`, noise from a
    `torch.Generator` seeded per window).  One `step()` is one TTI of both
    ends."""

    def __init__(self, enb: WindowedCtrlEnb, ue: WindowedCtrlUe, snr_db: float = 30.0,
                 seed: int = 1):
        if enb.cw != ue.cw:
            raise ValueError(f"the ends' windows differ: {enb.cw} and {ue.cw}")
        enb.device_link = True
        ue.device_link = True
        self.enb = enb
        self.ue = ue
        self.w = enb.cw
        self.device = enb.phy_device
        self._noise = float(10.0 ** (-snr_db / 20.0))
        self._seed = seed
        self._zeros = torch.zeros((self.w, enb.cell.sf_len), dtype=torch.complex64,
                                  device=self.device)

    def _channel(self, tx: torch.Tensor, gain: float, seed: int) -> torch.Tensor:
        """(W, sf_len) transmit window → (W, 1, sf_len) received window."""
        return window_channel(tx, np.array([[gain]], np.complex64), float(self._noise), seed,
                              device=self.device)

    def step(self):
        enb, ue, w = self.enb, self.ue, self.w
        tti = enb.tti
        # UL window m reaches the eNB when its last TTI has aired
        if tti % w == 0 and tti > 0:
            m = tti // w - 1
            out, extras = ue.pop_ul_window_dev(m)
            if out is not None:
                rx = self._channel(out, float(10.0 ** (ue.ul_gain_db / 20.0)), self._seed + 2 * tti)
            else:
                rx = self._channel(self._zeros, 0.0, self._seed + 2 * tti)
            enb.push_ul_window_dev(m, rx, prach_rows=extras)
        # DL window j reaches the UE at its flush boundary
        if tti % w == w - 1:
            j = tti // w
            ue.push_dl_window_dev(j, self._channel(enb._dl_disp.pop(j), 1.0,
                                                   self._seed + 2 * tti + 1))
        enb.run_tti(None)
        ue.run_tti(None)

    def run(self, n_ttis: int):
        for _ in range(n_ttis):
            self.step()
