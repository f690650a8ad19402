"""Host copy of `srsran_tpu/stack/mac.py`, held to it by `tests/test_torch_stack.py`.

MAC layer: eNB scheduler + HARQ entities + UE MAC procedures,
TS 36.321 (re-design of `srsenb/src/stack/mac/scheduler*.cc`,
`srsue/src/stack/mac/{dl,ul}_harq.cc`, `proc_ra.cc`, `proc_bsr.cc`).

The eNB side keeps the reference's FAPI-like synchronous pull contract
(`mac_interface_phy_lte::get_dl_sched/get_ul_sched`, enb_interfaces.h:181):
the PHY worker calls `get_dl_sched(tti)` and receives a list of grants
with fully-built MAC PDUs; feedback flows back via `ack_info/crc_info`.

Scheduling metric: round-robin over active UEs (scheduler_metric.h:29,46),
allocating contiguous PRB spans (RA type 2 / DCI 1A) with HARQ
retransmissions taking priority over new data (scheduler_harq.cc).
"""

from __future__ import annotations

import dataclasses
from collections import deque

from .mac_pdu import DL_CE_SIZES, LCID_PADDING, UL_CE_SIZES, mac_pack, mac_unpack

# UL-SCH MAC control element LCIDs (TS 36.321 Table 6.2.1-2)
LCID_CCCH = 0
LCID_PHR = 26
LCID_CRNTI = 27
LCID_TRUNC_BSR = 28
LCID_SHORT_BSR = 29
LCID_LONG_BSR = 30
# DL-SCH control element LCIDs (Table 6.2.1-1)
LCID_CON_RES = 28
LCID_TA_CMD = 29

HARQ_RV_SEQ = [0, 2, 3, 1]  # redundancy version cycling (dl_harq.cc)
N_HARQ = 8
FDD_FB_DELAY = 4  # ACK at TTI+4


def phr_index(ph_db: float) -> int:
    """Power-headroom CE value (TS 36.321 §6.1.3.6, 36.133 Table
    9.1.8.4-1): PH index = PH_dB + 23, clipped to 0..63 (−23..+40 dB)."""
    return int(max(0, min(63, round(ph_db + 23))))


def phr_db(index: int) -> int:
    """Inverse of phr_index (ue.cc get_phr on the eNB side)."""
    return (index & 0x3F) - 23


def bsr_index(nof_bytes: int) -> int:
    """TS 36.321 Table 6.1.3.1-1 buffer-size level (geometric levels
    10..150000 over indices 1..62; 0 = empty, 63 = >150000)."""
    if nof_bytes == 0:
        return 0
    if nof_bytes > 150000:
        return 63
    lo = 10.0
    ratio = (150000.0 / 10.0) ** (1.0 / 61.0)
    idx = 1
    level = lo
    while level < nof_bytes and idx < 62:
        level *= ratio
        idx += 1
    return idx


# ---------------------------------------------------------------------------
# HARQ processes
# ---------------------------------------------------------------------------


# CQI -> spectral efficiency (bits/RE), TS 36.213 Table 7.2.3-1
# (reference cqi.c:541-556 cqi_to_coderate; scheduler_ue.cc:1214 picks the
# highest MCS whose efficiency stays under min(cqi_eff, 0.93*Qm))
CQI_TO_EFFICIENCY = [0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
                     1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547]


@dataclasses.dataclass
class DlHarqProc:
    """eNB-side DL HARQ process state (scheduler_harq.cc)."""

    pid: int
    ndi: int = 0
    rv_idx: int = 0
    pdu: bytes | None = None
    tbs_bits: int = 0
    mcs: int = 0
    n_prb: int = 0
    rb_start: int = 0
    pending_ack: bool = False
    tx_tti: int = -1
    retx_count: int = 0
    max_retx: int = 4
    # second codeword (TM3/TM4 spatial multiplexing; the reference runs a
    # tb-pair per pid, scheduler_harq.cc) — None when single-codeword
    pdu2: bytes | None = None
    tbs_bits2: int = 0
    mcs2: int = 0

    def new_tx(self, tti: int, pdu: bytes, tbs_bits: int, mcs: int, n_prb: int,
               rb_start: int = 0, pdu2: bytes | None = None,
               tbs_bits2: int = 0, mcs2: int = 0):
        self.ndi ^= 1
        self.rv_idx = 0
        self.pdu = pdu
        self.tbs_bits = tbs_bits
        self.mcs = mcs
        self.n_prb = n_prb
        self.rb_start = rb_start
        self.pending_ack = True
        self.tx_tti = tti
        self.retx_count = 0
        self.pdu2 = pdu2
        self.tbs_bits2 = tbs_bits2
        self.mcs2 = mcs2

    def retx(self, tti: int):
        self.rv_idx = (self.rv_idx + 1) % 4
        self.retx_count += 1
        self.pending_ack = True
        self.tx_tti = tti

    @property
    def rv(self) -> int:
        return HARQ_RV_SEQ[self.rv_idx]

    def ack(self, is_ack: bool) -> bool:
        """Returns True if the process became free."""
        self.pending_ack = False
        if is_ack or self.retx_count >= self.max_retx:
            self.pdu = None
            return True
        return False


# ---------------------------------------------------------------------------
# eNB scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DlSchedGrant:
    rnti: int
    rb_start: int
    l_crb: int
    mcs: int
    tbs_bits: int
    ndi: int
    rv: int
    harq_pid: int
    pdu: bytes  # MAC PDU bytes (None-padded to TBS/8)
    # second codeword (present → render as DCI 2/2A two-codeword grant)
    pdu2: bytes | None = None
    mcs2: int = 0
    tbs_bits2: int = 0


@dataclasses.dataclass
class UlSchedGrant:
    rnti: int
    rb_start: int
    l_crb: int
    mcs: int
    tbs_bits: int
    ndi: int
    rv: int
    harq_pid: int

    @property
    def nof_prb(self) -> int:
        """Allocation width in PRBs (alias of l_crb, the DCI-0 RIV field)."""
        return self.l_crb


@dataclasses.dataclass
class _SchedUe:
    rnti: int
    dl_harq: list[DlHarqProc]
    bearers: dict[int, object]  # lcid -> RLC entity (read_pdu/buffer_state)
    dl_buffer_override: int = 0  # for CE-only / test traffic
    ce_queue: deque = dataclasses.field(default_factory=deque)  # (lcid, payload)
    ul_pending_bytes: int = 0  # from BSRs
    ul_ndi: int = 0
    cqi: int = 15
    sb_cqi: list | None = None  # per-subband CQI (frequency-selective)
    phr_db: int | None = None  # last power-headroom report (sched_ue.cc:249)
    dl_bytes: int = 0
    ul_bytes: int = 0


class Scheduler:
    """Round-robin DL/UL scheduler (sched class, scheduler.h:60)."""

    def __init__(self, nof_prb: int, mcs_max: int = 9, get_tbs=None,
                 max_grants_per_tti: int = 4, max_retx: int = 4,
                 n_harq: int = N_HARQ, sync_dl_harq: bool = False):
        from ..phy.phch.ra import dl_tbs

        self.nof_prb = nof_prb
        self.mcs_max = mcs_max
        self.max_grants_per_tti = max_grants_per_tti
        self.max_retx = max_retx
        # windowed control plane: the stretched feedback delay needs more
        # than 8 TBs in flight, and the 3-bit DCI pid field can't span
        # them — DL HARQ goes SYNCHRONOUS (pid = tti % n_harq, the LTE UL
        # HARQ discipline applied DL; both ends derive the pid from the
        # TTI, retransmissions ride the pid's own TTI slots)
        self.n_harq = n_harq
        self.sync_dl_harq = sync_dl_harq
        self.ues: dict[int, _SchedUe] = {}
        self.rr_next = 0
        self._tbs = get_tbs or dl_tbs
        self.pending_rar: deque = deque()  # (tti_req, preamble, ta)
        # RNTIs eligible for two-codeword grants (TM3/TM4 + rank-2 report;
        # maintained by the eNB from the UE's RI feedback)
        self.two_cw: set[int] = set()

    # --- config plane (rrc->mac, enb_interfaces.h:273) ---
    def ue_cfg(self, rnti: int):
        if rnti not in self.ues:
            self.ues[rnti] = _SchedUe(
                rnti, [DlHarqProc(i, max_retx=self.max_retx)
                       for i in range(self.n_harq)], {})

    def ue_rem(self, rnti: int):
        self.ues.pop(rnti, None)

    def bearer_ue_cfg(self, rnti: int, lcid: int, rlc_entity):
        self.ue_cfg(rnti)
        self.ues[rnti].bearers[lcid] = rlc_entity

    def push_ce(self, rnti: int, lcid: int, payload: bytes):
        self.ue_cfg(rnti)
        self.ues[rnti].ce_queue.append((lcid, payload))

    # --- feedback plane (phy->mac) ---
    def ack_info(self, rnti: int, harq_pid: int, ack: bool):
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.dl_harq[harq_pid].ack(ack)

    def ul_crc_info(self, rnti: int, ok: bool):
        pass  # UL HARQ simplification: synchronous retx not modeled

    def cqi_info(self, rnti: int, cqi: int):
        """Wideband CQI report (mac.cc cqi_info -> sched_ue::set_dl_cqi)."""
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.cqi = max(1, min(15, cqi))

    def cqi_subband_info(self, rnti: int, wb_cqi: int, offsets):
        """Higher-layer-configured subband report (the decode side of
        cqi.c:41-75): per-subband CQI = wideband + the Table 7.2.1-2
        offset level.  The "<= -1" level (field 3) is open-ended, so the
        scheduler reads it PESSIMISTICALLY (wb - 4): a subband the UE
        could not express is one to route around, which is the entire
        point of frequency-selective allocation."""
        from ..phy.phch.uci import CQI_DIFF_LEVEL

        ue = self.ues.get(rnti)
        if ue is None:
            return
        ue.cqi = max(1, min(15, wb_cqi))
        ue.sb_cqi = []
        for o in offsets:
            lvl = CQI_DIFF_LEVEL[int(o) & 3]
            if lvl < 0:
                lvl = -4
            ue.sb_cqi.append(max(0, min(15, wb_cqi + lvl)))

    # CQI -> spectral efficiency (TS 36.213 Table 7.2.3-1), the
    # frequency-selective metric's rate model
    _CQI_EFF = (0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758,
                1.4766, 1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234,
                5.1152, 5.5547)

    def _fs_alloc(self, sb_cqi, lo: int = 0, hi: int | None = None,
                  max_w: int | None = None) -> tuple[int, int, int]:
        """Frequency-selective placement: the contiguous PRB block inside
        [lo, hi) (width <= max_w) maximizing width x efficiency(min CQI
        in block) — the MCS rides the block's worst subband, so a deep
        notch is worth excluding even at reduced width (the
        scheduler_metric.cc role with per-subband CQI; type-2
        allocations are contiguous).  Returns (rb_start, nof_prb,
        block_cqi)."""
        hi = self.nof_prb if hi is None else hi
        max_w = self.nof_prb if max_w is None else max_w
        # per-PRB CQI from the subband grid
        from ..phy.phch.uci import cqi_hl_subband_size

        k = cqi_hl_subband_size(self.nof_prb)
        prb_cqi = [sb_cqi[min(p // k, len(sb_cqi) - 1)]
                   for p in range(self.nof_prb)]
        best = (lo, min(hi - lo, max_w), 1)
        best_m = -1.0
        for a in range(lo, hi):
            mn = 16
            for b in range(a, min(hi, a + max_w)):
                mn = min(mn, prb_cqi[b])
                m = (b - a + 1) * self._CQI_EFF[max(0, min(15, mn))]
                if m > best_m:
                    best_m = m
                    best = (a, b - a + 1, max(1, min(15, mn)))
        return best

    def ul_phr(self, rnti: int, ph_db: int):
        """Record a UE power-headroom report (mac ue.cc:357-359 →
        sched_ue::ul_phr); negative PHR caps the UL allocation width."""
        if rnti in self.ues:
            self.ues[rnti].phr_db = ph_db

    def ul_bsr(self, rnti: int, nof_bytes: int):
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.ul_pending_bytes = nof_bytes

    # --- the FAPI-like pull (mac.cc:555 get_dl_sched) ---
    def _dl_pending(self, ue: _SchedUe) -> int:
        n = sum(e.buffer_state() if hasattr(e, "buffer_state") else 0 for e in ue.bearers.values())
        n += sum(len(p) + 2 for _, p in ue.ce_queue)
        return n + ue.dl_buffer_override

    def get_dl_sched(self, tti: int, pdsch_nof_re: int | None = None) -> list[DlSchedGrant]:
        """Grants for one TTI (mac.cc:555 / scheduler_grid.cc).

        Retransmissions first (same TBS, so the original PRB count is
        kept), then round-robin new data.  Multiple UEs share the band as
        contiguous type-2 allocations (DCI 1A) split at the allocation
        cursor — up to `max_grants_per_tti`, each later paired with its
        own PDCCH candidate by the caller (alloc_cce)."""
        if not self.ues:
            return []
        rntis = sorted(self.ues)
        grants: list[DlSchedGrant] = []
        cursor = 0  # next free PRB

        # 1. HARQ retransmissions (original l_crb preserved for equal TBS).
        # At most ONE grant per UE per TTI: the UE decodes a single DL
        # grant per subframe, so a second same-RNTI DCI would always be
        # lost as DTX (invariant from scheduler_test_rand.cc, caught by
        # tests/test_mac_rand.py).
        for rnti in rntis:
            ue = self.ues[rnti]
            for h in ue.dl_harq:
                if h.pdu is None or h.pending_ack or h.retx_count >= h.max_retx:
                    continue
                if self.sync_dl_harq and h.pid != tti % self.n_harq:
                    continue  # synchronous: a pid retransmits on its slot
                if len(grants) >= self.max_grants_per_tti or cursor + h.n_prb > self.nof_prb:
                    continue
                h.retx(tti)
                grants.append(DlSchedGrant(
                    rnti, cursor, h.n_prb, h.mcs, h.tbs_bits, h.ndi, h.rv, h.pid,
                    h.pdu, pdu2=h.pdu2, mcs2=h.mcs2, tbs_bits2=h.tbs_bits2))
                cursor += h.n_prb
                break  # one DL grant per UE per TTI

        # 2. round-robin new data over the remaining band
        order = rntis[self.rr_next % len(rntis):] + rntis[: self.rr_next % len(rntis)]
        self.rr_next += 1
        pending_ues = []
        for rnti in order:
            ue = self.ues[rnti]
            if any(g.rnti == rnti for g in grants):
                continue
            if self._dl_pending(ue) == 0:
                continue
            if self.sync_dl_harq:
                # synchronous DL HARQ: new data only on the TTI's own pid
                h_slot = ue.dl_harq[tti % self.n_harq]
                if h_slot.pdu is not None or h_slot.pending_ack:
                    continue
            elif not any(h.pdu is None and not h.pending_ack
                         for h in ue.dl_harq):
                continue
            pending_ues.append(ue)
        pending_ues = pending_ues[: self.max_grants_per_tti - len(grants)]

        # free-PRB intervals: first-fit for wideband UEs (identical to
        # the old cursor packing), best-block-by-subband-CQI for UEs
        # with frequency-selective reports
        ivs = [(cursor, self.nof_prb)] if cursor < self.nof_prb else []
        for i, ue in enumerate(pending_ues):
            free = sum(b - a for a, b in ivs)
            if free <= 0:
                break
            share = free if i == len(pending_ues) - 1 else max(1, free // (len(pending_ues) - i))
            cqi_use = ue.cqi
            if ue.sb_cqi:
                # frequency-selective placement: each UE takes ITS best
                # block of the remaining band, rated by its own subbands
                best, best_m = None, -1.0
                for (a, b) in ivs:
                    cand = self._fs_alloc(ue.sb_cqi, a, b, share)
                    m = cand[1] * self._CQI_EFF[cand[2]]
                    if m > best_m:
                        best_m, best = m, cand
                rb0, share, cqi_use = best
            else:
                a, b = ivs[0]
                rb0 = a
                share = min(share, b - a)
            pending = self._dl_pending(ue)
            n_re = None
            if pdsch_nof_re is not None:
                n_re = max(1, pdsch_nof_re * share // self.nof_prb)
            mcs, tbs_bits = self._pick_mcs(pending, share, n_re, cqi_use)
            if tbs_bits == 0:
                continue
            tb_bytes = tbs_bits // 8
            sdus = []
            while ue.ce_queue:
                lcid, pl = ue.ce_queue[0]
                if sum(len(p) + 3 for _, p in sdus) + len(pl) + 3 > tb_bytes:
                    break
                sdus.append(ue.ce_queue.popleft())
            used = sum(len(p) + 3 for _, p in sdus)
            for lcid, ent in sorted(ue.bearers.items()):
                while used + 8 < tb_bytes:
                    pdu = ent.read_pdu(tb_bytes - used - 3) if hasattr(ent, "read_pdu") else None
                    if pdu is None:
                        break
                    sdus.append((lcid, pdu))
                    used += len(pdu) + 3
            if not sdus:
                if ue.dl_buffer_override:
                    ue.dl_buffer_override = 0
                continue
            if self.sync_dl_harq:
                h = ue.dl_harq[tti % self.n_harq]
            else:
                h = next(h for h in ue.dl_harq
                         if h.pdu is None and not h.pending_ack)
            mac = mac_pack(sdus, tb_bytes, ce_sizes=DL_CE_SIZES)
            # second codeword (TM3/TM4, rank 2): same PRBs and MCS carry a
            # second MAC PDU — doubles the spectral efficiency exactly as
            # the reference's 2-codeword path (pdsch.c:785-1007)
            mac2 = None
            tbs2 = 0
            if ue.rnti in self.two_cw:
                sdus2 = []
                used2 = 0
                for lcid, ent in sorted(ue.bearers.items()):
                    while used2 + 8 < tb_bytes:
                        pdu = ent.read_pdu(tb_bytes - used2 - 3) if hasattr(ent, "read_pdu") else None
                        if pdu is None:
                            break
                        sdus2.append((lcid, pdu))
                        used2 += len(pdu) + 3
                if sdus2 or ue.dl_buffer_override:
                    mac2 = mac_pack(sdus2, tb_bytes, ce_sizes=DL_CE_SIZES)
                    tbs2 = tbs_bits
                    ue.dl_bytes += used2
            h.new_tx(tti, mac, tbs_bits, mcs, share, rb_start=rb0,
                     pdu2=mac2, tbs_bits2=tbs2, mcs2=mcs if mac2 else 0)
            ue.dl_bytes += used
            grants.append(DlSchedGrant(ue.rnti, rb0, share, mcs, tbs_bits, h.ndi, 0,
                                       h.pid, mac, pdu2=mac2, mcs2=mcs if mac2 else 0,
                                       tbs_bits2=tbs2))
            nxt = []
            for (a, b) in ivs:  # carve [rb0, rb0+share) out
                if rb0 >= b or rb0 + share <= a:
                    nxt.append((a, b))
                    continue
                if a < rb0:
                    nxt.append((a, rb0))
                if rb0 + share < b:
                    nxt.append((rb0 + share, b))
            ivs = nxt
        return grants

    def _pick_mcs(self, pending_bytes: int, l_crb: int, pdsch_nof_re: int | None,
                  cqi: int = 15) -> tuple[int, int]:
        """Highest MCS under the CQI efficiency cap (scheduler_ue.cc:1214
        alloc_tbs: coderate <= min(cqi_eff, 0.93*Qm)), stopping early once
        the TBS covers the pending bytes."""
        from ..phy.phch.ra import dl_mcs_to_mod

        max_eff = CQI_TO_EFFICIENCY[max(1, min(15, cqi))]
        best = (0, 0)
        for mcs in range(self.mcs_max + 1):
            tbs = self._tbs(mcs, l_crb)
            if pdsch_nof_re is not None:
                qm = dl_mcs_to_mod(mcs).bits_per_symbol
                eff = (tbs + 24) / pdsch_nof_re
                if eff > min(max_eff, 0.93 * qm) and best[1] > 0:
                    break
            best = (mcs, tbs)
            if tbs // 8 >= pending_bytes + 8:
                break
        return best

    def get_ul_sched(self, tti: int) -> list[UlSchedGrant]:
        from ..phy.phch.ra import ul_mcs_to_itbs, tbs_lookup

        for rnti in sorted(self.ues):
            ue = self.ues[rnti]
            if ue.ul_pending_bytes > 0:
                mcs = min(self.mcs_max, 20)
                l_ul = max(1, self.nof_prb - 2)  # band edges = PUCCH region
                if ue.phr_db is not None and ue.phr_db < 0:
                    # power-limited UE: shrink bandwidth so the per-PRB
                    # power rises by |PHR| dB (TX power scales with PRBs)
                    l_ul = max(1, int(l_ul * 10.0 ** (ue.phr_db / 10.0)))
                tbs = tbs_lookup(ul_mcs_to_itbs(mcs), l_ul)
                ue.ul_ndi ^= 1
                ue.ul_pending_bytes = max(0, ue.ul_pending_bytes - tbs // 8)
                return [UlSchedGrant(rnti, 1, l_ul, mcs, tbs, ue.ul_ndi, 0,
                                     tti % self.n_harq)]
        return []

    def metrics(self) -> dict:
        return {
            rnti: {"dl_bytes": ue.dl_bytes, "ul_bytes": ue.ul_bytes} for rnti, ue in self.ues.items()
        }


# ---------------------------------------------------------------------------
# UE MAC
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UeDlHarqState:
    """UE-side DL HARQ: NDI tracking for new-tx vs retx detection
    (dl_harq.cc); the LLR soft-combining itself lives in the PHY
    softbuffer (fec/rate_match softbuffer accumulation)."""

    ndi: int = -1

    def is_new_tx(self, ndi: int) -> bool:
        new = ndi != self.ndi
        self.ndi = ndi
        return new


class UeMac:
    """UE MAC: demux, BSR generation, RA procedure FSM (proc_ra.cc)."""

    RA_IDLE, RA_PREAMBLE_SENT, RA_RAR_RECEIVED, RA_COMPLETED = range(4)

    def __init__(self, crnti: int = 0):
        self.crnti = crnti
        self.dl_harq = [UeDlHarqState() for _ in range(N_HARQ)]
        self.rx_sdus: deque[tuple[int, bytes]] = deque()
        self.ul_queues: dict[int, deque[bytes]] = {}
        self.ra_state = self.RA_IDLE
        self.ra_preamble = -1
        self.ta = 0
        self.stats = {"dl_pdus": 0, "dl_bytes": 0}

    # --- RA procedure ---
    def start_ra(self, preamble: int):
        self.ra_preamble = preamble
        self.ra_state = self.RA_PREAMBLE_SENT

    def handle_rar(self, preamble: int, ta: int, temp_crnti: int) -> bool:
        """Random-access response; returns True if it matches our preamble."""
        if self.ra_state != self.RA_PREAMBLE_SENT or preamble != self.ra_preamble:
            return False
        self.ta = ta
        self.crnti = temp_crnti
        self.ra_state = self.RA_RAR_RECEIVED
        return True

    def handle_contention_resolution(self, ident: bytes, our_ident: bytes) -> bool:
        if self.ra_state == self.RA_RAR_RECEIVED and ident == our_ident:
            self.ra_state = self.RA_COMPLETED
            return True
        return False

    # --- DL path ---
    def tb_decoded(self, harq_pid: int, ndi: int, pdu: bytes) -> list[tuple[int, bytes]]:
        """Process a CRC-ok TB; returns delivered (lcid, sdu) list."""
        if not self.dl_harq[harq_pid].is_new_tx(ndi):
            return []  # duplicate retx of an already-delivered TB
        out = mac_unpack(pdu, ce_sizes=DL_CE_SIZES)
        self.stats["dl_pdus"] += 1
        self.stats["dl_bytes"] += sum(len(s) for _, s in out)
        self.rx_sdus.extend(out)
        return out

    # --- UL path ---
    def write_sdu(self, lcid: int, sdu: bytes):
        self.ul_queues.setdefault(lcid, deque()).append(bytes(sdu))

    def buffer_state(self) -> int:
        return sum(len(s) for q in self.ul_queues.values() for s in q)

    def build_ul_pdu(self, tb_bytes: int) -> bytes | None:
        """Mux BSR CE + SDUs into an UL-SCH PDU (mux.cc)."""
        sdus: list[tuple[int, bytes]] = []
        used = 0
        remaining = self.buffer_state()
        # short BSR CE first (proc_bsr.cc): LCG 0
        bsr = bytes([bsr_index(remaining) & 0x3F])
        sdus.append((LCID_SHORT_BSR, bsr))
        used += len(bsr) + 3
        for lcid in sorted(self.ul_queues):
            q = self.ul_queues[lcid]
            while q and used + len(q[0]) + 3 <= tb_bytes:
                s = q.popleft()
                sdus.append((lcid, s))
                used += len(s) + 3
        if used > tb_bytes:
            return None
        return mac_pack(sdus, tb_bytes, ce_sizes=UL_CE_SIZES)


def parse_ul_pdu(pdu: bytes) -> tuple[int, list[tuple[int, bytes]]]:
    """eNB-side UL-SCH demux: returns (bsr_bytes_estimate, sdus)."""
    bsr = 0
    sdus = []
    for lcid, payload in mac_unpack(pdu, ce_sizes=UL_CE_SIZES):
        if lcid == LCID_SHORT_BSR and payload:
            idx = payload[0] & 0x3F
            # invert bsr_index: representative value
            bsr = 0 if idx == 0 else int(10.0 * ((150000.0 / 10.0) ** ((idx - 1) / 61.0)))
        elif lcid == LCID_PADDING:
            continue
        else:
            sdus.append((lcid, payload))
    return bsr, sdus
