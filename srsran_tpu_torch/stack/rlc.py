"""Host copy of `srsran_tpu/stack/rlc.py`, held to it by `tests/test_torch_stack.py`.

RLC layer, TS 36.322 (re-design of `lib/src/upper/rlc_tm.cc`,
`rlc_um_lte.cc`, `rlc_am_lte.cc`).

Host-side, single-threaded (the reference also runs RLC on one stack
thread via task_scheduler). Entities expose the MAC-facing pull API the
reference defines in `rlc_interface_mac` (read_pdu / write_pdu) and the
PDCP-facing write_sdu; time advances by explicit `tick()` calls (1 ms),
mirroring the timer wheel.

Covered: TM; UM with 5/10-bit SN, segmentation + reordering window
reassembly; AM with segmentation, status PDUs (ACK/NACK), poll bit,
retransmission, t-Reordering / t-StatusProhibit / t-PollRetransmit.
AM resegmentation (RF=1 AMD PDU segments with SO/LSF) retransmits
PDUs through grants smaller than the original PDU.
"""

from __future__ import annotations

import dataclasses
from collections import deque


# ---------------------------------------------------------------------------
# TM
# ---------------------------------------------------------------------------


class RlcTm:
    """Transparent mode: a pass-through FIFO (rlc_tm.cc)."""

    def __init__(self):
        self.tx = deque()
        self.rx = deque()

    def write_sdu(self, sdu: bytes):
        self.tx.append(bytes(sdu))

    def buffer_state(self) -> int:
        return sum(len(s) for s in self.tx)

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        if self.tx and len(self.tx[0]) <= nof_bytes:
            return self.tx.popleft()
        return None

    def write_pdu(self, pdu: bytes):
        self.rx.append(bytes(pdu))

    def read_sdu(self) -> bytes | None:
        return self.rx.popleft() if self.rx else None


# ---------------------------------------------------------------------------
# UM
# ---------------------------------------------------------------------------


def _pack_li_chain(e_li: list[int]) -> bytes:
    """Pack the E/LI extension chain (11-bit LIs, TS 36.322 §6.2.2.4)."""
    out = bytearray()
    nibble = None
    for i, li in enumerate(e_li):
        e = 1 if i < len(e_li) - 1 else 0
        val = (e << 11) | (li & 0x7FF)
        if nibble is None:
            out.append(val >> 4)
            nibble = val & 0xF
        else:
            out.append((nibble << 4) | (val >> 8))
            out.append(val & 0xFF)
            nibble = None
    if nibble is not None:
        out.append(nibble << 4)
    return bytes(out)


def _unpack_li_chain(data: bytes, first_e: int) -> tuple[list[int], int]:
    """Returns (li_list, header_bytes_consumed)."""
    lis = []
    e = first_e
    pos = 0
    half = False
    while e:
        if not half:
            val = (data[pos] << 4) | (data[pos + 1] >> 4)
            e = (val >> 11) & 1
            lis.append(val & 0x7FF)
            half = True
            pos += 1
        else:
            val = ((data[pos] & 0xF) << 8) | data[pos + 1]
            e = (val >> 11) & 1
            lis.append(val & 0x7FF)
            half = False
            pos += 2
    if half:
        pos += 1
    return lis, pos


@dataclasses.dataclass
class UmConfig:
    sn_bits: int = 10  # 5 or 10
    t_reordering_ms: int = 45


class RlcUm:
    """Unacknowledged mode entity (rlc_um_lte.cc)."""

    def __init__(self, cfg: UmConfig = UmConfig()):
        self.cfg = cfg
        self.mod = 1 << cfg.sn_bits
        self.window = self.mod // 2
        # tx
        self.tx_sdus: deque[bytes] = deque()
        self._tx_sdu_bytes = 0  # running sum(len+2) — buffer_state is on
        #   the scheduler's per-row path and must not walk the queue
        self.vt_us = 0
        self.tx_partial: bytes | None = None  # remainder of a segmented SDU
        # rx
        self.rx_pdus: dict[int, tuple[int, list[bytes]]] = {}  # sn -> (fi, sdu pieces)
        self.vr_ur = 0  # earliest SN still considered for reordering
        self.vr_uh = 0  # highest received + 1
        self.t_reorder = -1
        self.vr_ux = 0
        self.rx_sdu_queue: deque[bytes] = deque()
        self.rx_partial = b""
        self.rx_partial_valid = False

    # --- tx ---
    def write_sdu(self, sdu: bytes):
        self.tx_sdus.append(bytes(sdu))
        self._tx_sdu_bytes += len(sdu) + 2

    def has_data(self) -> bool:
        return bool(self.tx_sdus) or self.tx_partial is not None

    def buffer_state(self) -> int:
        n = self._tx_sdu_bytes
        if self.tx_partial is not None:
            n += len(self.tx_partial) + 2
        return n

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        """Build one UMD PDU of at most nof_bytes."""
        hdr_fixed = 1 if self.cfg.sn_bits == 5 else 2
        if nof_bytes < hdr_fixed + 1 or not self.has_data():
            return None
        payloads: list[bytes] = []
        first_is_cont = self.tx_partial is not None
        room = nof_bytes - hdr_fixed
        lis: list[int] = []
        last_is_partial = False
        while room > 0:
            src = self.tx_partial if self.tx_partial is not None else (self.tx_sdus[0] if self.tx_sdus else None)
            if src is None:
                break
            if payloads:
                # adding another SDU costs ~1.5 bytes of LI header
                li_cost = 2 if len(lis) % 2 == 0 else 1
                if room <= li_cost:
                    break
                room -= li_cost
                lis.append(len(payloads[-1]))
            if len(src) <= room:
                payloads.append(src)
                room -= len(src)
                if self.tx_partial is not None:
                    self.tx_partial = None
                else:
                    self._tx_sdu_bytes -= len(self.tx_sdus.popleft()) + 2
            else:
                payloads.append(src[:room])
                rest = src[room:]
                if self.tx_partial is not None:
                    self.tx_partial = rest
                else:
                    self._tx_sdu_bytes -= len(self.tx_sdus.popleft()) + 2
                    self.tx_partial = rest
                room = 0
                last_is_partial = True
        if not payloads:
            return None
        fi = (2 if first_is_cont else 0) | (1 if last_is_partial else 0)
        sn = self.vt_us
        self.vt_us = (self.vt_us + 1) % self.mod
        e = 1 if lis else 0
        if self.cfg.sn_bits == 5:
            hdr = bytes([(fi << 6) | (e << 5) | sn])
        else:
            hdr = bytes([(fi << 3) | (e << 2) | (sn >> 8), sn & 0xFF])
        return hdr + _pack_li_chain(lis) + b"".join(payloads) if lis else hdr + b"".join(payloads)

    # --- rx ---
    def write_pdu(self, pdu: bytes):
        if self.cfg.sn_bits == 5:
            fi = (pdu[0] >> 6) & 3
            e = (pdu[0] >> 5) & 1
            sn = pdu[0] & 0x1F
            rest = pdu[1:]
        else:
            fi = (pdu[0] >> 3) & 3
            e = (pdu[0] >> 2) & 1
            sn = ((pdu[0] & 3) << 8) | pdu[1]
            rest = pdu[2:]
        lis, consumed = _unpack_li_chain(rest, e) if e else ([], 0)
        data = rest[consumed:]
        pieces = []
        pos = 0
        for li in lis:
            pieces.append(data[pos : pos + li])
            pos += li
        pieces.append(data[pos:])
        self.rx_pdus[sn] = (fi, pieces)
        self._deliver_in_order()

    def _deliver_in_order(self):
        """In-sequence delivery from vr_ur; a gap starts t-Reordering and
        is skipped on expiry (TS 36.322 §5.1.2.2 vr_ux/t-Reordering)."""
        while self.vr_ur in self.rx_pdus:
            fi, pieces = self.rx_pdus.pop(self.vr_ur)
            first_cont = bool(fi & 2)
            last_part = bool(fi & 1)
            for i, piece in enumerate(pieces):
                is_first = i == 0
                is_last = i == len(pieces) - 1
                if is_first and first_cont:
                    if self.rx_partial_valid:
                        self.rx_partial += piece
                        if not (is_last and last_part):
                            self.rx_sdu_queue.append(self.rx_partial)
                            self.rx_partial = b""
                            self.rx_partial_valid = False
                        elif is_last and last_part:
                            pass  # still partial
                    # else: lost the start — drop
                    continue
                if is_last and last_part:
                    self.rx_partial = piece if not (is_first and first_cont) else self.rx_partial
                    self.rx_partial_valid = True
                else:
                    self.rx_sdu_queue.append(piece)
            self.vr_ur = (self.vr_ur + 1) % self.mod

    def tick(self):
        """1 ms timer tick: run t-Reordering; on expiry advance vr_ur past
        the gap (lost PDU) and deliver what follows."""
        gap = self.vr_ur not in self.rx_pdus and bool(self.rx_pdus)
        if gap and self.t_reorder < 0:
            self.t_reorder = self.cfg.t_reordering_ms
        elif not gap:
            self.t_reorder = -1
        if self.t_reorder > 0:
            self.t_reorder -= 1
            if self.t_reorder == 0:
                # skip to the next received SN; partial SDU at the gap is lost
                self.rx_partial = b""
                self.rx_partial_valid = False
                for _ in range(self.mod):
                    self.vr_ur = (self.vr_ur + 1) % self.mod
                    if self.vr_ur in self.rx_pdus:
                        break
                self.t_reorder = -1
                self._deliver_in_order()

    def read_sdu(self) -> bytes | None:
        return self.rx_sdu_queue.popleft() if self.rx_sdu_queue else None


# ---------------------------------------------------------------------------
# AM
# ---------------------------------------------------------------------------

AM_MOD = 1024
AM_WINDOW = 512


@dataclasses.dataclass
class AmConfig:
    t_poll_retx_ms: int = 45
    poll_pdu: int = 8
    poll_byte: int = 32000
    max_retx: int = 8
    t_status_prohibit_ms: int = 0


@dataclasses.dataclass
class _TxPdu:
    sn: int
    body: bytes  # header+payload as first transmitted
    retx_count: int = 0
    acked: bool = False
    fi: int = 0  # original FI bits
    pieces: tuple = ()  # original SDU fragments (for resegmentation)
    next_so: int = 0  # resegmentation cursor


def _sn_in_window(sn: int, lower: int) -> bool:
    return ((sn - lower) % AM_MOD) < AM_WINDOW


class RlcAm:
    """Acknowledged mode entity (rlc_am_lte.cc, 2,207 LoC in the reference;
    this covers the segmentation/status/retx core without resegmentation)."""

    def __init__(self, cfg: AmConfig = AmConfig()):
        self.cfg = cfg
        # tx side
        self.tx_sdus: deque[bytes] = deque()
        self._tx_sdu_bytes = 0  # running sum(len+2) — buffer_state is on
        #   the scheduler's per-row path and must not walk the queue
        self.tx_partial: bytes | None = None
        self.vt_a = 0  # oldest un-acked
        self.vt_s = 0  # next SN to use
        self.tx_window: dict[int, _TxPdu] = {}
        self.retx_queue: deque[int] = deque()
        self.pdus_since_poll = 0
        self.bytes_since_poll = 0
        self.t_poll_retx = -1
        self.poll_sn = -1
        # rx side
        self.vr_r = 0  # next expected in-sequence
        self.vr_h = 0  # highest received + 1
        self.rx_window: dict[int, tuple[int, list[bytes]]] = {}
        self.rx_segments: dict[int, dict] = {}  # sn -> {so: (fi, pieces, lsf)}
        self.rx_sdu_queue: deque[bytes] = deque()
        self.rx_partial = b""
        self.rx_partial_valid = False
        self.status_requested = False
        self.t_status_prohibit = 0
        self.max_retx_hit = False

    # ---- tx path ----
    def write_sdu(self, sdu: bytes):
        self.tx_sdus.append(bytes(sdu))
        self._tx_sdu_bytes += len(sdu) + 2

    def has_data(self) -> bool:
        return (
            bool(self.tx_sdus)
            or self.tx_partial is not None
            or bool(self.retx_queue)
            or self.status_requested
        )

    def buffer_state(self) -> int:
        n = self._tx_sdu_bytes
        if self.tx_partial:
            n += len(self.tx_partial) + 2
        for sn in self.retx_queue:
            if sn in self.tx_window:
                n += len(self.tx_window[sn].body)
        if self.status_requested:
            n += 4
        return n

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        # 1. status PDU has priority (rlc_am_lte.cc build_status_pdu)
        if self.status_requested and self.t_status_prohibit <= 0:
            pdu = self._build_status()
            if pdu is not None and len(pdu) <= nof_bytes:
                self.status_requested = False
                self.t_status_prohibit = self.cfg.t_status_prohibit_ms
                return pdu
        # 2. retransmission
        while self.retx_queue:
            sn = self.retx_queue[0]
            p = self.tx_window.get(sn)
            if p is None or p.acked:
                self.retx_queue.popleft()
                continue
            if len(p.body) <= nof_bytes and p.next_so == 0:
                self.retx_queue.popleft()
                p.retx_count += 1
                if p.retx_count >= self.cfg.max_retx:
                    self.max_retx_hit = True  # reference: notify RRC → RLF
                body = bytearray(p.body)
                body[0] |= 0x20  # set poll on retx
                self._poll_sent()
                return bytes(body)
            # resegmentation (TS 36.322 §6.2.1.5 AMD PDU segment, RF=1)
            seg = self._build_segment(p, nof_bytes)
            if seg is not None:
                if p.next_so == 0:  # all segments of this pass sent
                    self.retx_queue.popleft()
                    p.retx_count += 1
                    if p.retx_count >= self.cfg.max_retx:
                        self.max_retx_hit = True
                return seg
            return None
        # 3. new data
        return self._build_new_pdu(nof_bytes)

    def _build_new_pdu(self, nof_bytes: int) -> bytes | None:
        if nof_bytes < 3 or (not self.tx_sdus and self.tx_partial is None):
            return None
        if not _sn_in_window(self.vt_s, self.vt_a):
            return None  # tx window stalled
        room = nof_bytes - 2
        payloads: list[bytes] = []
        lis: list[int] = []
        first_is_cont = self.tx_partial is not None
        last_is_partial = False
        while room > 0:
            src = self.tx_partial if self.tx_partial is not None else (self.tx_sdus[0] if self.tx_sdus else None)
            if src is None:
                break
            if payloads:
                li_cost = 2 if len(lis) % 2 == 0 else 1
                if room <= li_cost:
                    break
                room -= li_cost
                lis.append(len(payloads[-1]))
            if len(src) <= room:
                payloads.append(src)
                room -= len(src)
                if self.tx_partial is not None:
                    self.tx_partial = None
                else:
                    self._tx_sdu_bytes -= len(self.tx_sdus.popleft()) + 2
            else:
                payloads.append(src[:room])
                rest = src[room:]
                if self.tx_partial is not None:
                    self.tx_partial = rest
                else:
                    self._tx_sdu_bytes -= len(self.tx_sdus.popleft()) + 2
                    self.tx_partial = rest
                room = 0
                last_is_partial = True
        if not payloads:
            return None
        sn = self.vt_s
        self.vt_s = (self.vt_s + 1) % AM_MOD
        fi = (2 if first_is_cont else 0) | (1 if last_is_partial else 0)
        e = 1 if lis else 0
        poll = self._should_poll(sum(len(p) for p in payloads))
        b0 = 0x80 | (poll << 5) | (fi << 3) | (e << 2) | (sn >> 8)  # D/C=1, RF=0
        hdr = bytes([b0, sn & 0xFF]) + (_pack_li_chain(lis) if lis else b"")
        body = hdr + b"".join(payloads)
        self.tx_window[sn] = _TxPdu(sn, body, fi=fi, pieces=tuple(payloads))
        if poll:
            self._poll_sent()
            self.poll_sn = sn
        return body

    def _build_segment(self, p: _TxPdu, nof_bytes: int) -> bytes | None:
        """One RF=1 AMD PDU segment from the stored original pieces.
        Header: D/C|RF|P|FI|E|SN + LSF|SO(15); data = original data
        field bytes [so, so+room)."""
        data = b"".join(p.pieces)
        so = p.next_so
        room = nof_bytes - 4  # fixed header (2) + LSF/SO (2); LIs extra
        if room < 1 or so >= len(data):
            return None
        # piece boundaries inside the original data field
        bounds = []
        acc = 0
        for piece in p.pieces:
            acc += len(piece)
            bounds.append(acc)
        # fit sub-pieces + LI costs into room
        end = min(len(data), so + room)
        inner = [b for b in bounds if so < b < end]
        # LI header cost: 1.5 bytes per boundary
        while inner and (end - so) + (len(inner) * 3 + 1) // 2 > room:
            end = min(end, inner.pop())
        if end <= so:
            end = min(len(data), so + room)
            inner = []
        seg = data[so:end]
        lis = []
        prev = so
        for b in inner:
            lis.append(b - prev)
            prev = b
        first_cont = (so not in [0] + bounds) or (so == 0 and bool(p.fi & 2))
        last_cont = (end not in bounds) or (end == len(data) and bool(p.fi & 1))
        fi = (2 if first_cont else 0) | (1 if last_cont else 0)
        lsf = 1 if end == len(data) else 0
        e = 1 if lis else 0
        b0 = 0x80 | 0x40 | (fi << 3) | (e << 2) | (p.sn >> 8)  # D/C=1, RF=1
        hdr = bytes([b0, p.sn & 0xFF, (lsf << 7) | ((so >> 8) & 0x7F), so & 0xFF])
        p.next_so = 0 if lsf else end
        return hdr + (_pack_li_chain(lis) if lis else b"") + seg

    def _should_poll(self, nof_bytes: int) -> int:
        self.pdus_since_poll += 1
        self.bytes_since_poll += nof_bytes
        buffers_empty = not self.tx_sdus and self.tx_partial is None
        if (
            self.pdus_since_poll >= self.cfg.poll_pdu
            or self.bytes_since_poll >= self.cfg.poll_byte
            or buffers_empty
        ):
            return 1
        return 0

    def _poll_sent(self):
        self.pdus_since_poll = 0
        self.bytes_since_poll = 0
        self.t_poll_retx = self.cfg.t_poll_retx_ms

    # ---- rx path ----
    def write_pdu(self, pdu: bytes):
        if not pdu:
            return
        if (pdu[0] & 0x80) == 0:
            self._handle_status(pdu)
            return
        rf = (pdu[0] >> 6) & 1
        poll = (pdu[0] >> 5) & 1
        fi = (pdu[0] >> 3) & 3
        e = (pdu[0] >> 2) & 1
        sn = ((pdu[0] & 3) << 8) | pdu[1]
        if rf:
            self._handle_segment(pdu, poll if False else (pdu[0] >> 5) & 1, fi, e, sn)
            return
        rest = pdu[2:]
        lis, consumed = _unpack_li_chain(rest, e) if e else ([], 0)
        data = rest[consumed:]
        pieces = []
        pos = 0
        for li in lis:
            pieces.append(data[pos : pos + li])
            pos += li
        pieces.append(data[pos:])
        if _sn_in_window(sn, self.vr_r):
            self.rx_window[sn] = (fi, pieces)
            if ((sn - self.vr_r) % AM_MOD) >= ((self.vr_h - self.vr_r) % AM_MOD):
                self.vr_h = (sn + 1) % AM_MOD
        if poll:
            self.status_requested = True
        self._reassemble()

    def _handle_segment(self, pdu: bytes, poll: int, fi: int, e: int, sn: int):
        lsf = (pdu[2] >> 7) & 1
        so = ((pdu[2] & 0x7F) << 8) | pdu[3]
        rest = pdu[4:]
        lis, consumed = _unpack_li_chain(rest, e) if e else ([], 0)
        data = rest[consumed:]
        pieces = []
        pos = 0
        for li in lis:
            pieces.append(data[pos : pos + li])
            pos += li
        pieces.append(data[pos:])
        store = self.rx_segments.setdefault(sn, {})
        store[so] = (fi, pieces, lsf)
        if poll:
            self.status_requested = True
        # complete? contiguous coverage from 0 to an LSF segment
        offset = 0
        chain = []
        while offset in store:
            fi_s, pcs, lsf_s = store[offset]
            chain.append((fi_s, pcs, lsf_s))
            offset += sum(len(x) for x in pcs)
            if lsf_s:
                break
        if not chain or not chain[-1][2]:
            return
        # merge the segment chains into one (fi, pieces) like a whole PDU
        merged: list[bytes] = []
        whole_fi_first = chain[0][0] & 2
        whole_fi_last = chain[-1][0] & 1
        carry: bytes | None = None
        for fi_s, pcs, _ in chain:
            pcs = list(pcs)
            if carry is not None and (fi_s & 2):
                pcs[0] = carry + pcs[0]
            elif carry is not None:
                merged.append(carry)
            carry = pcs.pop() if (fi_s & 1) else None
            if carry is None and pcs:
                merged.extend(pcs)
            elif pcs:
                merged.extend(pcs)
        if carry is not None:
            merged.append(carry)
        del self.rx_segments[sn]
        if _sn_in_window(sn, self.vr_r):
            self.rx_window[sn] = ((2 if whole_fi_first else 0) | (1 if whole_fi_last else 0), merged)
            if ((sn - self.vr_r) % AM_MOD) >= ((self.vr_h - self.vr_r) % AM_MOD):
                self.vr_h = (sn + 1) % AM_MOD
        self._reassemble()

    def _reassemble(self):
        while self.vr_r in self.rx_window:
            fi, pieces = self.rx_window.pop(self.vr_r)
            first_cont = bool(fi & 2)
            last_part = bool(fi & 1)
            n = len(pieces)
            for i, piece in enumerate(pieces):
                is_first = i == 0
                is_last = i == n - 1
                if is_first and first_cont and self.rx_partial_valid:
                    self.rx_partial += piece
                    if is_last and last_part:
                        continue
                    self.rx_sdu_queue.append(self.rx_partial)
                    self.rx_partial = b""
                    self.rx_partial_valid = False
                    continue
                if is_last and last_part:
                    self.rx_partial = piece
                    self.rx_partial_valid = True
                else:
                    self.rx_sdu_queue.append(piece)
            self.vr_r = (self.vr_r + 1) % AM_MOD

    def _build_status(self) -> bytes | None:
        """STATUS PDU: D/C=0 CPT=000 ACK_SN(10) E1, then [NACK_SN(10) E1 E2]*
        (TS 36.322 §6.2.1.6), bit-packed."""
        ack_sn = self.vr_h
        nacks = self._missing_sns()
        bits = []

        def put(val, n):
            for i in range(n - 1, -1, -1):
                bits.append((val >> i) & 1)

        put(0, 1)  # D/C
        put(0, 3)  # CPT
        put(ack_sn, 10)
        put(1 if nacks else 0, 1)
        for i, nsn in enumerate(nacks):
            put(nsn, 10)
            put(1 if i < len(nacks) - 1 else 0, 1)  # E1
            put(0, 1)  # E2 (no segment offsets)
        while len(bits) % 8:
            bits.append(0)
        return bytes(
            sum(b << (7 - j) for j, b in enumerate(bits[i : i + 8])) for i in range(0, len(bits), 8)
        )

    def _missing_sns(self) -> list[int]:
        out = []
        sn = self.vr_r
        while sn != self.vr_h:
            if sn not in self.rx_window:
                out.append(sn)
            sn = (sn + 1) % AM_MOD
        return out

    def _handle_status(self, pdu: bytes):
        bits = []
        for byte in pdu:
            for j in range(7, -1, -1):
                bits.append((byte >> j) & 1)
        pos = 0

        def get(n):
            nonlocal pos
            v = 0
            for _ in range(n):
                v = (v << 1) | bits[pos]
                pos += 1
            return v

        if get(1) != 0 or get(3) != 0:
            return
        ack_sn = get(10)
        e1 = get(1)
        nacks = set()
        while e1:
            nsn = get(10)
            e1 = get(1)
            e2 = get(1)
            if e2:
                get(15)
                get(15)
            nacks.add(nsn)
        # ack everything below ack_sn except nacked
        sn = self.vt_a
        while sn != ack_sn:
            if sn in self.tx_window and sn not in nacks:
                self.tx_window[sn].acked = True
            sn = (sn + 1) % AM_MOD
        for nsn in nacks:
            if nsn in self.tx_window and nsn not in self.retx_queue:
                self.retx_queue.append(nsn)
        if self.poll_sn >= 0 and (
            self.poll_sn not in self.tx_window or self.tx_window[self.poll_sn].acked or self.poll_sn in nacks
        ):
            self.t_poll_retx = -1
        # advance vt_a
        while self.vt_a != self.vt_s and self.vt_a in self.tx_window and self.tx_window[self.vt_a].acked:
            del self.tx_window[self.vt_a]
            self.vt_a = (self.vt_a + 1) % AM_MOD

    # ---- timers ----
    def tick(self):
        if self.t_status_prohibit > 0:
            self.t_status_prohibit -= 1
        if self.t_poll_retx > 0:
            self.t_poll_retx -= 1
            if self.t_poll_retx == 0 and self.poll_sn >= 0 and self.poll_sn in self.tx_window:
                if self.poll_sn not in self.retx_queue:
                    self.retx_queue.append(self.poll_sn)

    def read_sdu(self) -> bytes | None:
        return self.rx_sdu_queue.popleft() if self.rx_sdu_queue else None
