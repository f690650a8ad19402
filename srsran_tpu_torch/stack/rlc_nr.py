"""Host copy of `srsran_tpu/stack/rlc_nr.py`, held to it by `tests/test_torch_stack.py`.

NR RLC entities, TS 38.322 (re-design of `lib/src/upper/rlc_um_nr.cc`
/ `rlc_am_nr.cc` — 5G-NR scaffolding).

NR differs from LTE RLC: one RLC SDU per PDU (no concatenation/LI
chains); segmentation uses an SI field (2 bits: full / first / middle /
last) plus a 16-bit Segment Offset on non-first segments.

UM: 6- or 12-bit SN; the SN is only present for segmented SDUs.
AM: 12- or 18-bit SN, SO-based status reporting with NACK ranges.
This module implements UM fully and the AM data-path header codec
(the LTE-style AM machinery in `rlc.py` covers the 4G data plane).
"""

from __future__ import annotations

import dataclasses
from collections import deque

SI_FULL, SI_FIRST, SI_LAST, SI_MIDDLE = 0, 1, 2, 3


def um_pack(si: int, sn: int | None, so: int | None, data: bytes, sn_bits: int = 6) -> bytes:
    """UMD PDU header (TS 38.322 §6.2.2.3)."""
    if si == SI_FULL:
        return bytes([si << 6]) + data
    if sn_bits == 6:
        hdr = bytearray([(si << 6) | (sn & 0x3F)])
    else:
        hdr = bytearray([(si << 6) | ((sn >> 8) & 0xF), sn & 0xFF])
    if si in (SI_MIDDLE, SI_LAST):
        hdr += so.to_bytes(2, "big")
    return bytes(hdr) + data


def um_unpack(pdu: bytes, sn_bits: int = 6):
    """Returns (si, sn, so, data)."""
    si = (pdu[0] >> 6) & 3
    if si == SI_FULL:
        return si, None, None, pdu[1:]
    if sn_bits == 6:
        sn = pdu[0] & 0x3F
        pos = 1
    else:
        sn = ((pdu[0] & 0xF) << 8) | pdu[1]
        pos = 2
    so = None
    if si in (SI_MIDDLE, SI_LAST):
        so = int.from_bytes(pdu[pos : pos + 2], "big")
        pos += 2
    return si, sn, so, pdu[pos:]


class RlcUmNr:
    """NR UM entity: SDU in/out with SO-based segmentation."""

    def __init__(self, sn_bits: int = 6):
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.tx_sdus: deque[bytes] = deque()
        self.tx_sn = 0
        self.tx_partial: tuple[bytes, int] | None = None  # (rest, so)
        self.rx_segments: dict[int, dict[int, bytes]] = {}
        self.rx_last_so: dict[int, int] = {}
        self.rx_sdu_queue: deque[bytes] = deque()

    def write_sdu(self, sdu: bytes):
        self.tx_sdus.append(bytes(sdu))

    def has_data(self) -> bool:
        return bool(self.tx_sdus) or self.tx_partial is not None

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        hdr_max = 1 + (0 if self.sn_bits == 6 else 1) + 2
        if nof_bytes <= hdr_max or not self.has_data():
            return None
        if self.tx_partial is not None:
            rest, so = self.tx_partial
            room = nof_bytes - hdr_max
            if len(rest) <= room:
                self.tx_partial = None
                pdu = um_pack(SI_LAST, self.tx_sn, so, rest, self.sn_bits)
                self.tx_sn = (self.tx_sn + 1) % self.mod
                return pdu
            self.tx_partial = (rest[room:], so + room)
            return um_pack(SI_MIDDLE, self.tx_sn, so, rest[:room], self.sn_bits)
        sdu = self.tx_sdus[0]
        if len(sdu) + 1 <= nof_bytes:
            self.tx_sdus.popleft()
            return um_pack(SI_FULL, None, None, sdu)
        room = nof_bytes - (1 if self.sn_bits == 6 else 2)
        self.tx_sdus.popleft()
        self.tx_partial = (sdu[room:], room)
        return um_pack(SI_FIRST, self.tx_sn, None, sdu[:room], self.sn_bits)

    def write_pdu(self, pdu: bytes):
        si, sn, so, data = um_unpack(pdu, self.sn_bits)
        if si == SI_FULL:
            self.rx_sdu_queue.append(data)
            return
        segs = self.rx_segments.setdefault(sn, {})
        segs[so or 0] = data
        if si == SI_LAST:
            self.rx_last_so[sn] = (so or 0) + len(data)
        if sn in self.rx_last_so:
            total = self.rx_last_so[sn]
            buf = bytearray(total)
            covered = 0
            for off, seg in sorted(segs.items()):
                buf[off : off + len(seg)] = seg
                covered += len(seg)
            if covered >= total:
                self.rx_sdu_queue.append(bytes(buf))
                del self.rx_segments[sn]
                del self.rx_last_so[sn]

    def read_sdu(self) -> bytes | None:
        return self.rx_sdu_queue.popleft() if self.rx_sdu_queue else None


# --- AM data PDU header codec (TS 38.322 §6.2.2.4) -------------------------


def am_pack(si: int, sn: int, so: int | None, data: bytes, poll: bool = False, sn_bits: int = 12) -> bytes:
    b0 = 0x80 | ((1 if poll else 0) << 6) | (si << 4)
    if sn_bits == 12:
        hdr = bytearray([b0 | ((sn >> 8) & 0xF), sn & 0xFF])
    else:  # 18-bit
        hdr = bytearray([b0 | ((sn >> 16) & 0x3), (sn >> 8) & 0xFF, sn & 0xFF])
    if si in (SI_MIDDLE, SI_LAST):
        hdr += (so or 0).to_bytes(2, "big")
    return bytes(hdr) + data


def am_unpack(pdu: bytes, sn_bits: int = 12):
    """Returns (si, sn, so, poll, data)."""
    poll = bool(pdu[0] & 0x40)
    si = (pdu[0] >> 4) & 3
    if sn_bits == 12:
        sn = ((pdu[0] & 0xF) << 8) | pdu[1]
        pos = 2
    else:
        sn = ((pdu[0] & 0x3) << 16) | (pdu[1] << 8) | pdu[2]
        pos = 3
    so = None
    if si in (SI_MIDDLE, SI_LAST):
        so = int.from_bytes(pdu[pos : pos + 2], "big")
        pos += 2
    return si, sn, so, poll, pdu[pos:]


# --- STATUS PDU codec (TS 38.322 §6.2.2.5, 12-bit SN layout) ----------------


def status_pack(ack_sn: int, nacks: list[tuple[int, int | None, int | None]] = (), sn_bits: int = 12) -> bytes:
    """STATUS PDU: D/C=0, CPT=0, ACK_SN, then per NACK (sn, so_start, so_end)
    with E1 chaining and E2 for SO ranges."""
    assert sn_bits == 12, "12-bit SN status layout"
    out = bytearray()
    e1 = 1 if nacks else 0
    out.append((0 << 7) | (0 << 4) | ((ack_sn >> 8) & 0xF))
    out.append(ack_sn & 0xFF)
    out.append(e1 << 7)
    for i, (sn, so_s, so_e) in enumerate(nacks):
        more = 1 if i + 1 < len(nacks) else 0
        e2 = 1 if so_s is not None else 0
        out.append((sn >> 4) & 0xFF)
        out.append(((sn & 0xF) << 4) | (more << 3) | (e2 << 2))
        if e2:
            out += int(so_s).to_bytes(2, "big") + int(so_e).to_bytes(2, "big")
    return bytes(out)


def status_unpack(pdu: bytes, sn_bits: int = 12):
    """Returns (ack_sn, [(nack_sn, so_start|None, so_end|None), ...])."""
    assert sn_bits == 12
    assert (pdu[0] >> 7) == 0, "not a STATUS PDU"
    ack_sn = ((pdu[0] & 0xF) << 8) | pdu[1]
    e1 = (pdu[2] >> 7) & 1
    pos = 3
    nacks = []
    while e1:
        sn = (pdu[pos] << 4) | (pdu[pos + 1] >> 4)
        e1 = (pdu[pos + 1] >> 3) & 1
        e2 = (pdu[pos + 1] >> 2) & 1
        pos += 2
        so_s = so_e = None
        if e2:
            so_s = int.from_bytes(pdu[pos : pos + 2], "big")
            so_e = int.from_bytes(pdu[pos + 2 : pos + 4], "big")
            pos += 4
        nacks.append((sn, so_s, so_e))
    return ack_sn, nacks


class RlcAmNr:
    """NR AM entity (TS 38.322; rlc_am_nr.cc scaffolding analog): one SDU
    per PDU, SO-based segmentation, ARQ by STATUS PDU with poll-driven
    reports.  Shares the LTE AM entity's role (`rlc.py`) for the NR stack.
    """

    def __init__(self, sn_bits: int = 12, poll_pdu: int = 4, poll_retx_after: int = 8):
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.poll_pdu = poll_pdu
        # t-PollRetransmit analog: after this many idle read_pdu() calls with
        # un-acked PDUs outstanding, re-send the lowest one with the poll bit
        self.poll_retx_after = poll_retx_after
        self._idle_calls = 0
        # TX
        self.tx_sdus: deque[bytes] = deque()
        self.tx_next = 0
        self.tx_partial: tuple[int, bytes, int] | None = None  # (sn, rest, so)
        self.tx_pdus_since_poll = 0
        self.tx_window: dict[int, bytes] = {}  # sn -> full SDU (for retx)
        self.retx_q: deque[int] = deque()
        self.status_requested = False
        # RX
        self.rx_segments: dict[int, dict[int, bytes]] = {}
        self.rx_complete: dict[int, bytes] = {}
        self.rx_last_so: dict[int, int] = {}
        self.rx_next = 0  # lowest SN not yet delivered
        self.rx_sdu_queue: deque[bytes] = deque()
        self.do_status = False

    # --- TX side ---
    def write_sdu(self, sdu: bytes):
        self.tx_sdus.append(bytes(sdu))

    def has_data(self) -> bool:
        return bool(self.tx_sdus or self.retx_q or self.tx_partial or self.do_status)

    def _poll(self) -> bool:
        self.tx_pdus_since_poll += 1
        last_data = not self.tx_sdus and self.tx_partial is None and not self.retx_q
        if self.tx_pdus_since_poll >= self.poll_pdu or last_data:
            self.tx_pdus_since_poll = 0
            return True
        return False

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        if self.do_status:
            self.do_status = False
            return self.status_pdu()
        hdr_max = (2 if self.sn_bits == 12 else 3) + 2
        if nof_bytes <= hdr_max:
            return None
        # finish the in-flight segmented SDU first — a retx must never
        # clobber tx_partial (that would silently drop the SDU's tail)
        if self.tx_partial is not None:
            sn, rest, so = self.tx_partial
            room = nof_bytes - hdr_max
            if len(rest) <= room:
                self.tx_partial = None
                return am_pack(SI_LAST, sn, so, rest, self._poll(), self.sn_bits)
            self.tx_partial = (sn, rest[room:], so + room)
            return am_pack(SI_MIDDLE, sn, so, rest[:room], self._poll(), self.sn_bits)
        if self.retx_q:
            sn = self.retx_q.popleft()
            sdu = self.tx_window.get(sn)
            if sdu is not None:
                if len(sdu) + hdr_max - 2 <= nof_bytes:
                    return am_pack(SI_FULL, sn, None, sdu, self._poll(), self.sn_bits)
                # segment the retx: first segment now, remainder continues
                # through the tx_partial path
                room = nof_bytes - hdr_max
                self.tx_partial = (sn, sdu[room:], room)
                return am_pack(SI_FIRST, sn, None, sdu[:room], self._poll(), self.sn_bits)
        if not self.tx_sdus:
            # idle with outstanding un-acked PDUs: the last poll (or the
            # status answering it) may have been lost — re-poll
            if self.tx_window:
                self._idle_calls += 1
                if self._idle_calls >= self.poll_retx_after:
                    self._idle_calls = 0
                    self.retx_q.append(min(self.tx_window))
                    self.tx_pdus_since_poll = self.poll_pdu  # force poll=1
            return None
        self._idle_calls = 0
        sdu = self.tx_sdus.popleft()
        sn = self.tx_next
        self.tx_next = (self.tx_next + 1) % self.mod
        self.tx_window[sn] = sdu
        hdr_len = 2 if self.sn_bits == 12 else 3
        if len(sdu) + hdr_len <= nof_bytes:
            return am_pack(SI_FULL, sn, None, sdu, self._poll(), self.sn_bits)
        room = nof_bytes - hdr_len
        self.tx_partial = (sn, sdu[room:], room)
        return am_pack(SI_FIRST, sn, None, sdu[:room], self._poll(), self.sn_bits)

    def write_status(self, pdu: bytes):
        ack_sn, nacks = status_unpack(pdu, self.sn_bits)
        in_flight = self.tx_partial[0] if self.tx_partial is not None else None
        for sn, _so_s, _so_e in nacks:
            # an SN still mid-transmission will complete on its own — only
            # retransmit if it is no longer in flight
            if sn in self.tx_window and sn not in self.retx_q and sn != in_flight:
                self.retx_q.append(sn)
        nacked = {sn for sn, _, _ in nacks}
        for sn in [s for s in self.tx_window if s < ack_sn and s not in nacked]:
            del self.tx_window[sn]

    # --- RX side ---
    def write_pdu(self, pdu: bytes):
        if (pdu[0] >> 7) == 0:  # control PDU → the TX side of this entity
            self.write_status(pdu)
            return
        si, sn, so, poll, data = am_unpack(pdu, self.sn_bits)
        if poll:
            self.do_status = True
        if sn in self.rx_complete or sn < self.rx_next:
            return  # duplicate
        if si == SI_FULL:
            self.rx_complete[sn] = data
        else:
            segs = self.rx_segments.setdefault(sn, {})
            segs[so or 0] = data
            if si == SI_LAST:
                self.rx_last_so[sn] = (so or 0) + len(data)
            if sn in self.rx_last_so:
                total = self.rx_last_so[sn]
                buf = bytearray(total)
                end = 0
                contiguous = True
                for off, seg in sorted(segs.items()):
                    if off > end:
                        contiguous = False
                        break
                    buf[off : off + len(seg)] = seg
                    end = max(end, off + len(seg))
                if contiguous and end >= total:
                    self.rx_complete[sn] = bytes(buf)
                    del self.rx_segments[sn]
                    del self.rx_last_so[sn]
        while self.rx_next in self.rx_complete:
            self.rx_sdu_queue.append(self.rx_complete.pop(self.rx_next))
            self.rx_next = (self.rx_next + 1) % self.mod

    def status_pdu(self) -> bytes:
        """ACK_SN = next expected in-sequence SN; NACK every missing SN
        below the highest received."""
        highest = self.rx_next
        for sn in list(self.rx_complete) + list(self.rx_segments):
            if sn >= highest:
                highest = sn + 1
        # NACK every SN not COMPLETELY received (incl. partial reassemblies —
        # a dropped segment must trigger retransmission)
        nacks = [
            (sn, None, None)
            for sn in range(self.rx_next, highest)
            if sn not in self.rx_complete
        ]
        return status_pack(highest, nacks, self.sn_bits)

    def read_sdu(self) -> bytes | None:
        return self.rx_sdu_queue.popleft() if self.rx_sdu_queue else None
