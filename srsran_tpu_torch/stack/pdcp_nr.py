"""Host copy of `srsran_tpu/stack/pdcp_nr.py`, held to it by `tests/test_torch_stack.py`.

NR PDCP entity, TS 38.323 (role of `lib/src/upper/pdcp_entity_nr.cc`).

Unlike the LTE entity (`stack/pdcp.py`), the NR entity does NOT assume
in-order delivery from RLC: it maintains the TS 38.323 §5.2.2 receive
state (RX_DELIV / RX_NEXT / RX_REORD), a COUNT-keyed reordering queue,
and the t-Reordering timer (reference: pdcp_entity_nr.cc:127-239).
Timers are explicit `tick()`s, as everywhere else in this stack —
there is no task_scheduler thread to replace.

Header formats per TS 38.323 §6.2: DRB data PDUs with 12-bit
(2-byte hdr) or 18-bit (3-byte hdr) SN; SRBs use 12-bit SN with a
4-byte MAC-I always present. Integrity covers header+SDU; ciphering
covers payload+MAC-I but not the header (§5.8/§5.9 — the reference
ciphers before writing the header, pdcp_entity_nr.cc:108-115, and
leaves the header's inclusion in integrity as a FIXME at :145; here
both follow the spec text, which is self-consistent end-to-end).
"""

from __future__ import annotations

import dataclasses

from . import security as sec


@dataclasses.dataclass
class PdcpNrConfig:
    is_srb: bool = False
    sn_bits: int = 12  # 12 or 18 (SRB: always 12)
    bearer_id: int = 1
    direction_tx: int = 0  # 0=uplink (UE tx), 1=downlink (gNB tx)
    cipher_alg: int = 0  # index into security.CIPHER_ALGS (NEA = EEA)
    integrity_alg: int = 0  # index into security.INTEGRITY_ALGS (NIA = EIA)
    t_reordering: int = 35  # ticks (ms); 0 = infinity (never started)


class PdcpEntityNr:
    """One NR PDCP entity (one per bearer per peer)."""

    def __init__(self, cfg: PdcpNrConfig, k_enc: bytes | None = None, k_int: bytes | None = None):
        if cfg.is_srb:
            cfg.sn_bits = 12
        self.cfg = cfg
        self.k_enc = k_enc or bytes(16)
        self.k_int = k_int or bytes(16)
        self.mod = 1 << cfg.sn_bits
        self.window = 1 << (cfg.sn_bits - 1)
        # TX state (§5.1)
        self.tx_next = 0
        # RX state (§5.2.2)
        self.rx_next = 0  # COUNT of next expected PDU
        self.rx_deliv = 0  # COUNT of first PDU not delivered but expected
        self.rx_reord = 0  # COUNT that triggered t-Reordering
        self.reorder_queue: dict[int, bytes] = {}
        self.timer_left = 0  # remaining ticks of t-Reordering; 0 = stopped
        self.integrity_failures = 0
        self.dropped = 0

    # --- helpers -------------------------------------------------------
    def _bearer(self) -> int:
        return self.cfg.bearer_id - 1

    def _sn(self, count: int) -> int:
        return count % self.mod

    def _hdr(self, sn: int) -> bytes:
        c = self.cfg
        dc = 0x00 if c.is_srb else 0x80
        if c.sn_bits == 12:
            return bytes([dc | ((sn >> 8) & 0x0F), sn & 0xFF])
        return bytes([dc | ((sn >> 16) & 0x03), (sn >> 8) & 0xFF, sn & 0xFF])

    def _parse_hdr(self, pdu: bytes) -> tuple[int, bytes, bytes]:
        c = self.cfg
        if c.sn_bits == 12:
            return ((pdu[0] & 0x0F) << 8) | pdu[1], pdu[:2], pdu[2:]
        return ((pdu[0] & 0x03) << 16) | (pdu[1] << 8) | pdu[2], pdu[:3], pdu[3:]

    def _has_mac(self) -> bool:
        return self.cfg.is_srb or self.cfg.integrity_alg != 0

    # --- tx (§5.2.1) ---------------------------------------------------
    def write_sdu(self, sdu: bytes) -> bytes:
        c = self.cfg
        count = self.tx_next
        hdr = self._hdr(self._sn(count))
        if self._has_mac():
            if c.integrity_alg:
                mac = sec.INTEGRITY_ALGS[c.integrity_alg](
                    self.k_int, count, self._bearer(), c.direction_tx, hdr + sdu
                )
            else:
                mac = bytes(4)
            body = sdu + mac
        else:
            body = sdu
        if c.cipher_alg:
            body = sec.CIPHER_ALGS[c.cipher_alg](
                self.k_enc, count, self._bearer(), c.direction_tx, body, 8 * len(body)
            )
        self.tx_next += 1
        return hdr + body

    # --- rx (§5.2.2) ---------------------------------------------------
    def write_pdu(self, pdu: bytes) -> list[bytes]:
        """PDCP PDU → list of SDUs delivered in ascending COUNT order."""
        c = self.cfg
        if len(pdu) <= (2 if c.sn_bits == 12 else 3):
            return []
        rcvd_sn, hdr, body = self._parse_hdr(pdu)

        # COUNT determination (§5.2.2.1; pdcp_entity_nr.cc:153-160)
        deliv_sn, deliv_hfn = self._sn(self.rx_deliv), self.rx_deliv // self.mod
        if rcvd_sn < deliv_sn - self.window:
            rcvd_hfn = deliv_hfn + 1
        elif rcvd_sn >= deliv_sn + self.window:
            rcvd_hfn = deliv_hfn - 1
        else:
            rcvd_hfn = deliv_hfn
        rcvd_count = rcvd_hfn * self.mod + rcvd_sn
        if rcvd_count < 0:
            self.dropped += 1
            return []

        rx_dir = 1 - c.direction_tx
        if c.cipher_alg:
            body = sec.CIPHER_ALGS[c.cipher_alg](
                self.k_enc, rcvd_count, self._bearer(), rx_dir, body, 8 * len(body)
            )
        if self._has_mac():
            if len(body) < 4:
                self.dropped += 1
                return []
            sdu, mac = body[:-4], body[-4:]
            if c.integrity_alg:
                exp = sec.INTEGRITY_ALGS[c.integrity_alg](
                    self.k_int, rcvd_count, self._bearer(), rx_dir, hdr + sdu
                )
                if mac != exp:
                    self.integrity_failures += 1
                    return []
        else:
            sdu = body

        # duplicate / stale (already delivered) → drop
        if rcvd_count < self.rx_deliv or rcvd_count in self.reorder_queue:
            self.dropped += 1
            return []

        self.reorder_queue[rcvd_count] = sdu
        if rcvd_count >= self.rx_next:
            self.rx_next = rcvd_count + 1

        out: list[bytes] = []
        if rcvd_count == self.rx_deliv:
            out = self._deliver_consecutive()

        # t-Reordering handling (§5.2.2.2; pdcp_entity_nr.cc:200-208)
        if self.timer_left and self.rx_deliv >= self.rx_reord:
            self.timer_left = 0
        if not self.timer_left and self.rx_deliv < self.rx_next and self.cfg.t_reordering > 0:
            self.rx_reord = self.rx_next
            self.timer_left = self.cfg.t_reordering
        return out

    def _deliver_consecutive(self) -> list[bytes]:
        out = []
        while self.rx_deliv in self.reorder_queue:
            out.append(self.reorder_queue.pop(self.rx_deliv))
            self.rx_deliv += 1
        return out

    def tick(self, n: int = 1) -> list[bytes]:
        """Advance time by n ticks; returns SDUs flushed by t-Reordering expiry."""
        if not self.timer_left:
            return []
        self.timer_left = max(0, self.timer_left - n)
        if self.timer_left:
            return []
        # Expiry (§5.2.2.2): deliver all stored with COUNT < RX_REORD, then
        # consecutive from RX_REORD; advance RX_DELIV past the gap.
        out = []
        for count in sorted(k for k in self.reorder_queue if k < self.rx_reord):
            out.append(self.reorder_queue.pop(count))
        self.rx_deliv = max(self.rx_deliv, self.rx_reord)
        out.extend(self._deliver_consecutive())
        if self.rx_deliv < self.rx_next and self.cfg.t_reordering > 0:
            self.rx_reord = self.rx_next
            self.timer_left = self.cfg.t_reordering
        return out
