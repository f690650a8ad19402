"""Host copy of `srsran_tpu/stack/pdcp.py`, held to it by `tests/test_torch_stack.py`.

PDCP layer, TS 36.323 (re-design of `lib/src/upper/pdcp_entity_lte.cc`).

Entities for SRBs (5-bit SN + 4-byte MAC-I integrity) and DRBs (7- or
12-bit SN), with ciphering/integrity through `stack.security`.
COUNT = HFN || SN; HFN advances on SN wraparound on both sides (in-order
delivery is assumed from RLC AM/UM below, as in the reference's LTE
entity).
"""

from __future__ import annotations

import dataclasses

from . import security as sec


@dataclasses.dataclass
class PdcpConfig:
    is_srb: bool = False
    sn_bits: int = 12  # SRB: 5, DRB: 7 or 12
    bearer_id: int = 1  # BEARER field = bearer_id - 1 (TS 36.323 §5.7)
    direction_tx: int = 0  # 0=uplink (UE tx), 1=downlink (eNB tx)
    cipher_alg: int = 0
    integrity_alg: int = 0


class PdcpEntity:
    def __init__(self, cfg: PdcpConfig, k_enc: bytes | None = None, k_int: bytes | None = None):
        if cfg.is_srb:
            cfg.sn_bits = 5
        self.cfg = cfg
        self.k_enc = k_enc or bytes(16)
        self.k_int = k_int or bytes(16)
        self.mod = 1 << cfg.sn_bits
        self.tx_count = 0
        self.rx_count = 0
        self.integrity_failures = 0

    # --- helpers ---
    def _bearer(self) -> int:
        return self.cfg.bearer_id - 1

    def _hdr(self, sn: int) -> bytes:
        c = self.cfg
        if c.is_srb:
            return bytes([sn & 0x1F])
        if c.sn_bits == 7:
            return bytes([0x80 | (sn & 0x7F)])  # D/C=1
        return bytes([0x80 | ((sn >> 8) & 0xF), sn & 0xFF])

    def _parse_hdr(self, pdu: bytes) -> tuple[int, bytes]:
        c = self.cfg
        if c.is_srb:
            return pdu[0] & 0x1F, pdu[1:]
        if c.sn_bits == 7:
            return pdu[0] & 0x7F, pdu[1:]
        return ((pdu[0] & 0xF) << 8) | pdu[1], pdu[2:]

    # --- tx ---
    def write_sdu(self, sdu: bytes) -> bytes:
        """SDU → PDCP PDU (to be handed to RLC)."""
        c = self.cfg
        count = self.tx_count
        sn = count % self.mod
        hdr = self._hdr(sn)
        self.tx_count += 1
        if c.is_srb and c.integrity_alg:
            mac = sec.INTEGRITY_ALGS[c.integrity_alg](
                self.k_int, count, self._bearer(), c.direction_tx, hdr + sdu
            )
        elif c.is_srb:
            mac = b"\x00" * 4
        else:
            mac = b""
        body = sdu + mac if c.is_srb else sdu
        if c.cipher_alg:
            body = sec.CIPHER_ALGS[c.cipher_alg](
                self.k_enc, count, self._bearer(), c.direction_tx, body, 8 * len(body)
            )
        return hdr + body

    # --- rx ---
    def write_pdu(self, pdu: bytes) -> bytes | None:
        """PDCP PDU → SDU (None on integrity failure)."""
        c = self.cfg
        sn, body = self._parse_hdr(pdu)
        # infer COUNT from SN relative to rx_count (in-order assumption)
        hfn = self.rx_count // self.mod
        expected_sn = self.rx_count % self.mod
        if sn < expected_sn and (expected_sn - sn) > self.mod // 2:
            hfn += 1  # SN wrapped
        count = hfn * self.mod + sn
        self.rx_count = count + 1
        rx_dir = 1 - c.direction_tx
        if c.cipher_alg:
            body = sec.CIPHER_ALGS[c.cipher_alg](
                self.k_enc, count, self._bearer(), rx_dir, body, 8 * len(body)
            )
        if c.is_srb:
            sdu, mac = body[:-4], body[-4:]
            if c.integrity_alg:
                exp = sec.INTEGRITY_ALGS[c.integrity_alg](
                    self.k_int, count, self._bearer(), rx_dir, pdu[:1] + sdu
                )
                if mac != exp:
                    self.integrity_failures += 1
                    return None
            return sdu
        return body
