"""Host copy of `srsran_tpu/stack/nas.py`, held to it by `tests/test_torch_stack.py`.

NAS EMM/ESM codec + security, TS 24.301 (re-design of
`lib/src/asn1/liblte_mme.cc` message subset + `srsue/src/stack/upper/
nas.cc` / `srsepc/src/mme/nas.cc` procedures).

Wire-format octet encodings for the attach call flow:
  Attach Request → Authentication Request/Response → Security Mode
  Command/Complete → Attach Accept (with Activate Default EPS Bearer
  Context Request) → Attach Complete.

Security-protected NAS messages carry SeqNum + EIA MAC per §9.1/§4.4;
ciphering applies EEA over the inner message.
"""

from __future__ import annotations

import dataclasses

from . import security as sec

PD_EMM = 0x07
PD_ESM = 0x02

# EMM message types (TS 24.301 Table 9.8.1)
ATTACH_REQUEST = 0x41
ATTACH_ACCEPT = 0x42
ATTACH_COMPLETE = 0x43
ATTACH_REJECT = 0x44
AUTHENTICATION_REQUEST = 0x52
AUTHENTICATION_RESPONSE = 0x53
AUTHENTICATION_REJECT = 0x54
SECURITY_MODE_COMMAND = 0x5D
SECURITY_MODE_COMPLETE = 0x5E
IDENTITY_REQUEST = 0x55
IDENTITY_RESPONSE = 0x56
# ESM message types
PDN_CONNECTIVITY_REQUEST = 0xD0
ACT_DEF_BEARER_REQUEST = 0xC1
ACT_DEF_BEARER_ACCEPT = 0xC2
ACT_DED_BEARER_REQUEST = 0xC5
ACT_DED_BEARER_ACCEPT = 0xC6

SEC_HDR_PLAIN = 0
SEC_HDR_INTEGRITY = 1
SEC_HDR_INTEGRITY_CIPHERED = 2
SEC_HDR_INTEGRITY_NEW_CTX = 3
SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX = 4
SEC_HDR_SERVICE_REQUEST = 12

# SERVICE REQUEST has no message-type octet (TS 24.301 §8.2.25, the short
# format identified by security header type 12); 0x4D is the conventional
# pseudo-type (reference `liblte_mme.h` LIBLTE_MME_MSG_TYPE_SERVICE_REQUEST).
DETACH_REQUEST = 0x45
DETACH_ACCEPT = 0x46

SERVICE_REQUEST = 0x4D


def imsi_to_bcd(imsi: str) -> bytes:
    """EPS mobile identity IE value for an IMSI (§9.9.3.12)."""
    digits = [int(c) for c in imsi]
    odd = len(digits) % 2
    out = [((digits[0] << 4) | (0x9 if odd else 0x1))]  # type=IMSI(001), odd bit
    i = 1
    while i < len(digits):
        lo = digits[i]
        hi = digits[i + 1] if i + 1 < len(digits) else 0xF
        out.append((hi << 4) | lo)
        i += 2
    return bytes(out)


def bcd_to_imsi(b: bytes) -> str:
    digits = [str(b[0] >> 4)]
    odd = (b[0] & 0x08) != 0
    for byte in b[1:]:
        digits.append(str(byte & 0xF))
        digits.append(str(byte >> 4))
    if not odd:
        digits.pop()
    return "".join(d for d in digits if d != "15")


# ---------------------------------------------------------------------------
# plain message pack/unpack
# ---------------------------------------------------------------------------


def pack_attach_request(imsi: str, ue_caps: bytes = b"\xf0\xf0", esm: bytes | None = None) -> bytes:
    esm = esm if esm is not None else pack_pdn_connectivity_request()
    mid = imsi_to_bcd(imsi)
    return (
        bytes([PD_EMM, ATTACH_REQUEST, 0x01])  # EPS attach type=EPS attach, KSI=0
        + bytes([len(mid)])
        + mid
        + bytes([len(ue_caps)])
        + ue_caps
        + len(esm).to_bytes(2, "big")
        + esm
    )


def pack_pdn_connectivity_request(apn: str = "srsapn") -> bytes:
    a = apn.encode()
    return bytes([PD_ESM | 0x00, 0x01, PDN_CONNECTIVITY_REQUEST, 0x11]) + bytes([len(a)]) + a


def pack_authentication_request(rand: bytes, autn: bytes, ksi: int = 0) -> bytes:
    return bytes([PD_EMM, AUTHENTICATION_REQUEST, ksi & 0x0F]) + rand + bytes([len(autn)]) + autn


def pack_authentication_response(res: bytes) -> bytes:
    return bytes([PD_EMM, AUTHENTICATION_RESPONSE, len(res)]) + res


def pack_security_mode_command(eea: int, eia: int, ksi: int = 0, ue_caps: bytes = b"\xf0\xf0") -> bytes:
    return bytes([PD_EMM, SECURITY_MODE_COMMAND, (eea << 4) | eia, ksi & 0x0F, len(ue_caps)]) + ue_caps


def pack_security_mode_complete() -> bytes:
    return bytes([PD_EMM, SECURITY_MODE_COMPLETE])


def pack_detach_request(m_tmsi: int, switch_off: bool = False, ksi: int = 0) -> bytes:
    """UE-originating Detach Request (TS 24.301 §8.2.12): detach type
    (EPS detach, optional switch-off bit) + GUTI-style mobile identity
    (reduced here to the M-TMSI)."""
    dt = 0x01 | (0x08 if switch_off else 0)  # EPS detach (+switch-off)
    return (bytes([PD_EMM, DETACH_REQUEST, (ksi << 4) | dt, 4])
            + m_tmsi.to_bytes(4, "big"))


def pack_detach_accept() -> bytes:
    return bytes([PD_EMM, DETACH_ACCEPT])


def pack_activate_default_bearer_request(ip: str, apn: str = "srsapn", ebi: int = 5) -> bytes:
    a = apn.encode()
    addr = bytes(int(x) for x in ip.split("."))
    qos = bytes([9])  # QCI 9
    return (
        bytes([PD_ESM | (ebi << 4), 0x01, ACT_DEF_BEARER_REQUEST])
        + bytes([len(qos)])
        + qos
        + bytes([len(a)])
        + a
        + bytes([len(addr) + 1, 0x01])  # PDN type IPv4
        + addr
    )


def pack_attach_accept(ip: str, m_tmsi: int = 0x12345678, ebi: int = 5) -> bytes:
    esm = pack_activate_default_bearer_request(ip, ebi=ebi)
    return (
        bytes([PD_EMM, ATTACH_ACCEPT, 0x01, 0x21])  # result=EPS only, T3412
        + len(esm).to_bytes(2, "big")
        + esm
        + m_tmsi.to_bytes(4, "big")
    )


def pack_attach_complete(ebi: int = 5) -> bytes:
    esm = bytes([PD_ESM | (ebi << 4), 0x01, ACT_DEF_BEARER_ACCEPT])
    return bytes([PD_EMM, ATTACH_COMPLETE]) + len(esm).to_bytes(2, "big") + esm


# --------------------------------------------------------------------------
# Traffic Flow Template (TS 24.008 §10.5.6.12), used by dedicated bearers
# --------------------------------------------------------------------------

TFT_OP_CREATE = 1  # create new TFT
TFT_DIR_PRE_REL7 = 0
TFT_DIR_DOWNLINK = 1
TFT_DIR_UPLINK = 2
TFT_DIR_BIDIRECTIONAL = 3


@dataclasses.dataclass
class TftPacketFilter:
    fid: int
    direction: int
    precedence: int
    components: bytes  # raw component list (type octet + value per component)


@dataclasses.dataclass
class Tft:
    op_code: int
    filters: list[TftPacketFilter]
    params: bytes = b""

    def pack(self) -> bytes:
        out = bytearray([(self.op_code << 5) | (1 if self.params else 0) << 4 | len(self.filters)])
        for f in self.filters:
            out.append(((f.direction & 0x3) << 4) | (f.fid & 0xF))
            out.append(f.precedence)
            out.append(len(f.components))
            out += f.components
        out += self.params
        return bytes(out)

    @classmethod
    def unpack(cls, data: bytes) -> "Tft":
        op = data[0] >> 5
        n = data[0] & 0x0F
        pos = 1
        filters = []
        for _ in range(n):
            fid = data[pos] & 0x0F
            direction = (data[pos] >> 4) & 0x3
            precedence = data[pos + 1]
            clen = data[pos + 2]
            filters.append(TftPacketFilter(fid, direction, precedence, data[pos + 3 : pos + 3 + clen]))
            pos += 3 + clen
        return cls(op, filters, data[pos:])


def pack_activate_dedicated_bearer_request(
    ebi: int, linked_ebi: int, qci: int, tft: Tft, pti: int = 0
) -> bytes:
    """Activate Dedicated EPS Bearer Context Request (TS 24.301 §8.3.3)."""
    t = tft.pack()
    return (
        bytes([PD_ESM | (ebi << 4), pti, ACT_DED_BEARER_REQUEST, linked_ebi & 0x0F])
        + bytes([1, qci])  # EPS QoS (LV)
        + bytes([len(t)])
        + t
    )


@dataclasses.dataclass
class NasMessage:
    pd: int
    msg_type: int
    fields: dict


def unpack(msg: bytes) -> NasMessage:
    """Parse any of the supported plain messages."""
    pd = msg[0] & 0x0F
    if pd == PD_EMM and (msg[0] >> 4) == SEC_HDR_SERVICE_REQUEST:
        # short format: KSI(3)|seq(5) + 16-bit short MAC (§9.9.3.28)
        return NasMessage(PD_EMM, SERVICE_REQUEST, {
            "ksi": msg[1] >> 5, "seq": msg[1] & 0x1F, "short_mac": msg[2:4],
        })
    if pd == PD_ESM:
        ebi = msg[0] >> 4
        mt = msg[2]
        f = {"ebi": ebi}
        if mt == PDN_CONNECTIVITY_REQUEST:
            alen = msg[4]
            f["apn"] = msg[5 : 5 + alen].decode()
        elif mt == ACT_DED_BEARER_REQUEST:
            f["pti"] = msg[1]
            f["linked_ebi"] = msg[3] & 0x0F
            pos = 4
            qlen = msg[pos]
            f["qos"] = msg[pos + 1 : pos + 1 + qlen]
            f["qci"] = msg[pos + 1]
            pos += 1 + qlen
            tlen = msg[pos]
            f["tft"] = Tft.unpack(msg[pos + 1 : pos + 1 + tlen])
            pos += 1 + tlen
            f["opts"] = msg[pos:]  # remaining optional IEs, kept raw
        elif mt == ACT_DEF_BEARER_REQUEST:
            pos = 3
            qlen = msg[pos]
            f["qos"] = msg[pos + 1 : pos + 1 + qlen]
            pos += 1 + qlen
            alen = msg[pos]
            f["apn"] = msg[pos + 1 : pos + 1 + alen].decode()
            pos += 1 + alen
            plen = msg[pos]
            f["ip"] = ".".join(str(b) for b in msg[pos + 2 : pos + 1 + plen])
        return NasMessage(pd, mt, f)
    mt = msg[1]
    f = {}
    if mt == ATTACH_REQUEST:
        pos = 3
        mlen = msg[pos]
        f["imsi"] = bcd_to_imsi(msg[pos + 1 : pos + 1 + mlen])
        pos += 1 + mlen
        clen = msg[pos]
        f["ue_caps"] = msg[pos + 1 : pos + 1 + clen]
        pos += 1 + clen
        elen = int.from_bytes(msg[pos : pos + 2], "big")
        f["esm"] = msg[pos + 2 : pos + 2 + elen]
    elif mt == AUTHENTICATION_REQUEST:
        f["ksi"] = msg[2] & 0x0F
        f["rand"] = msg[3:19]
        f["autn"] = msg[20 : 20 + msg[19]]
    elif mt == AUTHENTICATION_RESPONSE:
        f["res"] = msg[3 : 3 + msg[2]]
    elif mt == SECURITY_MODE_COMMAND:
        f["eea"] = msg[2] >> 4
        f["eia"] = msg[2] & 0x0F
        f["ksi"] = msg[3] & 0x0F
    elif mt == ATTACH_ACCEPT:
        elen = int.from_bytes(msg[4:6], "big")
        f["esm"] = msg[6 : 6 + elen]
        f["m_tmsi"] = int.from_bytes(msg[6 + elen : 10 + elen], "big")
    elif mt == ATTACH_COMPLETE:
        elen = int.from_bytes(msg[2:4], "big")
        f["esm"] = msg[4 : 4 + elen]
    elif mt == DETACH_REQUEST:
        f["switch_off"] = bool(msg[2] & 0x08)
        f["detach_type"] = msg[2] & 0x07
        f["m_tmsi"] = int.from_bytes(msg[4 : 4 + msg[3]], "big")
    return NasMessage(PD_EMM, mt, f)


# ---------------------------------------------------------------------------
# NAS security context (§4.4)
# ---------------------------------------------------------------------------


class NasSecurityContext:
    def __init__(self, k_nas_enc: bytes, k_nas_int: bytes, eea: int, eia: int, is_ue: bool):
        self.k_enc = k_nas_enc
        self.k_int = k_nas_int
        self.eea = eea
        self.eia = eia
        self.tx_count = 0
        self.rx_count = 0
        # UE uplink = direction 0
        self.tx_dir = 0 if is_ue else 1

    def protect(self, plain: bytes, ciphered: bool = True, new_ctx: bool = False) -> bytes:
        count = self.tx_count
        self.tx_count += 1
        seq = count & 0xFF
        body = plain
        sht = SEC_HDR_INTEGRITY
        if ciphered and self.eea:
            body = sec.CIPHER_ALGS[self.eea](self.k_enc, count, 0, self.tx_dir, body, 8 * len(body))
            sht = SEC_HDR_INTEGRITY_CIPHERED
        if new_ctx:
            sht = SEC_HDR_INTEGRITY_NEW_CTX if not (ciphered and self.eea) else SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX
        mac = (
            sec.INTEGRITY_ALGS[self.eia](self.k_int, count, 0, self.tx_dir, bytes([seq]) + body)
            if self.eia
            else b"\x00\x00\x00\x00"
        )
        return bytes([(sht << 4) | PD_EMM]) + mac + bytes([seq]) + body

    def pack_service_request(self, ksi: int = 0) -> bytes:
        """SERVICE REQUEST (UE side): short format with 16-bit short MAC —
        the 2 LSBytes of the NAS-MAC over the first two octets
        (TS 24.301 §9.9.3.28)."""
        count = self.tx_count
        self.tx_count += 1
        hdr = bytes([(SEC_HDR_SERVICE_REQUEST << 4) | PD_EMM, ((ksi & 7) << 5) | (count & 0x1F)])
        if not self.eia:
            return hdr + b"\x00\x00"
        mac = sec.INTEGRITY_ALGS[self.eia](self.k_int, count, 0, self.tx_dir, hdr)
        return hdr + mac[2:4]

    def check_service_request(self, pdu: bytes) -> bool:
        """Network side: recover the UL count from the 5-bit seq and verify
        the short MAC."""
        seq5 = pdu[1] & 0x1F
        count = (self.rx_count & ~0x1F) | seq5
        if seq5 < (self.rx_count & 0x1F):
            count += 0x20
        if self.eia:
            exp = sec.INTEGRITY_ALGS[self.eia](self.k_int, count, 0, 1 - self.tx_dir, pdu[:2])
            if exp[2:4] != pdu[2:4]:
                return False
        self.rx_count = count + 1
        return True

    def unprotect(self, pdu: bytes) -> bytes | None:
        sht = pdu[0] >> 4
        if sht == SEC_HDR_PLAIN:
            return pdu
        mac, seq, body = pdu[1:5], pdu[5], pdu[6:]
        count = (self.rx_count & ~0xFF) | seq
        if seq < (self.rx_count & 0xFF):
            count += 0x100
        rx_dir = 1 - self.tx_dir
        if self.eia:
            exp = sec.INTEGRITY_ALGS[self.eia](self.k_int, count, 0, rx_dir, bytes([seq]) + body)
            if exp != mac:
                return None
        self.rx_count = count + 1
        if sht in (SEC_HDR_INTEGRITY_CIPHERED, SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX) and self.eea:
            body = sec.CIPHER_ALGS[self.eea](self.k_enc, count, 0, rx_dir, body, 8 * len(body))
        return body
