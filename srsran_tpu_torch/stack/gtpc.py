"""Host copy of `srsran_tpu/stack/gtpc.py`, held to it by `tests/test_torch_stack.py`.

GTP-Cv2 codec (TS 29.274) — the S11 control plane between MME and S-GW.

Re-design of the reference's GTP-C layer (`lib/include/srslte/asn1/gtpc*.h`,
`lib/src/asn1/gtpc.cc`, used by `srsepc/src/mme/mme_gtpc.cc` and
`srsepc/src/spgw/gtpc.cc`). The reference passes C structs between MME and
SPGW in-process; here the messages are actually serialized to the TS 29.274
wire format (header + TLV IEs), so the control plane can cross a socket.

Scope: the procedures srsEPC runs — Create Session, Modify Bearer,
Delete Session, Release Access Bearers, Downlink Data Notification (+Ack),
Echo. IEs are decoded into plain Python values keyed by (name) with
grouped Bearer Context support.
"""

from __future__ import annotations

import struct

# --- message types (TS 29.274 table 6.1-1) ---
ECHO_REQUEST = 1
ECHO_RESPONSE = 2
CREATE_SESSION_REQUEST = 32
CREATE_SESSION_RESPONSE = 33
MODIFY_BEARER_REQUEST = 34
MODIFY_BEARER_RESPONSE = 35
DELETE_SESSION_REQUEST = 36
DELETE_SESSION_RESPONSE = 37
RELEASE_ACCESS_BEARERS_REQUEST = 170
RELEASE_ACCESS_BEARERS_RESPONSE = 171
DOWNLINK_DATA_NOTIFICATION = 176
DOWNLINK_DATA_NOTIFICATION_ACK = 177

MSG_NAMES = {
    ECHO_REQUEST: "echo_request",
    ECHO_RESPONSE: "echo_response",
    CREATE_SESSION_REQUEST: "create_session_request",
    CREATE_SESSION_RESPONSE: "create_session_response",
    MODIFY_BEARER_REQUEST: "modify_bearer_request",
    MODIFY_BEARER_RESPONSE: "modify_bearer_response",
    DELETE_SESSION_REQUEST: "delete_session_request",
    DELETE_SESSION_RESPONSE: "delete_session_response",
    RELEASE_ACCESS_BEARERS_REQUEST: "release_access_bearers_request",
    RELEASE_ACCESS_BEARERS_RESPONSE: "release_access_bearers_response",
    DOWNLINK_DATA_NOTIFICATION: "downlink_data_notification",
    DOWNLINK_DATA_NOTIFICATION_ACK: "downlink_data_notification_ack",
}

# --- IE types (TS 29.274 table 8.1-1) ---
IE_IMSI = 1
IE_CAUSE = 2
IE_RECOVERY = 3
IE_APN = 71
IE_AMBR = 72
IE_EBI = 73
IE_PAA = 79
IE_BEARER_QOS = 80
IE_RAT_TYPE = 82
IE_SERVING_NETWORK = 83
IE_FTEID = 87
IE_BEARER_CONTEXT = 93
IE_CHARGING_ID = 94

# F-TEID interface types (TS 29.274 §8.22)
FTEID_S1U_ENB = 0
FTEID_S1U_SGW = 1
FTEID_S11_MME = 10
FTEID_S11S4_SGW = 11
FTEID_S5S8_PGW_C = 7

CAUSE_REQUEST_ACCEPTED = 16
CAUSE_CONTEXT_NOT_FOUND = 64

RAT_TYPE_EUTRAN = 6


# --- primitive IE value codecs ---

def _tbcd_encode(digits: str) -> bytes:
    """Nibble-swapped BCD with 0xF pad (TS 29.274 §8.3 IMSI format)."""
    out = bytearray()
    for i in range(0, len(digits), 2):
        lo = int(digits[i])
        hi = int(digits[i + 1]) if i + 1 < len(digits) else 0xF
        out.append((hi << 4) | lo)
    return bytes(out)


def _tbcd_decode(data: bytes) -> str:
    digits = []
    for b in data:
        digits.append(str(b & 0xF))
        hi = b >> 4
        if hi != 0xF:
            digits.append(str(hi))
    return "".join(digits)


def _ip4_pack(ip: str) -> bytes:
    return bytes(int(x) for x in ip.split("."))


def _ip4_unpack(b: bytes) -> str:
    return ".".join(str(x) for x in b)


def pack_fteid(iface: int, teid: int, ip: str) -> bytes:
    return bytes([0x80 | (iface & 0x3F)]) + struct.pack(">I", teid) + _ip4_pack(ip)


def unpack_fteid(v: bytes) -> dict:
    iface = v[0] & 0x3F
    teid = struct.unpack(">I", v[1:5])[0]
    ip = _ip4_unpack(v[5:9]) if v[0] & 0x80 else ""
    return {"iface": iface, "teid": teid, "ip": ip}


def pack_bearer_qos(qci: int = 9, pl: int = 11, pci: bool = False, pvi: bool = False,
                    mbr_ul: int = 0, mbr_dl: int = 0, gbr_ul: int = 0, gbr_dl: int = 0) -> bytes:
    arp = ((pci << 6) | ((pl & 0xF) << 2) | (pvi & 1))
    out = bytes([arp, qci])
    for r in (mbr_ul, mbr_dl, gbr_ul, gbr_dl):
        out += r.to_bytes(5, "big")
    return out


def unpack_bearer_qos(v: bytes) -> dict:
    rates = [int.from_bytes(v[2 + 5 * i:7 + 5 * i], "big") for i in range(4)]
    return {"qci": v[1], "pl": (v[0] >> 2) & 0xF, "pci": bool(v[0] & 0x40),
            "pvi": bool(v[0] & 1), "mbr_ul": rates[0], "mbr_dl": rates[1],
            "gbr_ul": rates[2], "gbr_dl": rates[3]}


def pack_apn(apn: str) -> bytes:
    out = bytearray()
    for label in apn.split("."):
        out.append(len(label))
        out += label.encode()
    return bytes(out)


def unpack_apn(v: bytes) -> str:
    labels, i = [], 0
    while i < len(v):
        n = v[i]
        labels.append(v[i + 1:i + 1 + n].decode())
        i += 1 + n
    return ".".join(labels)


# value-level encode/decode per IE type; grouped IEs recurse
def _encode_ie_value(ie_type: int, value) -> bytes:
    if ie_type == IE_IMSI:
        return _tbcd_encode(value)
    if ie_type in (IE_CAUSE,):
        return bytes([value, 0])  # cause value + spare/CS-PCE-BCE flags
    if ie_type == IE_RECOVERY:
        return bytes([value])
    if ie_type == IE_APN:
        return pack_apn(value)
    if ie_type == IE_AMBR:
        return struct.pack(">II", value[0], value[1])
    if ie_type == IE_EBI:
        return bytes([value & 0xF])
    if ie_type == IE_PAA:
        return bytes([1]) + _ip4_pack(value)  # PDN type IPv4
    if ie_type == IE_BEARER_QOS:
        return pack_bearer_qos(**value) if isinstance(value, dict) else bytes(value)
    if ie_type == IE_RAT_TYPE:
        return bytes([value])
    if ie_type == IE_SERVING_NETWORK:
        return bytes(value)
    if ie_type == IE_FTEID:
        return pack_fteid(value["iface"], value["teid"], value["ip"])
    if ie_type == IE_BEARER_CONTEXT:
        return _encode_ies(value)
    if ie_type == IE_CHARGING_ID:
        return struct.pack(">I", value)
    raise ValueError(f"unsupported IE type {ie_type}")


def _decode_ie_value(ie_type: int, v: bytes):
    if ie_type == IE_IMSI:
        return _tbcd_decode(v)
    if ie_type == IE_CAUSE:
        return v[0]
    if ie_type == IE_RECOVERY:
        return v[0]
    if ie_type == IE_APN:
        return unpack_apn(v)
    if ie_type == IE_AMBR:
        return struct.unpack(">II", v[:8])
    if ie_type == IE_EBI:
        return v[0] & 0xF
    if ie_type == IE_PAA:
        return _ip4_unpack(v[1:5])
    if ie_type == IE_BEARER_QOS:
        return unpack_bearer_qos(v)
    if ie_type == IE_RAT_TYPE:
        return v[0]
    if ie_type == IE_SERVING_NETWORK:
        return bytes(v)
    if ie_type == IE_FTEID:
        return unpack_fteid(v)
    if ie_type == IE_BEARER_CONTEXT:
        return _decode_ies(v)
    if ie_type == IE_CHARGING_ID:
        return struct.unpack(">I", v[:4])[0]
    return bytes(v)  # unknown IE: raw


def _encode_ies(ies: list[tuple[int, int, object]]) -> bytes:
    out = bytearray()
    for ie_type, instance, value in ies:
        v = _encode_ie_value(ie_type, value)
        out += struct.pack(">BHB", ie_type, len(v), instance & 0xF)
        out += v
    return bytes(out)


def _decode_ies(data: bytes) -> list[tuple[int, int, object]]:
    ies, i = [], 0
    while i + 4 <= len(data):
        ie_type, length, flags = struct.unpack(">BHB", data[i:i + 4])
        v = data[i + 4:i + 4 + length]
        ies.append((ie_type, flags & 0xF, _decode_ie_value(ie_type, v)))
        i += 4 + length
    return ies


def pack(msg_type: int, teid: int | None, seq: int, ies: list[tuple[int, int, object]]) -> bytes:
    """GTPv2-C message. teid=None → T flag clear (echo only)."""
    body = _encode_ies(ies)
    if teid is None:
        tail = struct.pack(">I", (seq & 0xFFFFFF) << 8)
        hdr0 = 0x40  # version 2, no piggyback, no TEID
    else:
        tail = struct.pack(">II", teid, (seq & 0xFFFFFF) << 8)
        hdr0 = 0x48  # version 2, T flag
    return bytes([hdr0, msg_type]) + struct.pack(">H", len(tail) + len(body)) + tail + body


def unpack(data: bytes) -> tuple[int, int | None, int, list[tuple[int, int, object]]]:
    """→ (msg_type, teid|None, seq, ies)."""
    if (data[0] >> 5) != 2:
        raise ValueError("not a GTPv2-C message")
    msg_type = data[1]
    length = struct.unpack(">H", data[2:4])[0]
    if data[0] & 0x08:
        teid = struct.unpack(">I", data[4:8])[0]
        seq = struct.unpack(">I", data[8:12])[0] >> 8
        body = data[12:4 + length]
    else:
        teid = None
        seq = struct.unpack(">I", data[4:8])[0] >> 8
        body = data[8:4 + length]
    return msg_type, teid, seq, _decode_ies(body)


def find_ie(ies: list[tuple[int, int, object]], ie_type: int, instance: int = 0):
    for t, inst, v in ies:
        if t == ie_type and inst == instance:
            return v
    return None
