"""Host copy of `srsran_tpu/stack/gtpu.py`, held to it by `tests/test_torch_stack.py`.

GTP-U v1 codec + tunnel endpoint, TS 29.281 (re-design of
`lib/src/upper/gtpu.cc` header pack/unpack + `srsenb/src/stack/upper/
gtpu.cc` / `srsepc/src/spgw/gtpu.cc` endpoints).

The endpoint is transport-agnostic: it maps TEIDs to bearer queues and
produces/consumes wire-format packets; the caller moves bytes over UDP
port 2152 (or an in-process pipe in tests).
"""

from __future__ import annotations

import dataclasses
from collections import deque

GTPU_PORT = 2152
MSG_ECHO_REQUEST = 1
MSG_ECHO_RESPONSE = 2
MSG_ERROR_INDICATION = 26
MSG_GPDU = 255


@dataclasses.dataclass
class GtpuHeader:
    msg_type: int = MSG_GPDU
    teid: int = 0
    seq: int | None = None  # S flag when set

    def pack(self, payload_len: int) -> bytes:
        flags = 0x30  # version 1, PT=1
        ext = b""
        length = payload_len
        if self.seq is not None:
            flags |= 0x02
            ext = self.seq.to_bytes(2, "big") + b"\x00\x00"  # seq + npdu + next-ext
            length += 4
        return (
            bytes([flags, self.msg_type])
            + length.to_bytes(2, "big")
            + self.teid.to_bytes(4, "big")
            + ext
        )


def gtpu_pack(teid: int, payload: bytes, seq: int | None = None, msg_type: int = MSG_GPDU) -> bytes:
    return GtpuHeader(msg_type, teid, seq).pack(len(payload)) + payload


def gtpu_unpack(pkt: bytes) -> tuple[GtpuHeader, bytes] | None:
    if len(pkt) < 8 or (pkt[0] >> 5) != 1:
        return None
    flags = pkt[0]
    hdr = GtpuHeader(msg_type=pkt[1], teid=int.from_bytes(pkt[4:8], "big"))
    length = int.from_bytes(pkt[2:4], "big")
    pos = 8
    if flags & 0x07:  # any of E/S/PN → 4 extra header bytes
        hdr.seq = int.from_bytes(pkt[8:10], "big") if flags & 0x02 else None
        pos = 12
    return hdr, pkt[pos : 8 + length]


class GtpuEndpoint:
    """TEID-indexed tunnel endpoint (one per eNB / per SPGW)."""

    def __init__(self):
        self.rx_queues: dict[int, deque[bytes]] = {}
        self.tx_map: dict[int, int] = {}  # local bearer id -> remote TEID
        self.stats = {"rx_pdus": 0, "tx_pdus": 0, "rx_dropped": 0}

    def add_bearer(self, local_teid: int, remote_teid: int):
        self.rx_queues[local_teid] = deque()
        self.tx_map[local_teid] = remote_teid

    def rem_bearer(self, local_teid: int):
        self.rx_queues.pop(local_teid, None)
        self.tx_map.pop(local_teid, None)

    def tx(self, local_teid: int, sdu: bytes) -> bytes:
        """User PDU → wire packet for the peer."""
        self.stats["tx_pdus"] += 1
        return gtpu_pack(self.tx_map[local_teid], sdu)

    def rx(self, pkt: bytes) -> bytes | None:
        """Wire packet → enqueue on the TEID's bearer; returns an echo
        response packet if the input was an echo request."""
        out = gtpu_unpack(pkt)
        if out is None:
            self.stats["rx_dropped"] += 1
            return None
        hdr, payload = out
        if hdr.msg_type == MSG_ECHO_REQUEST:
            return gtpu_pack(0, b"", seq=hdr.seq or 0, msg_type=MSG_ECHO_RESPONSE)
        if hdr.msg_type != MSG_GPDU or hdr.teid not in self.rx_queues:
            self.stats["rx_dropped"] += 1
            return None
        self.rx_queues[hdr.teid].append(payload)
        self.stats["rx_pdus"] += 1
        return None

    def read(self, local_teid: int) -> bytes | None:
        q = self.rx_queues.get(local_teid)
        return q.popleft() if q else None
