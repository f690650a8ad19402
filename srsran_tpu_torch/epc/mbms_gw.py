"""Host copy of `srsran_tpu/epc/mbms_gw.py`, held to it by `tests/test_torch_stack.py`.

MBMS-GW: the eMBMS user-plane gateway (re-design of
`srsepc/src/mbms-gw/mbms-gw.cc`).

The reference reads multicast IP packets from an SGi-mb TUN device,
encapsulates them in GTP-U with the fixed M1-U TEID (0xAAAA,
mbms-gw.cc:274) and sends them to an M1-U multicast group toward all
eNBs.  Here the SGi-mb side is a queue (like `Spgw.sgi_tx`) and the
"multicast send" is a wire-packet queue every subscribed eNB drains; the
eNB side (`M1uReceiver`) unpacks the tunnel and feeds the PMCH scheduler.
"""

from __future__ import annotations

from collections import deque

from ..stack.gtpu import gtpu_pack, gtpu_unpack

M1U_TEID = 0xAAAA  # fixed downlink tunnel id (mbms-gw.cc:274)


class MbmsGw:
    """SGi-mb ingress → GTP-U (M1-U) egress."""

    def __init__(self, teid: int = M1U_TEID):
        self.teid = teid
        self.tx_queue: deque[bytes] = deque()  # GTP-U wire packets (M1-U)
        self.pkts_tx = 0

    def sgi_mb_rx(self, ip_pkt: bytes):
        """A multicast IP packet arrived on SGi-mb: tunnel it."""
        self.tx_queue.append(gtpu_pack(self.teid, bytes(ip_pkt)))
        self.pkts_tx += 1

    def pop_tx(self) -> bytes | None:
        return self.tx_queue.popleft() if self.tx_queue else None


class M1uReceiver:
    """eNB-side M1-U endpoint: GTP-U in → MCH SDU queue for the PMCH
    scheduler (the `mch_handler` role in srsenb)."""

    def __init__(self, teid: int = M1U_TEID):
        self.teid = teid
        self.mch_queue: deque[bytes] = deque()
        self.pkts_rx = 0

    def rx(self, wire_pkt: bytes):
        out = gtpu_unpack(wire_pkt)
        if out is None:
            return
        hdr, payload = out
        if hdr.teid != self.teid:
            return
        self.mch_queue.append(payload)
        self.pkts_rx += 1

    def read_mch_sdu(self) -> bytes | None:
        return self.mch_queue.popleft() if self.mch_queue else None
