"""Host copy of `srsran_tpu/epc/spgw.py`, held to it by `tests/test_torch_stack.py`.

SPGW: GTP-Cv2 session plane + GTP-U user-plane anchor + IP pool
(re-design of `srsepc/src/spgw/spgw.cc`, `gtpc.cc`, `gtpu.cc`).

Control plane: `handle_gtpc(bytes) -> bytes | None` consumes one S11
GTPv2-C message (Create Session / Modify Bearer / Release Access Bearers /
Delete Session / Echo) and returns the serialized response — the reference
passes in-memory structs between `mme_gtpc` and `spgw::gtpc`; here the
TS 29.274 wire format actually crosses the boundary.

User plane: the SGi side is a queue pair standing in for the TUN device —
packets the UE sends come out of `sgi_rx`; packets pushed into
`sgi_tx(ip, pkt)` are tunneled down to the right eNB bearer.  While a
session's access bearers are released (ECM-IDLE), downlink packets are
buffered and a Downlink Data Notification is queued toward the MME
(`srsepc/src/spgw/gtpc.cc` downlink-data-notification path).
"""

from __future__ import annotations

import dataclasses
from collections import deque

from ..stack import gtpc
from ..stack.gtpu import GtpuEndpoint, gtpu_pack, gtpu_unpack


@dataclasses.dataclass
class Session:
    imsi: str
    ebi: int
    ue_ip: str
    ctrl_teid: int          # our S11 TEID (== S1-U SGW TEID, like srsepc)
    mme_ctrl_teid: int
    enb_teid: int = 0       # S1-U eNB TEID; 0 → access bearers released
    buffered_dl: deque = dataclasses.field(default_factory=deque)
    ddn_pending: bool = False


class Spgw:
    def __init__(self, pool_base: str = "172.16.0.0", ip: str = "127.0.1.100"):
        self.ip = ip
        self.gtpu = GtpuEndpoint()
        self.next_teid = 1
        self.next_ip = 2
        self.pool_base = [int(x) for x in pool_base.split(".")]
        self.sessions: dict[int, Session] = {}  # by our ctrl TEID
        self.ip_to_teid: dict[str, int] = {}  # UE IP -> our (UL) TEID
        self.teid_to_enb: dict[int, int] = {}  # our TEID -> eNB DL TEID
        self.sgi_rx: deque[tuple[str, bytes]] = deque()
        self.sgi_tun = None  # optional kernel TUN on the SGi side
        self.tx_queue: deque[bytes] = deque()  # wire packets toward eNB
        self.gtpc_tx: deque[bytes] = deque()  # SPGW-initiated GTP-C (DDN)
        self._seq = 0

    # --- S11 control plane ---
    def handle_gtpc(self, data: bytes) -> bytes | None:
        msg_type, teid, seq, ies = gtpc.unpack(data)
        if msg_type == gtpc.ECHO_REQUEST:
            return gtpc.pack(gtpc.ECHO_RESPONSE, None, seq, [(gtpc.IE_RECOVERY, 0, 1)])
        if msg_type == gtpc.CREATE_SESSION_REQUEST:
            return self._create_session(seq, ies)
        sess = self.sessions.get(teid or 0)
        if sess is None:
            resp_type = {gtpc.MODIFY_BEARER_REQUEST: gtpc.MODIFY_BEARER_RESPONSE,
                         gtpc.RELEASE_ACCESS_BEARERS_REQUEST: gtpc.RELEASE_ACCESS_BEARERS_RESPONSE,
                         gtpc.DELETE_SESSION_REQUEST: gtpc.DELETE_SESSION_RESPONSE}.get(msg_type)
            if resp_type is None:
                return None
            return gtpc.pack(resp_type, 0, seq, [(gtpc.IE_CAUSE, 0, gtpc.CAUSE_CONTEXT_NOT_FOUND)])
        if msg_type == gtpc.MODIFY_BEARER_REQUEST:
            return self._modify_bearer(sess, seq, ies)
        if msg_type == gtpc.RELEASE_ACCESS_BEARERS_REQUEST:
            return self._release_access_bearers(sess, seq)
        if msg_type == gtpc.DELETE_SESSION_REQUEST:
            return self._delete_session(sess, seq)
        if msg_type == gtpc.DOWNLINK_DATA_NOTIFICATION_ACK:
            return None
        return None

    def _alloc_ip(self) -> str:
        b = self.pool_base.copy()
        b[3] = self.next_ip & 0xFF
        b[2] += self.next_ip >> 8
        self.next_ip += 1
        return ".".join(map(str, b))

    def _create_session(self, seq: int, ies) -> bytes:
        imsi = gtpc.find_ie(ies, gtpc.IE_IMSI) or ""
        mme_fteid = gtpc.find_ie(ies, gtpc.IE_FTEID, 0) or {"teid": 0, "ip": ""}
        bctx = gtpc.find_ie(ies, gtpc.IE_BEARER_CONTEXT, 0) or []
        ebi = gtpc.find_ie(bctx, gtpc.IE_EBI) or 5
        req_ip = gtpc.find_ie(ies, gtpc.IE_PAA)
        teid = self.next_teid
        self.next_teid += 1
        ue_ip = req_ip if req_ip and req_ip != "0.0.0.0" else self._alloc_ip()
        sess = Session(imsi=imsi, ebi=ebi, ue_ip=ue_ip, ctrl_teid=teid,
                       mme_ctrl_teid=mme_fteid["teid"])
        self.sessions[teid] = sess
        self.ip_to_teid[ue_ip] = teid
        self.teid_to_enb[teid] = 0
        self.gtpu.add_bearer(teid, 0)
        bearer = [(gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED),
                  (gtpc.IE_EBI, 0, ebi),
                  (gtpc.IE_FTEID, 0, {"iface": gtpc.FTEID_S1U_SGW, "teid": teid, "ip": self.ip})]
        return gtpc.pack(gtpc.CREATE_SESSION_RESPONSE, sess.mme_ctrl_teid, seq, [
            (gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED),
            (gtpc.IE_FTEID, 0, {"iface": gtpc.FTEID_S11S4_SGW, "teid": teid, "ip": self.ip}),
            (gtpc.IE_PAA, 0, ue_ip),
            (gtpc.IE_BEARER_CONTEXT, 0, bearer),
        ])

    def _modify_bearer(self, sess: Session, seq: int, ies) -> bytes:
        bctx = gtpc.find_ie(ies, gtpc.IE_BEARER_CONTEXT, 0) or []
        enb_fteid = gtpc.find_ie(bctx, gtpc.IE_FTEID, 0)
        if enb_fteid is not None:
            sess.enb_teid = enb_fteid["teid"]
            self.teid_to_enb[sess.ctrl_teid] = sess.enb_teid
            self.gtpu.tx_map[sess.ctrl_teid] = sess.enb_teid
            sess.ddn_pending = False
            while sess.buffered_dl:  # flush packets buffered while idle
                self.tx_queue.append(gtpu_pack(sess.enb_teid, sess.buffered_dl.popleft()))
        bearer = [(gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED), (gtpc.IE_EBI, 0, sess.ebi)]
        return gtpc.pack(gtpc.MODIFY_BEARER_RESPONSE, sess.mme_ctrl_teid, seq, [
            (gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED),
            (gtpc.IE_BEARER_CONTEXT, 0, bearer),
        ])

    def _release_access_bearers(self, sess: Session, seq: int) -> bytes:
        sess.enb_teid = 0
        self.teid_to_enb[sess.ctrl_teid] = 0
        self.gtpu.tx_map.pop(sess.ctrl_teid, None)
        return gtpc.pack(gtpc.RELEASE_ACCESS_BEARERS_RESPONSE, sess.mme_ctrl_teid, seq,
                         [(gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED)])

    def _delete_session(self, sess: Session, seq: int) -> bytes:
        self.sessions.pop(sess.ctrl_teid, None)
        self.ip_to_teid.pop(sess.ue_ip, None)
        self.teid_to_enb.pop(sess.ctrl_teid, None)
        self.gtpu.rem_bearer(sess.ctrl_teid)
        return gtpc.pack(gtpc.DELETE_SESSION_RESPONSE, sess.mme_ctrl_teid, seq,
                         [(gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED)])

    # --- user plane ---
    def rx_from_enb(self, pkt: bytes):
        """Uplink wire packet from an eNB → SGi."""
        out = gtpu_unpack(pkt)
        if out is None:
            return
        hdr, payload = out
        if hdr.teid in self.teid_to_enb:
            # IPv4 source address from the inner packet, else teid owner
            ip = next((k for k, v in self.ip_to_teid.items() if v == hdr.teid), "?")
            self.sgi_rx.append((ip, payload))

    def sgi_tx(self, ue_ip: str, pkt: bytes):
        """Downlink IP packet from the internet side → tunnel to eNB.

        If the session's access bearers are released, buffer + queue a
        Downlink Data Notification toward the MME instead.
        """
        teid = self.ip_to_teid.get(ue_ip)
        if teid is None:
            return
        sess = self.sessions.get(teid)
        enb = self.teid_to_enb.get(teid, 0)
        if enb == 0 and sess is not None:
            sess.buffered_dl.append(pkt)
            if not sess.ddn_pending:
                sess.ddn_pending = True
                self._seq += 1
                self.gtpc_tx.append(gtpc.pack(
                    gtpc.DOWNLINK_DATA_NOTIFICATION, sess.mme_ctrl_teid, self._seq,
                    [(gtpc.IE_EBI, 0, sess.ebi)]))
            return
        self.tx_queue.append(gtpu_pack(enb, pkt))

    def pop_tx(self) -> bytes | None:
        return self.tx_queue.popleft() if self.tx_queue else None


    # --- optional kernel SGi boundary (srsepc spgw/gtpu.cc TUN role) ---
    def attach_tun(self, name: str = "tun_sgi0", gw_ip: str = "172.16.0.254"):
        """Open a kernel TUN for the SGi interface: the UE address pool is
        routed into it, so real sockets/ping on this host exchange traffic
        with attached UEs through the whole RAN path.  Not ported yet: the
        kernel TUN boundary belongs to the `io/` slice (ROADMAP)."""
        raise NotImplementedError("Spgw.attach_tun needs io/tun.py, not ported yet "
                                  "(ROADMAP, the io/ slice)")

    def pump_tun(self):
        """Move packets between the kernel TUN and the GTP-U plane: DL
        (kernel -> pool address) into sgi_tx, UL (sgi_rx) into the kernel."""
        if self.sgi_tun is None:
            return
        self.sgi_tun.pump_dl(self.sgi_tx)
        while self.sgi_rx:
            _ip, pkt = self.sgi_rx.popleft()
            self.sgi_tun.inject_ul(pkt)
