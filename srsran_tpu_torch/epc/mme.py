"""Host copy of `srsran_tpu/epc/mme.py`, held to it by `tests/test_torch_stack.py`.

MME: S1AP endpoint + per-UE NAS EMM state machine + S11 GTP-C client
(re-design of `srsepc/src/mme/mme.cc`, `nas.cc` 1,969 LoC, `mme_gtpc.cc`).

Message-driven: `handle(s1ap_bytes) -> [s1ap_bytes...]` — the caller owns
the transport (TCP socket or in-process queue). The S11 side toward the
SPGW is a request/response callable carrying serialized TS 29.274 GTP-Cv2
(the reference passes in-memory structs between `mme_gtpc` and
`spgw::gtpc`; here the real wire format crosses the boundary).

Attach call flow per TS 23.401 §5.3.2:

  InitialUEMessage(AttachRequest)
    → DownlinkNASTransport(AuthenticationRequest)
  UplinkNASTransport(AuthenticationResponse)      [XRES check]
    → DownlinkNASTransport(SecurityModeCommand)   [integrity, new ctx]
  UplinkNASTransport(SecurityModeComplete)        [protected]
    → S11 CreateSessionRequest / Response         [PAA + S1-U SGW TEID]
    → InitialContextSetupRequest(AttachAccept + ActivateDefaultBearer,
                                 K_eNB, SPGW UL TEID)
  InitialContextSetupResponse(eNB DL TEID)
    → S11 ModifyBearerRequest                     [bearer switched]

Idle-mode chain (TS 23.401 §5.3.4.3 / §5.3.5):

  UEContextReleaseRequest → S11 ReleaseAccessBearers
    → UEContextReleaseCommand (ECM-IDLE)
  [DL data] S11 DownlinkDataNotification → Ack + S1AP Paging
  InitialUEMessage(ServiceRequest, s-TMSI)        [short-MAC check]
    → InitialContextSetupRequest (no NAS)
  InitialContextSetupResponse → S11 ModifyBearer  [buffered DL flushed]
"""

from __future__ import annotations

import dataclasses

from ..stack import gtpc, nas, security as sec
from . import s1ap
from .hss import Hss
from .spgw import Spgw

EMM_DEREGISTERED = 0
EMM_AUTH_PENDING = 1
EMM_SMC_PENDING = 2
EMM_ATTACH_ACCEPTED = 3
EMM_REGISTERED = 4

MMEC = 0x1A


@dataclasses.dataclass
class UeCtx:
    mme_ue_id: int
    enb_ue_id: int
    imsi: str = ""
    state: int = EMM_DEREGISTERED
    xres: bytes = b""
    k_asme: bytes = b""
    sec_ctx: nas.NasSecurityContext | None = None
    ue_ip: str = ""
    m_tmsi: int = 0
    spgw_teid: int = 0       # S1-U SGW TEID (from Create Session Response)
    sgw_ctrl_teid: int = 0   # S11 SGW control TEID
    ebi: int = 5
    ecm_connected: bool = False
    nas_ksi: int = 0
    kenb_ncc: int = 0
    serving_enb_id: int | None = None


class Mme:
    def __init__(self, hss: Hss, spgw: Spgw, eea: int = 2, eia: int = 2,
                 plmn: bytes = b"\x00\xf1\x10", ip: str = "127.0.1.2"):
        self.hss = hss
        self.spgw = spgw
        self.ip = ip
        # S11 request/response channel; default: in-process serialized call
        self.s11 = spgw.handle_gtpc
        self.eea = eea
        self.eia = eia
        self.plmn = plmn
        self.next_mme_ue_id = 1
        self.next_m_tmsi = 0xA0001000
        self._s11_seq = 0
        self.ues: dict[int, UeCtx] = {}
        self.by_tmsi: dict[int, UeCtx] = {}
        self.attached_imsis: set[str] = set()
        # S1 handover plumbing: registered eNB links + in-flight HO state
        self.enb_links: dict[int, object] = {}  # macro enb id -> rx callable
        self._ho: dict[int, dict] = {}  # mme_ue_id -> {src_enb, src_enb_ue_id, ...}

    def register_enb(self, enb_id: int, link):
        """Associate an eNB's S1AP receive callback (the SCTP association
        the reference keeps per eNB, mme.cc:113)."""
        self.enb_links[enb_id] = link

    def pump_s11(self):
        """Drain SPGW-initiated S11 (Downlink Data Notifications) and
        broadcast the resulting S1AP Paging over every eNB association
        (mme.cc paging fan-out to all eNBs in the tracking area)."""
        q = getattr(self.spgw, "gtpc_tx", None)
        while q:
            msg = q.popleft()
            for pdu in self.handle_gtpc(msg):
                for link in list(self.enb_links.values()):
                    link(pdu)

    def handle(self, data: bytes, enb_id: int | None = None) -> list[bytes]:
        """Process ONE S1AP PDU (the SCTP-datagram framing contract).
        `enb_id` identifies the sending eNB association (for procedures
        that must answer toward a DIFFERENT eNB — S1 handover)."""
        name, ies = s1ap.unpack(data)
        if name == "s1_setup_request":
            return [s1ap.pack_s1_setup_response(plmn=self.plmn)]
        if name == "ho_required":
            return self._ho_required(ies, enb_id)
        if name == "ho_request_ack":
            return self._ho_request_ack(ies)
        if name == "ho_notify":
            return self._ho_notify(ies, enb_id)
        if name == "init_ue_msg":
            return self._initial_ue(ies, enb_id)
        if name == "ul_nas_transport":
            return self._ul_nas(ies)
        if name == "init_context_setup_response":
            return self._ctx_setup_response(ies)
        if name == "ue_context_release_request":
            return self._release_request(ies)
        if name == "ue_context_release_complete":
            ue = self.ues.get(ies["mme_ue_s1ap_id"])
            if ue is not None:
                ue.ecm_connected = False
            return []
        return []

    def handle_gtpc(self, data: bytes) -> list[bytes]:
        """SPGW-initiated GTP-C (Downlink Data Notification) → S1AP out."""
        msg_type, teid, seq, ies = gtpc.unpack(data)
        if msg_type != gtpc.DOWNLINK_DATA_NOTIFICATION:
            return []
        self.s11(gtpc.pack(gtpc.DOWNLINK_DATA_NOTIFICATION_ACK, 0, seq,
                           [(gtpc.IE_CAUSE, 0, gtpc.CAUSE_REQUEST_ACCEPTED)]))
        ue = self.ues.get(teid or 0)  # our S11 TEID == mme_ue_id
        if ue is None or ue.ecm_connected:
            return []
        return [s1ap.pack_paging(ue.m_tmsi, mmec=MMEC, plmn=self.plmn, imsi=None)]

    # --- S11 helpers ---
    def _s11_request(self, msg_type: int, teid: int, ies) -> tuple[int, list] | None:
        self._s11_seq += 1
        resp = self.s11(gtpc.pack(msg_type, teid, self._s11_seq, ies))
        if resp is None:
            return None
        rtype, _rteid, _rseq, ries = gtpc.unpack(resp)
        return rtype, ries

    def _create_session(self, ue: UeCtx) -> bool:
        bearer = [(gtpc.IE_EBI, 0, ue.ebi),
                  (gtpc.IE_BEARER_QOS, 0, {"qci": 9, "pl": 15})]
        out = self._s11_request(gtpc.CREATE_SESSION_REQUEST, 0, [
            (gtpc.IE_IMSI, 0, ue.imsi),
            (gtpc.IE_RAT_TYPE, 0, gtpc.RAT_TYPE_EUTRAN),
            (gtpc.IE_FTEID, 0, {"iface": gtpc.FTEID_S11_MME, "teid": ue.mme_ue_id, "ip": self.ip}),
            (gtpc.IE_APN, 0, "srsapn"),
            (gtpc.IE_PAA, 0, "0.0.0.0"),
            (gtpc.IE_AMBR, 0, (1_000_000, 1_000_000)),
            (gtpc.IE_BEARER_CONTEXT, 0, bearer),
        ])
        if out is None:
            return False
        _, ries = out
        if gtpc.find_ie(ries, gtpc.IE_CAUSE) != gtpc.CAUSE_REQUEST_ACCEPTED:
            return False
        ue.ue_ip = gtpc.find_ie(ries, gtpc.IE_PAA) or ""
        sgw_fteid = gtpc.find_ie(ries, gtpc.IE_FTEID, 0) or {"teid": 0}
        ue.sgw_ctrl_teid = sgw_fteid["teid"]
        bctx = gtpc.find_ie(ries, gtpc.IE_BEARER_CONTEXT, 0) or []
        s1u = gtpc.find_ie(bctx, gtpc.IE_FTEID, 0) or {"teid": 0}
        ue.spgw_teid = s1u["teid"]
        return True

    def _modify_bearer(self, ue: UeCtx, enb_teid: int, enb_ip: str = "10.0.0.2"):
        bearer = [(gtpc.IE_EBI, 0, ue.ebi),
                  (gtpc.IE_FTEID, 0, {"iface": gtpc.FTEID_S1U_ENB, "teid": enb_teid, "ip": enb_ip})]
        self._s11_request(gtpc.MODIFY_BEARER_REQUEST, ue.sgw_ctrl_teid,
                          [(gtpc.IE_BEARER_CONTEXT, 0, bearer)])

    def _release_access_bearers(self, ue: UeCtx):
        self._s11_request(gtpc.RELEASE_ACCESS_BEARERS_REQUEST, ue.sgw_ctrl_teid, [])

    def delete_session(self, ue: UeCtx):
        self._s11_request(gtpc.DELETE_SESSION_REQUEST, ue.sgw_ctrl_teid,
                          [(gtpc.IE_EBI, 0, ue.ebi)])

    # --- procedures ---
    # --- S1 handover (36.413 §8.4; rrc_mobility.cc S1 path + mme HO relay) ---
    def _ho_required(self, ies: dict, src_enb_id: int | None) -> list[bytes]:
        ue = self.ues.get(ies["mme_ue_s1ap_id"])
        tgt = ies["target_id"]
        if ue is None or tgt[0] != "targetenb_id":
            return []
        target_enb_id = tgt[1]["global_enb_id"]["enb_id"][1]
        link = self.enb_links.get(target_enb_id)
        if link is None:
            return []
        # NH chaining (TS 33.401 §7.2.8.4 simplified: fresh vertical KeNB)
        ue.kenb_ncc += 1
        next_hop = sec.generate_k_enb(ue.k_asme, ue.kenb_ncc)
        self._ho[ue.mme_ue_id] = {
            "src_enb": src_enb_id, "src_enb_ue_id": ies["enb_ue_s1ap_id"],
            "target_enb": target_enb_id,
        }
        link(s1ap.pack_handover_request(
            ue.mme_ue_id, ue.spgw_teid,
            ies["source_to_target_transparent_container"],
            next_hop, ncc=ue.kenb_ncc, ebi=ue.ebi))
        return []

    def _ho_request_ack(self, ies: dict) -> list[bytes]:
        ue = self.ues.get(ies["mme_ue_s1ap_id"])
        ho = self._ho.get(ies["mme_ue_s1ap_id"])
        if ue is None or ho is None:
            return []
        ho["target_enb_ue_id"] = ies["enb_ue_s1ap_id"]
        ho["target_teid"] = int.from_bytes(
            ies["erab_admitted_list"][0]["gtp_teid"], "big")
        src_link = self.enb_links.get(ho["src_enb"])
        if src_link is not None:
            src_link(s1ap.pack_handover_command(
                ue.mme_ue_id, ho["src_enb_ue_id"],
                ies["target_to_source_transparent_container"]))
        return []

    def _ho_notify(self, ies: dict, enb_id: int | None) -> list[bytes]:
        ue = self.ues.get(ies["mme_ue_s1ap_id"])
        ho = self._ho.pop(ies["mme_ue_s1ap_id"], None)
        if ue is None or ho is None:
            return []
        # path switch: point the SGW's S1-U at the target eNB (S11 Modify
        # Bearer — the reference's mme_gtpc.cc on HandoverNotify)
        self._modify_bearer(ue, ho["target_teid"])
        ue.enb_ue_id = ies["enb_ue_s1ap_id"]
        ue.serving_enb_id = ho["target_enb"]
        src_link = self.enb_links.get(ho["src_enb"])
        if src_link is not None:
            src_link(s1ap.pack_ue_context_release_command(
                ue.mme_ue_id, ho["src_enb_ue_id"], cause=("radio_network", "successful_ho")))
        return []

    def _initial_ue(self, ies: dict, enb_id: int | None = None) -> list[bytes]:
        enb_ue_id = ies["enb_ue_s1ap_id"]
        pdu = ies["nas_pdu"]
        if (pdu[0] >> 4) == nas.SEC_HDR_SERVICE_REQUEST:
            return self._service_request(enb_ue_id, ies, pdu)
        ue = UeCtx(self.next_mme_ue_id, enb_ue_id, serving_enb_id=enb_id)
        self.next_mme_ue_id += 1
        self.ues[ue.mme_ue_id] = ue
        msg = nas.unpack(pdu)
        if msg.msg_type != nas.ATTACH_REQUEST:
            return []
        ue.imsi = msg.fields["imsi"]
        av = self.hss.get_auth_vector(ue.imsi, self.plmn)
        if av is None:
            return []  # unknown IMSI → (attach reject elided)
        ue.xres = av.xres
        ue.k_asme = av.k_asme
        ue.state = EMM_AUTH_PENDING
        ue.ecm_connected = True
        pdu = nas.pack_authentication_request(av.rand, av.autn)
        return [self._dl_nas(ue, pdu)]

    def _service_request(self, enb_ue_id: int, ies: dict, pdu: bytes) -> list[bytes]:
        """UE-triggered (or paging-response) transition ECM-IDLE→CONNECTED."""
        s_tmsi = ies.get("s_tmsi")
        if s_tmsi is None:
            return []
        ue = self.by_tmsi.get(int.from_bytes(s_tmsi["m_tmsi"], "big"))
        if ue is None or ue.sec_ctx is None or ue.state != EMM_REGISTERED:
            return []
        if not ue.sec_ctx.check_service_request(pdu):
            return []
        ue.enb_ue_id = enb_ue_id
        ue.ecm_connected = True
        # new K_eNB from the current NAS UL count (TS 33.401 §7.2.8 simplified)
        k_enb = sec.generate_k_enb(ue.k_asme, ue.sec_ctx.rx_count - 1)
        return [s1ap.pack_initial_context_setup_request(
            ue.mme_ue_id, ue.enb_ue_id, b"", k_enb,
            spgw_teid=ue.spgw_teid, ebi=ue.ebi)]

    def _ul_nas(self, ies: dict) -> list[bytes]:
        ue = self.ues.get(ies["mme_ue_s1ap_id"])
        if ue is None:
            return []
        pdu = ies["nas_pdu"]
        if ue.sec_ctx is not None and (pdu[0] >> 4) != nas.SEC_HDR_PLAIN:
            inner = ue.sec_ctx.unprotect(pdu)
            if inner is None:
                return []
        else:
            inner = pdu
        msg = nas.unpack(inner)
        if msg.msg_type == nas.AUTHENTICATION_RESPONSE and ue.state == EMM_AUTH_PENDING:
            if msg.fields["res"] != ue.xres:
                return []  # auth failure
            k_enc, k_int = sec.generate_nas_keys(ue.k_asme, self.eea, self.eia)
            ue.sec_ctx = nas.NasSecurityContext(k_enc, k_int, self.eea, self.eia, is_ue=False)
            ue.state = EMM_SMC_PENDING
            smc = nas.pack_security_mode_command(self.eea, self.eia)
            # SMC: integrity only, new context (TS 24.301 §5.4.3)
            prot = ue.sec_ctx.protect(smc, ciphered=False, new_ctx=True)
            return [self._dl_nas(ue, prot)]
        if msg.msg_type == nas.SECURITY_MODE_COMPLETE and ue.state == EMM_SMC_PENDING:
            # default-bearer session via S11; eNB DL TEID arrives in ctx setup rsp
            if not self._create_session(ue):
                return []
            ue.m_tmsi = self.next_m_tmsi
            self.next_m_tmsi += 1
            self.by_tmsi[ue.m_tmsi] = ue
            accept = nas.pack_attach_accept(ue.ue_ip, m_tmsi=ue.m_tmsi, ebi=ue.ebi)
            prot = ue.sec_ctx.protect(accept)
            k_enb = sec.generate_k_enb(ue.k_asme, 0)
            ue.state = EMM_ATTACH_ACCEPTED
            return [
                s1ap.pack_initial_context_setup_request(
                    ue.mme_ue_id, ue.enb_ue_id, prot, k_enb,
                    spgw_teid=ue.spgw_teid, ebi=ue.ebi,
                )
            ]
        if msg.msg_type == nas.ATTACH_COMPLETE and ue.state == EMM_ATTACH_ACCEPTED:
            ue.state = EMM_REGISTERED
            self.attached_imsis.add(ue.imsi)
            return []
        if msg.msg_type == nas.DETACH_REQUEST:
            # UE-initiated detach (TS 24.301 §5.5.2.2): tear the session
            # down at the SPGW, answer (unless switch-off), release S1
            self.delete_session(ue)
            self.attached_imsis.discard(ue.imsi)
            self.by_tmsi.pop(ue.m_tmsi, None)
            self.ues.pop(ue.mme_ue_id, None)
            out = []
            if not msg.fields.get("switch_off") and ue.sec_ctx is not None:
                out.append(s1ap.pack_dl_nas(
                    ue.mme_ue_id, ue.enb_ue_id,
                    ue.sec_ctx.protect(nas.pack_detach_accept())))
            out.append(s1ap.pack_ue_context_release_command(ue.mme_ue_id, ue.enb_ue_id))
            return out
        return []

    def _ctx_setup_response(self, ies: dict) -> list[bytes]:
        ue = self.ues.get(ies["mme_ue_s1ap_id"])
        if ue is None:
            return []
        enb_teid = int.from_bytes(ies["erab_setup_list_ctxt_su_res"][0]["gtp_teid"], "big")
        self._modify_bearer(ue, enb_teid)
        return []

    def _release_request(self, ies: dict) -> list[bytes]:
        """eNB-initiated S1 release (TS 23.401 §5.3.5): access bearers
        released at the SPGW, UE goes ECM-IDLE but stays EMM-REGISTERED."""
        ue = self.ues.get(ies["mme_ue_s1ap_id"])
        if ue is None:
            return []
        self._release_access_bearers(ue)
        ue.ecm_connected = False
        return [s1ap.pack_ue_context_release_command(ue.mme_ue_id, ue.enb_ue_id)]

    def _dl_nas(self, ue: UeCtx, pdu: bytes) -> bytes:
        return s1ap.pack_dl_nas(ue.mme_ue_id, ue.enb_ue_id, pdu)
