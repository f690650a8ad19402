"""Host copy of `srsran_tpu/stack/nas_ue.py`, held to it by `tests/test_torch_stack.py`.

UE NAS client + USIM (re-design of `srsue/src/stack/upper/nas.cc`
attach/auth EMM-ESM procedures and `usim.cc` Milenage).

`UeNas.handle_dl(nas_pdu)` consumes a downlink NAS message and returns the
uplink response (or None); `attach_request()` starts the flow. On attach
accept it exposes the allocated IP and the AS key material.
"""

from __future__ import annotations

import dataclasses

from . import nas, security as sec


@dataclasses.dataclass
class Usim:
    imsi: str
    key: bytes
    opc: bytes

    def authenticate(self, rand: bytes, autn: bytes) -> tuple[bytes, bytes, bytes, bytes] | None:
        """Verify AUTN, return (RES, CK, IK, SQN^AK) or None (usim.cc)."""
        res, ck, ik, ak, _ = sec.milenage_f2345(self.key, self.opc, rand)
        sqn_xor_ak = autn[0:6]
        amf = autn[6:8]
        mac_a = autn[8:16]
        sqn = bytes(a ^ b for a, b in zip(sqn_xor_ak, ak))
        exp_mac = sec.milenage_f1(self.key, self.opc, rand, sqn, amf)
        if exp_mac != mac_a:
            return None
        return res, ck, ik, sqn_xor_ak


class UeNas:
    (DEREGISTERED, ATTACHING, REGISTERED) = range(3)

    def __init__(self, usim: Usim, plmn: bytes = b"\x00\xf1\x10"):
        self.usim = usim
        self.plmn = plmn
        self.state = self.DEREGISTERED
        self.sec_ctx: nas.NasSecurityContext | None = None
        self.k_asme = b""
        self.ue_ip = ""
        self.ebi = 0
        self.m_tmsi = 0

    def attach_request(self) -> bytes:
        self.state = self.ATTACHING
        return nas.pack_attach_request(self.usim.imsi)

    def get_k_enb(self) -> bytes:
        return sec.generate_k_enb(self.k_asme, 0)

    def service_request(self) -> bytes:
        """SERVICE REQUEST for the ECM-IDLE→CONNECTED transition (short
        format, TS 24.301 §8.2.25). Requires a live security context."""
        assert self.sec_ctx is not None
        return self.sec_ctx.pack_service_request()

    def get_k_enb_service(self) -> bytes:
        """K_eNB for a service-request re-access: derived from the UL NAS
        count the SERVICE REQUEST was sent with."""
        return sec.generate_k_enb(self.k_asme, self.sec_ctx.tx_count - 1)

    def detach_request(self, switch_off: bool = False) -> bytes:
        """UE-initiated detach (TS 24.301 §5.5.2.2)."""
        pdu = nas.pack_detach_request(self.m_tmsi, switch_off)
        if switch_off:
            self.state = self.DEREGISTERED
        return self.sec_ctx.protect(pdu) if self.sec_ctx else pdu

    def handle_dl(self, pdu: bytes) -> bytes | None:
        sht = pdu[0] >> 4
        if sht != nas.SEC_HDR_PLAIN:
            if self.sec_ctx is None:
                # SMC arrives integrity-protected with the new context —
                # peek at the inner message to build the context first
                inner = pdu[6:]
                msg = nas.unpack(inner)
                if msg.msg_type == nas.SECURITY_MODE_COMMAND:
                    eea, eia = msg.fields["eea"], msg.fields["eia"]
                    k_enc, k_int = sec.generate_nas_keys(self.k_asme, eea, eia)
                    self.sec_ctx = nas.NasSecurityContext(k_enc, k_int, eea, eia, is_ue=True)
                    # verify the SMC's MAC with the fresh context
                    ctx_rx = nas.NasSecurityContext(k_enc, k_int, eea, eia, is_ue=True)
                    if ctx_rx.unprotect(pdu) is None:
                        self.sec_ctx = None
                        return None
                    self.sec_ctx.rx_count = ctx_rx.rx_count
                    return self.sec_ctx.protect(nas.pack_security_mode_complete())
                return None
            inner = self.sec_ctx.unprotect(pdu)
            if inner is None:
                return None
            pdu = inner
        msg = nas.unpack(pdu)
        if msg.msg_type == nas.AUTHENTICATION_REQUEST:
            auth = self.usim.authenticate(msg.fields["rand"], msg.fields["autn"])
            if auth is None:
                return None  # (auth failure message elided)
            res, ck, ik, sqn_xor_ak = auth
            self.k_asme = sec.generate_k_asme(ck, ik, self.plmn, sqn_xor_ak)
            return nas.pack_authentication_response(res)
        if msg.msg_type == nas.ATTACH_ACCEPT:
            esm = nas.unpack(msg.fields["esm"])
            self.ue_ip = esm.fields.get("ip", "")
            self.ebi = esm.fields.get("ebi", 5)
            self.m_tmsi = msg.fields.get("m_tmsi", 0)
            self.state = self.REGISTERED
            out = nas.pack_attach_complete(self.ebi)
            return self.sec_ctx.protect(out) if self.sec_ctx else out
        if msg.msg_type == nas.DETACH_ACCEPT:
            self.state = self.DEREGISTERED
            self.ue_ip = ""
            return None
        return None
