"""Host copy of `srsran_tpu/epc/s1ap.py`, held to it by `tests/test_torch_stack.py`.

S1AP message plane: real TS 36.413 ALIGNED-PER encodings.

Builder/parser helpers over `stack.asn1.s1ap` for the procedures the
eNB↔MME pair runs (re-design of `srsenb/src/stack/upper/s1ap.cc` /
`srsepc/src/mme/s1ap*.cc`): S1 Setup, Initial UE Message, DL/UL NAS
Transport, Initial Context Setup (E-RAB with GTP TEIDs + security key),
UE Context Release.

Transport contract: one S1AP PDU per `handle()` call — the framing SCTP
provides in the reference (mme.cc:25).
"""

from __future__ import annotations

from ..stack.asn1 import s1ap as codec

DEFAULT_PLMN = b"\x00\xf1\x10"
DEFAULT_TAC = b"\x00\x01"


def _ip_to_bits(ip: str) -> tuple[int, int]:
    """IPv4 dotted-quad → 32-bit transportLayerAddress BIT STRING value."""
    v = 0
    for part in ip.split("."):
        v = (v << 8) | int(part)
    return (v, 32)


def bits_to_ip(addr: tuple[int, int]) -> str:
    v, n = addr
    assert n == 32
    return ".".join(str((v >> s) & 0xFF) for s in (24, 16, 8, 0))


def unpack(data: bytes):
    """One S1AP PDU → (message_name, ies dict)."""
    return codec.unpack(data)


def pack_s1_setup_request(enb_id: int = 0x19B, name: str = "srsenb01",
                          plmn: bytes = DEFAULT_PLMN, tac: bytes = DEFAULT_TAC) -> bytes:
    return codec.pack("s1_setup_request", {
        "global_enb_id": {"plmn_id": plmn, "enb_id": ("macro_enb_id", enb_id)},
        "enbname": name,
        "supported_tas": [{"tac": tac, "broadcast_plmns": [plmn]}],
        "default_paging_drx": "v128",
    })


def pack_s1_setup_response(name: str = "srsmme01", plmn: bytes = DEFAULT_PLMN,
                           mme_group: bytes = b"\x00\x01", mmec: bytes = b"\x1a") -> bytes:
    return codec.pack("s1_setup_response", {
        "mmename": name,
        "served_gummeis": [{"served_plmns": [plmn], "served_group_ids": [mme_group],
                            "served_mmecs": [mmec]}],
        "relative_mme_capacity": 10,
    })


def pack_initial_ue_message(enb_ue_id: int, nas_pdu: bytes, cell_id: int = 0x19B0,
                            cause: str = "mo_data", plmn: bytes = DEFAULT_PLMN,
                            tac: bytes = DEFAULT_TAC,
                            m_tmsi: int | None = None, mmec: int = 0x1A) -> bytes:
    ies = {
        "enb_ue_s1ap_id": enb_ue_id,
        "nas_pdu": nas_pdu,
        "tai": {"plmn_id": plmn, "tac": tac},
        "eutran_cgi": {"plmn_id": plmn, "cell_id": cell_id},
        "rrc_establishment_cause": cause,
    }
    if m_tmsi is not None:
        ies["s_tmsi"] = {"mmec": bytes([mmec]), "m_tmsi": m_tmsi.to_bytes(4, "big")}
    return codec.pack("init_ue_msg", ies)


def pack_dl_nas(mme_ue_id: int, enb_ue_id: int, nas_pdu: bytes) -> bytes:
    return codec.pack("dl_nas_transport", {
        "mme_ue_s1ap_id": mme_ue_id, "enb_ue_s1ap_id": enb_ue_id, "nas_pdu": nas_pdu,
    })


def pack_ul_nas(mme_ue_id: int, enb_ue_id: int, nas_pdu: bytes, cell_id: int = 0x19B0,
                plmn: bytes = DEFAULT_PLMN, tac: bytes = DEFAULT_TAC) -> bytes:
    return codec.pack("ul_nas_transport", {
        "mme_ue_s1ap_id": mme_ue_id, "enb_ue_s1ap_id": enb_ue_id, "nas_pdu": nas_pdu,
        "eutran_cgi": {"plmn_id": plmn, "cell_id": cell_id},
        "tai": {"plmn_id": plmn, "tac": tac},
    })


def pack_initial_context_setup_request(
    mme_ue_id: int, enb_ue_id: int, nas_pdu: bytes, k_enb: bytes,
    spgw_teid: int, ebi: int = 5, spgw_addr: str = "10.0.0.1",
) -> bytes:
    return codec.pack("init_context_setup_request", {
        "mme_ue_s1ap_id": mme_ue_id,
        "enb_ue_s1ap_id": enb_ue_id,
        "ue_aggregate_maximum_bitrate": {
            "ue_aggregate_maximum_bit_rate_dl": 1_000_000_000,
            "ue_aggregate_maximum_bit_rate_ul": 1_000_000_000,
        },
        "erab_to_be_setup_list_ctxt_su_req": [{
            "erab_id": ebi,
            "erab_level_qos_params": {
                "qci": 9,
                "alloc_retention_prio": {
                    "prio_level": 15,
                    "pre_emption_cap": "shall_not_trigger_pre_emption",
                    "pre_emption_vulnerability": "not_pre_emptable",
                },
            },
            "transport_layer_address": _ip_to_bits(spgw_addr),
            "gtp_teid": spgw_teid.to_bytes(4, "big"),
            **({"nas_pdu": nas_pdu} if nas_pdu else {}),
        }],
        "ue_security_cap": {
            "encryption_algorithms": 0b1110000000000000,
            "integrity_protection_algorithms": 0b1110000000000000,
        },
        "security_key": int.from_bytes(k_enb, "big"),
    })


def pack_initial_context_setup_response(
    mme_ue_id: int, enb_ue_id: int, enb_teid: int, ebi: int = 5,
    enb_addr: str = "10.0.0.2",
) -> bytes:
    return codec.pack("init_context_setup_response", {
        "mme_ue_s1ap_id": mme_ue_id,
        "enb_ue_s1ap_id": enb_ue_id,
        "erab_setup_list_ctxt_su_res": [{
            "erab_id": ebi,
            "transport_layer_address": _ip_to_bits(enb_addr),
            "gtp_teid": enb_teid.to_bytes(4, "big"),
        }],
    })


def pack_ue_context_release_request(mme_ue_id: int, enb_ue_id: int,
                                    cause=("radio_network", "radio_conn_with_ue_lost")) -> bytes:
    return codec.pack("ue_context_release_request", {
        "mme_ue_s1ap_id": mme_ue_id, "enb_ue_s1ap_id": enb_ue_id, "cause": cause,
    })


def pack_ue_context_release_command(mme_ue_id: int, enb_ue_id: int,
                                    cause=("nas", "normal_release")) -> bytes:
    return codec.pack("ue_context_release_cmd", {
        "ue_s1ap_ids": ("ue_s1ap_id_pair", {"mme_ue_s1ap_id": mme_ue_id, "enb_ue_s1ap_id": enb_ue_id}),
        "cause": cause,
    })


def pack_ue_context_release_complete(mme_ue_id: int, enb_ue_id: int) -> bytes:
    return codec.pack("ue_context_release_complete", {
        "mme_ue_s1ap_id": mme_ue_id, "enb_ue_s1ap_id": enb_ue_id,
    })


def pack_handover_required(mme_ue_id: int, enb_ue_id: int, target_enb_id: int,
                           container: bytes, plmn: bytes = DEFAULT_PLMN) -> bytes:
    """S1AP HandoverRequired (36.413 §8.4.1; the source side of
    rrc_mobility.cc's S1 handover)."""
    return codec.pack("ho_required", {
        "mme_ue_s1ap_id": mme_ue_id,
        "enb_ue_s1ap_id": enb_ue_id,
        "handov_type": "intralte",
        "cause": ("radio_network", "ho_desirable_for_radio_reason"),
        "target_id": ("targetenb_id", {
            "global_enb_id": {"plmn_id": plmn, "enb_id": ("macro_enb_id", target_enb_id)},
            "sel_tai": {"plmn_id": plmn, "tac": b"\x00\x07"},
        }),
        "source_to_target_transparent_container": container,
    })


def pack_handover_request(mme_ue_id: int, spgw_teid: int, container: bytes,
                          next_hop: bytes, ncc: int = 1, ebi: int = 5,
                          spgw_addr: str = "10.0.0.1") -> bytes:
    """S1AP HandoverRequest toward the target eNB (36.413 §8.4.2)."""
    return codec.pack("ho_request", {
        "mme_ue_s1ap_id": mme_ue_id,
        "handov_type": "intralte",
        "cause": ("radio_network", "ho_desirable_for_radio_reason"),
        "ue_aggregate_maximum_bitrate": {
            "ue_aggregate_maximum_bit_rate_dl": 1_000_000_000,
            "ue_aggregate_maximum_bit_rate_ul": 1_000_000_000,
        },
        "erab_to_be_setup_list_ho_req": [{
            "erab_id": ebi,
            "transport_layer_address": _ip_to_bits(spgw_addr),
            "gtp_teid": spgw_teid.to_bytes(4, "big"),
            "erab_level_qos_params": {
                "qci": 9,
                "alloc_retention_prio": {
                    "prio_level": 15,
                    "pre_emption_cap": "shall_not_trigger_pre_emption",
                    "pre_emption_vulnerability": "not_pre_emptable",
                },
            },
        }],
        "source_to_target_transparent_container": container,
        "ue_security_cap": {
            "encryption_algorithms": 0b1110000000000000,
            "integrity_protection_algorithms": 0b1110000000000000,
        },
        "security_context": {"next_hop_chaining_count": ncc,
                             "next_hop_param": int.from_bytes(next_hop, "big")},
    })


def pack_handover_request_ack(mme_ue_id: int, enb_ue_id: int, enb_teid: int,
                              container: bytes, ebi: int = 5,
                              enb_addr: str = "10.0.0.3") -> bytes:
    return codec.pack("ho_request_ack", {
        "mme_ue_s1ap_id": mme_ue_id,
        "enb_ue_s1ap_id": enb_ue_id,
        "erab_admitted_list": [{
            "erab_id": ebi,
            "transport_layer_address": _ip_to_bits(enb_addr),
            "gtp_teid": enb_teid.to_bytes(4, "big"),
        }],
        "target_to_source_transparent_container": container,
    })


def pack_handover_command(mme_ue_id: int, enb_ue_id: int, container: bytes) -> bytes:
    return codec.pack("ho_cmd", {
        "mme_ue_s1ap_id": mme_ue_id,
        "enb_ue_s1ap_id": enb_ue_id,
        "handov_type": "intralte",
        "target_to_source_transparent_container": container,
    })


def pack_handover_notify(mme_ue_id: int, enb_ue_id: int, cell_id: int = 0x19C0,
                         plmn: bytes = DEFAULT_PLMN) -> bytes:
    return codec.pack("ho_notify", {
        "mme_ue_s1ap_id": mme_ue_id,
        "enb_ue_s1ap_id": enb_ue_id,
        "eutran_cgi": {"plmn_id": plmn, "cell_id": cell_id},
        "tai": {"plmn_id": plmn, "tac": b"\x00\x07"},
    })


def pack_paging(m_tmsi: int, mmec: int = 0x1A, plmn: bytes = DEFAULT_PLMN,
                tac: bytes = DEFAULT_TAC, imsi: str | None = None) -> bytes:
    """S1AP Paging (36.413 §9.1.6); UE identity index = IMSI mod 1024
    stands in by m_tmsi mod 1024 when paging by s-TMSI (srsepc pages by
    IMSI-derived index, `srsepc/src/mme/s1ap_paging.cc`)."""
    if imsi is not None:
        pid = ("imsi", bytes.fromhex(imsi + "f" * (len(imsi) % 2)))
        idx = int(imsi) % 1024
    else:
        pid = ("s_tmsi", {"mmec": bytes([mmec]), "m_tmsi": m_tmsi.to_bytes(4, "big")})
        idx = m_tmsi % 1024
    return codec.pack("paging", {
        "ue_id_idx_value": idx,
        "ue_paging_id": pid,
        "cn_domain": "ps",
        "tai_list": [{"tai": {"plmn_id": plmn, "tac": tac}}],
    })
