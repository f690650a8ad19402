"""Host copy of `srsran_tpu/stack/asn1/ngap.py`, held to it by `tests/test_torch_stack.py`.

TS 38.413 NGAP message schemas (ALIGNED PER) on the per.py DSL.

Replaces the reference's generated `ngap_nr_asn1.cc` (53 kLoC — SURVEY
§2.2 / Appendix C item 3) for the NG-C procedures its 5G-NR scaffolding
uses: NG Setup, AMF Configuration Update, Initial UE Message, DL/UL NAS
Transport, UE Context Release, PDU Session Resource Setup (including
the open-type SetupRequestTransfer container).

NGAP shares S1AP's envelope shape — {procedureCode, criticality,
open-type value} around a ProtocolIE-Container — so the IE machinery
is imported from `s1ap.py`. Unlike S1AP, NGAP item lists are plain
SEQUENCE OF (no ProtocolIE-SingleContainer wrapper).

Validated against the golden vectors in the reference's
lib/test/asn1/ngap_asn1_test.cc (tests/test_asn1_ngap.py).
"""

from __future__ import annotations

from .per import (
    Asn1Error,
    Asn1Type,
    BitStr,
    CharStr,
    Choice,
    Enum,
    Int,
    M,
    O,
    OctStr,
    Seq,
    SeqOf,
    get_constrained,
    get_length,
    get_open_type,
    put_constrained,
    put_length,
    put_open_type,
)
from .s1ap import CRITICALITY, IE_EXTS, Ie, IeContainer, ie_message


class SingleIe(Asn1Type):
    """ProtocolIE-SingleContainer: one {id, criticality, open value} triplet,
    kept raw so unknown choice-Extensions round-trip bit-exactly."""

    def encode(self, w, value):
        ie_id, crit, raw = value
        put_constrained(w, ie_id, 0, 65535)
        put_constrained(w, crit, 0, 2)
        put_length(w, len(raw))
        w.put_bytes(raw)

    def decode(self, r):
        ie_id = get_constrained(r, 0, 65535)
        crit = get_constrained(r, 0, 2)
        return (ie_id, crit, r.get_bytes(get_length(r)))


def ngap_choice(alts) -> Choice:
    """NGAP choices carry `choice-Extensions ProtocolIE-SingleContainer` as a
    ROOT alternative (not a PER extension marker) — 38.413 §9.3/§9.4."""
    return Choice(list(alts) + [("choice_exts", SingleIe())])


# ---------------------------------------------------------------- IE types

PLMN_IDENTITY = OctStr(3, 3)
AMF_UE_NGAP_ID = Int(0, (1 << 40) - 1)
RAN_UE_NGAP_ID = Int(0, (1 << 32) - 1)
NAS_PDU = OctStr()
AMF_NAME = CharStr(1, 150, ext=True)
RAN_NODE_NAME = CharStr(1, 150, ext=True)
BIT_RATE = Int(0, 4_000_000_000_000, ext=True)

GNB_ID = ngap_choice([("gnb_id", BitStr(22, 32))])
GLOBAL_GNB_ID = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("gnb_id", GNB_ID), O("ie_exts", IE_EXTS)], ext=True
)
NGENB_ID = ngap_choice(
    [("macro_ngenb_id", BitStr(20)), ("short_macro_ngenb_id", BitStr(18)),
     ("long_macro_ngenb_id", BitStr(21))],
)
GLOBAL_NGENB_ID = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("ngenb_id", NGENB_ID), O("ie_exts", IE_EXTS)], ext=True
)
N3IWF_ID = ngap_choice([("n3iwf_id", BitStr(16))])
GLOBAL_N3IWF_ID = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("n3iwf_id", N3IWF_ID), O("ie_exts", IE_EXTS)], ext=True
)
GLOBAL_RAN_NODE_ID = ngap_choice(
    [("global_gnb_id", GLOBAL_GNB_ID), ("global_ngenb_id", GLOBAL_NGENB_ID),
     ("global_n3iwf_id", GLOBAL_N3IWF_ID)],
)

S_NSSAI = Seq([M("sst", OctStr(1, 1)), O("sd", OctStr(3, 3)), O("ie_exts", IE_EXTS)], ext=True)
SLICE_SUPPORT_ITEM = Seq([M("s_nssai", S_NSSAI), O("ie_exts", IE_EXTS)], ext=True)
SLICE_SUPPORT_LIST = SeqOf(SLICE_SUPPORT_ITEM, 1, 1024)
BROADCAST_PLMN_ITEM = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("tai_slice_support_list", SLICE_SUPPORT_LIST),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
SUPPORTED_TA_ITEM = Seq(
    [M("tac", OctStr(3, 3)), M("broadcast_plmn_list", SeqOf(BROADCAST_PLMN_ITEM, 1, 12)),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
SUPPORTED_TA_LIST = SeqOf(SUPPORTED_TA_ITEM, 1, 256)

PAGING_DRX = Enum(["v32", "v64", "v128", "v256"], ext=True)

GUAMI = Seq(
    [
        M("plmn_id", PLMN_IDENTITY),
        M("amf_region_id", BitStr(8)),
        M("amf_set_id", BitStr(10)),
        M("amf_pointer", BitStr(6)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
SERVED_GUAMI_ITEM = Seq(
    [M("guami", GUAMI), O("backup_amf_name", AMF_NAME), O("ie_exts", IE_EXTS)], ext=True
)
SERVED_GUAMI_LIST = SeqOf(SERVED_GUAMI_ITEM, 1, 256)
PLMN_SUPPORT_ITEM = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("slice_support_list", SLICE_SUPPORT_LIST),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
PLMN_SUPPORT_LIST = SeqOf(PLMN_SUPPORT_ITEM, 1, 12)

NR_CGI = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("nr_cell_id", BitStr(36)), O("ie_exts", IE_EXTS)], ext=True
)
EUTRA_CGI = Seq(
    [M("plmn_id", PLMN_IDENTITY), M("eutra_cell_id", BitStr(28)), O("ie_exts", IE_EXTS)], ext=True
)
TAI = Seq([M("plmn_id", PLMN_IDENTITY), M("tac", OctStr(3, 3)), O("ie_exts", IE_EXTS)], ext=True)

USER_LOCATION_INFO_EUTRA = Seq(
    [M("eutra_cgi", EUTRA_CGI), M("tai", TAI), O("time_stamp", OctStr(4, 4)),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
USER_LOCATION_INFO_NR = Seq(
    [M("nr_cgi", NR_CGI), M("tai", TAI), O("time_stamp", OctStr(4, 4)), O("ie_exts", IE_EXTS)],
    ext=True,
)
USER_LOCATION_INFO_N3IWF = Seq(
    [M("ip_address", BitStr(1, 160, ext=True)), M("port_number", OctStr(2, 2)),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
USER_LOCATION_INFO = ngap_choice(
    [("user_location_info_eutra", USER_LOCATION_INFO_EUTRA),
     ("user_location_info_nr", USER_LOCATION_INFO_NR),
     ("user_location_info_n3iwf", USER_LOCATION_INFO_N3IWF)],
)

RRC_ESTABLISHMENT_CAUSE = Enum(
    ["emergency", "high_prio_access", "mt_access", "mo_sig", "mo_data", "mo_voice_call",
     "mo_video_call", "mo_sms", "mps_prio_access", "mcs_prio_access"],
    ext=True,
    ext_names=["not_available"],
)
UE_CONTEXT_REQUEST = Enum(["requested"], ext=True)

CAUSE = ngap_choice(
    [
        (
            "radio_network",
            Enum(
                ["unspecified", "txnrelocoverall_expiry", "successful_ho",
                 "release_due_to_ngran_generated_reason",
                 "release_due_to_5gc_generated_reason", "ho_cancelled", "partial_ho",
                 "ho_fail_in_target_5gc_ngran_node_or_target_sys", "ho_target_not_allowed",
                 "tngrelocoverall_expiry", "tngrelocprep_expiry", "cell_not_available",
                 "unknown_target_id", "no_radio_res_available_in_target_cell",
                 "unknown_local_ue_ngap_id", "inconsistent_remote_ue_ngap_id",
                 "ho_desirable_for_radio_reason", "time_crit_ho", "res_optim_ho",
                 "reduce_load_in_serving_cell", "user_inactivity", "radio_conn_with_ue_lost",
                 "radio_res_not_available", "invalid_qos_combination",
                 "fail_in_radio_interface_proc", "interaction_with_other_proc",
                 "unknown_pdu_session_id", "unknown_qos_flow_id",
                 "multiple_pdu_session_id_instances", "multiple_qos_flow_id_instances",
                 "encryption_and_or_integrity_protection_algorithms_not_supported",
                 "ng_intra_sys_ho_triggered", "ng_inter_sys_ho_triggered", "xn_ho_triggered",
                 "not_supported_5qi_value", "ue_context_transfer",
                 "ims_voice_eps_fallback_or_rat_fallback_triggered",
                 "up_integrity_protection_not_possible",
                 "up_confidentiality_protection_not_possible", "slice_not_supported",
                 "ue_in_rrc_inactive_state_not_reachable", "redirection",
                 "res_not_available_for_the_slice",
                 "ue_max_integrity_protected_data_rate_reason",
                 "release_due_to_cn_detected_mob"],
                ext=True,
                ext_names=["n26_interface_not_available", "release_due_to_pre_emption"],
            ),
        ),
        ("transport", Enum(["transport_res_unavailable", "unspecified"], ext=True)),
        ("nas", Enum(["normal_release", "authentication_fail", "deregister", "unspecified"],
                     ext=True)),
        ("protocol", Enum(["transfer_syntax_error", "abstract_syntax_error_reject",
                           "abstract_syntax_error_ignore_and_notify",
                           "msg_not_compatible_with_receiver_state", "semantic_error",
                           "abstract_syntax_error_falsely_constructed_msg", "unspecified"],
                          ext=True)),
        ("misc", Enum(["ctrl_processing_overload", "not_enough_user_plane_processing_res",
                       "hardware_fail", "om_intervention", "unknown_plmn", "unspecified"],
                      ext=True)),
    ],
)

UE_NGAP_ID_PAIR = Seq(
    [M("amf_ue_ngap_id", AMF_UE_NGAP_ID), M("ran_ue_ngap_id", RAN_UE_NGAP_ID),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
UE_NGAP_IDS = ngap_choice(
    [("ue_ngap_id_pair", UE_NGAP_ID_PAIR), ("amf_ue_ngap_id", AMF_UE_NGAP_ID)]
)

# ------------------------------------------- PDU session resource setup

GTP_TUNNEL = Seq(
    [M("transport_layer_address", BitStr(1, 160, ext=True)), M("gtp_teid", OctStr(4, 4)),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
UP_TRANSPORT_LAYER_INFO = ngap_choice([("gtp_tunnel", GTP_TUNNEL)])

PDU_SESSION_TYPE = Enum(["ipv4", "ipv6", "ipv4v6", "ethernet", "unstructured"], ext=True)

ALLOC_AND_RETENTION_PRIO = Seq(
    [
        M("prio_level_arp", Int(1, 15)),
        M("pre_emption_cap", Enum(["shall_not_trigger_pre_emption", "may_trigger_pre_emption"],
                                  ext=True)),
        M("pre_emption_vulnerability", Enum(["not_pre_emptable", "pre_emptable"], ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
NON_DYNAMIC_5QI = Seq(
    [
        M("five_qi", Int(0, 255, ext=True)),
        O("prio_level_qos", Int(1, 127, ext=True)),
        O("averaging_win", Int(0, 4095, ext=True)),
        O("maximum_data_burst_volume", Int(0, 4095, ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
PACKET_ERROR_RATE = Seq(
    [M("per_scalar", Int(0, 9, ext=True)), M("per_exponent", Int(0, 9, ext=True)),
     O("ie_exts", IE_EXTS)],
    ext=True,
)
DYNAMIC_5QI = Seq(
    [
        M("prio_level_qos", Int(1, 127, ext=True)),
        M("packet_delay_budget", Int(0, 1023, ext=True)),
        M("packet_error_rate", PACKET_ERROR_RATE),
        O("five_qi", Int(0, 255, ext=True)),
        O("delay_crit", Enum(["delay_crit", "non_delay_crit"], ext=True)),
        O("averaging_win", Int(0, 4095, ext=True)),
        O("maximum_data_burst_volume", Int(0, 4095, ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
QOS_CHARACTERISTICS = ngap_choice(
    [("non_dynamic_5qi", NON_DYNAMIC_5QI), ("dynamic_5qi", DYNAMIC_5QI)]
)
GBR_QOS_INFO = Seq(
    [
        M("maximum_flow_bit_rate_dl", BIT_RATE),
        M("maximum_flow_bit_rate_ul", BIT_RATE),
        M("guaranteed_flow_bit_rate_dl", BIT_RATE),
        M("guaranteed_flow_bit_rate_ul", BIT_RATE),
        O("notif_ctrl", Enum(["notif_requested"], ext=True)),
        O("maximum_packet_loss_rate_dl", Int(0, 1000, ext=True)),
        O("maximum_packet_loss_rate_ul", Int(0, 1000, ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
QOS_FLOW_LEVEL_QOS_PARAMS = Seq(
    [
        M("qos_characteristics", QOS_CHARACTERISTICS),
        M("alloc_and_retention_prio", ALLOC_AND_RETENTION_PRIO),
        O("gbr_qos_info", GBR_QOS_INFO),
        O("reflective_qos_attribute", Enum(["subject_to"], ext=True)),
        O("add_qos_flow_info", Enum(["more_likely"], ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
QOS_FLOW_SETUP_REQUEST_ITEM = Seq(
    [
        M("qos_flow_id", Int(0, 63, ext=True)),
        M("qos_flow_level_qos_params", QOS_FLOW_LEVEL_QOS_PARAMS),
        O("erab_id", Int(0, 15, ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

PDU_SESSION_RES_SETUP_ITEM_SU_REQ = Seq(
    [
        M("pdu_session_id", Int(0, 255)),
        O("pdu_session_nas_pdu", NAS_PDU),
        M("s_nssai", S_NSSAI),
        M("pdu_session_res_setup_request_transfer", OctStr()),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

UE_AGGREGATE_MAXIMUM_BIT_RATE = Seq(
    [M("ue_aggr_max_bit_rate_dl", BIT_RATE), M("ue_aggr_max_bit_rate_ul", BIT_RATE),
     O("ie_exts", IE_EXTS)],
    ext=True,
)

# The SetupRequestTransfer is itself a ProtocolIE container carried as an
# open-type octet string inside the item above (38.413 §9.3.4.1).
PDU_SESSION_RES_SETUP_REQUEST_TRANSFER = ie_message(
    Ie(130, "pdu_session_aggr_max_bit_rate", "reject",
       Seq([M("dl", BIT_RATE), M("ul", BIT_RATE), O("ie_exts", IE_EXTS)], ext=True)),
    Ie(139, "ul_ngu_up_tnl_info", "reject", UP_TRANSPORT_LAYER_INFO),
    Ie(134, "pdu_session_type", "reject", PDU_SESSION_TYPE),
    Ie(138, "security_ind", "reject", OctStr()),
    Ie(136, "qos_flow_setup_request_list", "reject",
       SeqOf(QOS_FLOW_SETUP_REQUEST_ITEM, 1, 64)),
)

# ------------------------------------------------------------ the messages

AMF_CONFIGURATION_UPDATE = ie_message(
    Ie(1, "amf_name", "reject", AMF_NAME),
    Ie(96, "served_guami_list", "reject", SERVED_GUAMI_LIST),
    Ie(86, "relative_amf_capacity", "ignore", Int(0, 255)),
    Ie(80, "plmn_support_list", "reject", PLMN_SUPPORT_LIST),
)

NG_SETUP_REQUEST = ie_message(
    Ie(27, "global_ran_node_id", "reject", GLOBAL_RAN_NODE_ID),
    Ie(82, "ran_node_name", "ignore", RAN_NODE_NAME),
    Ie(102, "supported_ta_list", "reject", SUPPORTED_TA_LIST),
    Ie(21, "default_paging_drx", "ignore", PAGING_DRX),
)

NG_SETUP_RESPONSE = ie_message(
    Ie(1, "amf_name", "reject", AMF_NAME),
    Ie(96, "served_guami_list", "reject", SERVED_GUAMI_LIST),
    Ie(86, "relative_amf_capacity", "ignore", Int(0, 255)),
    Ie(80, "plmn_support_list", "reject", PLMN_SUPPORT_LIST),
)

NG_SETUP_FAILURE = ie_message(
    Ie(15, "cause", "ignore", CAUSE),
    Ie(107, "time_to_wait", "ignore", Enum(["v1s", "v2s", "v5s", "v10s", "v20s", "v60s"],
                                           ext=True)),
)

INITIAL_UE_MESSAGE = ie_message(
    Ie(85, "ran_ue_ngap_id", "reject", RAN_UE_NGAP_ID),
    Ie(38, "nas_pdu", "reject", NAS_PDU),
    Ie(121, "user_location_info", "reject", USER_LOCATION_INFO),
    Ie(90, "rrc_establishment_cause", "ignore", RRC_ESTABLISHMENT_CAUSE),
    Ie(26, "five_g_s_tmsi", "reject", Seq(
        [M("amf_set_id", BitStr(10)), M("amf_pointer", BitStr(6)),
         M("five_g_tmsi", OctStr(4, 4)), O("ie_exts", IE_EXTS)], ext=True)),
    Ie(112, "ue_context_request", "ignore", UE_CONTEXT_REQUEST),
)

DOWNLINK_NAS_TRANSPORT = ie_message(
    Ie(10, "amf_ue_ngap_id", "reject", AMF_UE_NGAP_ID),
    Ie(85, "ran_ue_ngap_id", "reject", RAN_UE_NGAP_ID),
    Ie(38, "nas_pdu", "reject", NAS_PDU),
)

UPLINK_NAS_TRANSPORT = ie_message(
    Ie(10, "amf_ue_ngap_id", "reject", AMF_UE_NGAP_ID),
    Ie(85, "ran_ue_ngap_id", "reject", RAN_UE_NGAP_ID),
    Ie(38, "nas_pdu", "reject", NAS_PDU),
    Ie(121, "user_location_info", "ignore", USER_LOCATION_INFO),
)

UE_CONTEXT_RELEASE_COMMAND = ie_message(
    Ie(114, "ue_ngap_ids", "reject", UE_NGAP_IDS),
    Ie(15, "cause", "ignore", CAUSE),
)

UE_CONTEXT_RELEASE_COMPLETE = ie_message(
    Ie(10, "amf_ue_ngap_id", "ignore", AMF_UE_NGAP_ID),
    Ie(85, "ran_ue_ngap_id", "ignore", RAN_UE_NGAP_ID),
    Ie(121, "user_location_info", "ignore", USER_LOCATION_INFO),
)

PDU_SESSION_RESOURCE_SETUP_REQUEST = ie_message(
    Ie(10, "amf_ue_ngap_id", "reject", AMF_UE_NGAP_ID),
    Ie(85, "ran_ue_ngap_id", "reject", RAN_UE_NGAP_ID),
    Ie(83, "ran_paging_prio", "ignore", Int(1, 256)),
    Ie(38, "nas_pdu", "reject", NAS_PDU),
    Ie(74, "pdu_session_res_setup_list_su_req", "reject",
       SeqOf(PDU_SESSION_RES_SETUP_ITEM_SU_REQ, 1, 256)),
    Ie(110, "ue_aggr_max_bit_rate", "ignore", UE_AGGREGATE_MAXIMUM_BIT_RATE),
)

# procedure code → per-class message type (38.413 §9.2)
PROCEDURES = {
    ("init_msg", 0): ("amf_cfg_upd", AMF_CONFIGURATION_UPDATE),
    ("init_msg", 4): ("dl_nas_transport", DOWNLINK_NAS_TRANSPORT),
    ("init_msg", 15): ("init_ue_msg", INITIAL_UE_MESSAGE),
    ("init_msg", 21): ("ng_setup_request", NG_SETUP_REQUEST),
    ("successful_outcome", 21): ("ng_setup_response", NG_SETUP_RESPONSE),
    ("unsuccessful_outcome", 21): ("ng_setup_failure", NG_SETUP_FAILURE),
    ("init_msg", 29): ("pdu_session_res_setup_request", PDU_SESSION_RESOURCE_SETUP_REQUEST),
    ("init_msg", 41): ("ue_context_release_cmd", UE_CONTEXT_RELEASE_COMMAND),
    ("successful_outcome", 41): ("ue_context_release_complete", UE_CONTEXT_RELEASE_COMPLETE),
    ("init_msg", 46): ("ul_nas_transport", UPLINK_NAS_TRANSPORT),
}
_BY_NAME = {name: (cls, code, typ) for (cls, code), (name, typ) in PROCEDURES.items()}
_CLASSES = ["init_msg", "successful_outcome", "unsuccessful_outcome"]

# default criticality per procedure code (38.413 §9.3.7)
_PROC_CRIT = {0: "reject", 4: "ignore", 15: "ignore", 21: "reject", 29: "reject",
              41: "reject", 46: "ignore"}


class NgapPdu(Asn1Type):
    """NGAP-PDU ::= CHOICE {initiatingMessage, successfulOutcome,
    unsuccessfulOutcome} — identical envelope to S1AP-PDU.

    Value = (message_name, protocol_ies_dict).
    """

    def encode(self, w, value):
        name, ies = value
        cls, code, typ = _BY_NAME[name]
        w.put(0, 1)  # CHOICE extension bit
        put_constrained(w, _CLASSES.index(cls), 0, 2)
        put_constrained(w, code, 0, 255)
        put_constrained(w, CRITICALITY.index(_PROC_CRIT[code]), 0, 2)
        put_open_type(w, typ, {"protocol_ies": ies})

    def decode(self, r):
        if r.get(1):
            raise Asn1Error("extended NGAP-PDU class")
        cls = _CLASSES[get_constrained(r, 0, 2)]
        code = get_constrained(r, 0, 255)
        get_constrained(r, 0, 2)  # criticality
        entry = PROCEDURES.get((cls, code))
        if entry is None:
            octets = get_length(r)
            return (f"_unknown_{cls}_{code}", r.get_bytes(octets))
        name, typ = entry
        return (name, get_open_type(r, typ)["protocol_ies"])


NGAP_PDU = NgapPdu()


def pack(name: str, ies: dict) -> bytes:
    return NGAP_PDU.to_bytes((name, ies), aligned=True)


def unpack(data: bytes):
    return NGAP_PDU.from_bytes(data, aligned=True)


def pack_transfer(ies: dict) -> bytes:
    """Pack a PDUSessionResourceSetupRequestTransfer container."""
    return PDU_SESSION_RES_SETUP_REQUEST_TRANSFER.to_bytes({"protocol_ies": ies}, aligned=True)


def unpack_transfer(data: bytes) -> dict:
    return PDU_SESSION_RES_SETUP_REQUEST_TRANSFER.from_bytes(data, aligned=True)["protocol_ies"]
